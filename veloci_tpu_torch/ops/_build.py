"""Build the port's CUDA sources with ``nvcc`` at first use; load them with ctypes.

Each ``csrc/<name>.cu`` compiles to a shared library with a plain C
interface under ``build/`` at the repository root, named by a hash of the
source text and flags, so an edited source never loads a stale binary.
``nvcc -Xptxas -v`` prints each kernel's registers, shared memory and
spills; that report is kept beside the library as ``<lib>.ptxas.txt``.
:func:`load` declares each entry point's argument types once, when the
library is first loaded in the process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "build_all", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict = {}  # source name -> loaded ctypes.CDLL (one per process)
# held by load() from its check to its store, so that threads reaching a
# kernel first build and load its library once
_LOAD_LOCK = threading.Lock()
NVCC_TIMEOUT_S = 600.0  # one nvcc run; a build that takes longer fails
LOAD_WAIT_S = 2 * NVCC_TIMEOUT_S  # a thread waits this long for another's build
# every source's C entry points return a cudaError_t as int; each source
# also exports veloci_cuda_error_string(int) -> const char*


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    return BUILD_DIR / f"{Path(source).stem}-{hashlib.sha256(text).hexdigest()[:16]}.so"


def build_all(sources=None) -> dict:
    """Compile every source that has no library yet, one ``nvcc`` per source,
    all started together. Returns ``{source: library path}``; raises with
    the compiler's output if any build fails, and if one runs past
    ``NVCC_TIMEOUT_S`` (all are then stopped)."""
    sources = sorted(p.name for p in CSRC.glob("*.cu")) if sources is None else sources
    procs = {}
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        procs[source] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for source, (out, tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for _out, _tmp, other in procs.values():
                other.kill()
            raise RuntimeError(f"nvcc ran past {NVCC_TIMEOUT_S:g} s building {source}") from None
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        Path(f"{out}.ptxas.txt").write_text(log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {source: library_path(source) for source in sources}


def load(source: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built first if needed. On
    the first load, each ``{symbol: argtypes}`` of ``signatures`` is
    declared to return an int (a ``cudaError_t``). Safe under threads: the
    first caller builds and loads, the others wait for it, at most
    ``LOAD_WAIT_S``, and get the same library."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    if not _LOAD_LOCK.acquire(timeout=LOAD_WAIT_S):
        raise RuntimeError(f"waited {LOAD_WAIT_S:g} s for another thread's build of {source}")
    try:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([source])[source]))
            for symbol, argtypes in signatures.items():
                fn = getattr(lib, symbol)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            lib.veloci_cuda_error_string.restype = ctypes.c_char_p
            lib.veloci_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[source] = lib
    finally:
        _LOAD_LOCK.release()
    return lib
