"""ctypes bindings for the native host core (``native/indexer.cpp`` and
``native/baseline.cpp``): the port's copy of ``veloci_tpu/native.py``.

Both sources build with g++ into one library, as the reference builds them
(``baseline.cpp`` calls ``indexer.cpp``'s LZ codec), on first use, into
``build/native/`` at the repository root (gitignored; ``VELOCI_NATIVE_CACHE``
names another directory). The module exposes :func:`index_ndjson`, which
parses, flattens, tokenizes and counts an ndjson corpus in C++ and returns
numpy arrays per field path, the pack helpers and the LZ block codec the
index build and the document store use, and :func:`doc_store_body`, the
document store's write path in one pass. The pure-Python pipeline in
:mod:`veloci_tpu_torch.create` is the fallback where g++ is missing or
``VELOCI_TPU_NO_NATIVE`` is set.

The single-core CPU baselines (:func:`baseline_exact_topk`,
:func:`baseline_exact_topk_vint`, :func:`baseline_fuzzy_topk` and the
functions that make their indexes) answer single-leaf queries over the host arrays of a field
the way the engine the system was modelled on does (a posting scan, sort,
dedup keeping the max, top-n sort; the fuzzy one walks the sorted
dictionary): they are the CPU stand-in a benchmark compares the card with,
and no search path calls them. :func:`sort_u64`, :func:`sort_kv_u64_u32`
and :func:`lexsort_kv_u64_u32` are the reference's API counterparts; no
code of the port calls them either.

Settings, read as the reference reads them: ``VELOCI_TPU_NO_NATIVE``
(any value: no library), ``VELOCI_INGEST_THREADS`` (the native indexer's
threads; 1 the single-threaded walker, 0 or unset one a core),
``VELOCI_MALLOC_TUNE=0`` (no ``mallopt`` at import) and
``VELOCI_NATIVE_CACHE``.

The library is keyed by a hash of the sources, the flags and the host CPU's
feature flags: it is built with ``-march=native``, so a build directory
copied to another machine is rebuilt there, not loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

__all__ = [
    "native_available",
    "index_ndjson",
    "NativePath",
    "NativeIdPath",
    "lz_available",
    "lz_compress",
    "lz_decompress",
    "sort_u64",
    "sort_kv_u64_u32",
    "lexsort_kv_u64_u32",
    "doc_store_body",
    "baseline_available",
    "baseline_exact_topk",
    "VintBaselineIndex",
    "baseline_encode_vint",
    "baseline_exact_topk_vint",
    "FuzzyBaselineIndex",
    "baseline_fuzzy_index",
    "baseline_fuzzy_topk",
]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_ROOT = Path(__file__).resolve().parent.parent
_SOURCES = (_ROOT / "native" / "indexer.cpp", _ROOT / "native" / "baseline.cpp")
_CACHE = _ROOT / "build" / "native"  # VELOCI_NATIVE_CACHE overrides it
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def _tune_malloc() -> None:
    """Keep large allocations on the (warm) sbrk heap instead of fresh mmaps.

    Index builds churn through multi-MB scratch buffers (radix-sort temps,
    numpy copies). glibc serves allocations over 128 KB from fresh mmap
    pages, and on virtualized hosts first-touch faults dominate the sort
    work, and a serving batch's host arrays (millions of gathered rows)
    would do the same on every batch. Raising M_MMAP_THRESHOLD and
    M_TRIM_THRESHOLD keeps freed blocks pooled for reuse, trading retained
    RSS for not re-faulting the same pages. Done once, when this module is
    first imported (by the index build, the document store or the
    persistence layer), whether or not the native library builds.
    ``VELOCI_MALLOC_TUNE=0`` opts out."""
    if os.environ.get("VELOCI_MALLOC_TUNE", "1") == "0":
        return
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):  # tuning is best-effort
        pass


_tune_malloc()


def _host_cpu() -> bytes:
    """The CPU feature flags the ``-march=native`` build depends on."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def _so_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(_CXX_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(_host_cpu())
    cache = Path(os.environ.get("VELOCI_NATIVE_CACHE", _CACHE))
    return cache / f"libveloci_native-{h.hexdigest()[:16]}.so"


_CONFIG_CB = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.POINTER(ctypes.c_char),  # path (NOT c_char_p: keep the raw pointer)
    ctypes.c_int32,  # path_len
    ctypes.POINTER(ctypes.c_uint8),  # tokenize out
    ctypes.POINTER(ctypes.c_int32),  # do_not_store_longer_than out
    ctypes.POINTER(ctypes.c_char),  # separators buf (writable)
    ctypes.POINTER(ctypes.c_int32),  # separators len in/out
)


_BUILD_TIMEOUT_S = 600  # a g++ run that takes longer fails, as a failed build does


def _build_lib(so_path: Path) -> bool:
    try:
        so_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.tmp")
        subprocess.run(
            ["g++", *_CXX_FLAGS, "-o", str(tmp), *map(str, _SOURCES)],
            check=True,
            capture_output=True,
            timeout=_BUILD_TIMEOUT_S,
        )
        os.replace(tmp, so_path)  # atomic: parallel builders race safely
        return True
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("VELOCI_TPU_NO_NATIVE") or not all(src.exists() for src in _SOURCES):
        return None
    so_path = _so_path()
    if not so_path.exists() and not _build_lib(so_path):
        return None
    try:
        lib = ctypes.CDLL(str(so_path))
    except OSError:
        return None
    lib.vl_index_ndjson_mt.restype = ctypes.c_void_p
    lib.vl_index_ndjson_mt.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        _CONFIG_CB,
        ctypes.c_int32,
    ]
    lib.vl_error.restype = ctypes.c_char_p
    lib.vl_error.argtypes = [ctypes.c_void_p]
    lib.vl_num_docs.restype = ctypes.c_int64
    lib.vl_num_docs.argtypes = [ctypes.c_void_p]
    lib.vl_num_paths.restype = ctypes.c_int32
    lib.vl_num_paths.argtypes = [ctypes.c_void_p]
    for name in ("vl_path_name", "vl_terms_blob", "vl_id_path_name"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_char_p)]
    for name in (
        "vl_num_terms",
        "vl_num_leaves",
        "vl_num_tokens",
        "vl_large_text_count",
        "vl_num_id_pairs",
        "vl_num_groups",
        "vl_num_phrase_pairs",
        "vl_pack_scores",
        "vl_score_num_keys",
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    for name, ptr_t in [
        ("vl_term_occurrences", ctypes.c_uint32),
        ("vl_leaf_anchor", ctypes.c_uint32),
        ("vl_leaf_parent", ctypes.c_uint32),
        ("vl_leaf_text_id", ctypes.c_int64),
        ("vl_leaf_ntokens", ctypes.c_uint32),
        ("vl_leaf_tok_offsets", ctypes.c_int64),
        ("vl_tokens", ctypes.c_uint32),
        ("vl_token_is_sep", ctypes.c_uint8),
        ("vl_grp_token", ctypes.c_uint32),
        ("vl_grp_pos", ctypes.c_uint32),
        ("vl_grp_leaf", ctypes.c_uint32),
        ("vl_pair_a", ctypes.c_uint32),
        ("vl_pair_b", ctypes.c_uint32),
        ("vl_pair_anchor", ctypes.c_uint32),
        ("vl_id_value", ctypes.c_uint32),
        ("vl_id_parent", ctypes.c_uint32),
        ("vl_id_anchor", ctypes.c_uint32),
        ("vl_score_offsets", ctypes.c_uint64),
        ("vl_score_anchors", ctypes.c_uint32),
        ("vl_score_values", ctypes.c_uint16),
    ]:
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ptr_t)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vl_num_id_paths.restype = ctypes.c_int32
    lib.vl_num_id_paths.argtypes = [ctypes.c_void_p]
    lib.vl_free.restype = None
    lib.vl_free.argtypes = [ctypes.c_void_p]
    lib.vl_lz_compress.restype = ctypes.c_int64
    lib.vl_lz_compress.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.vl_lz_bound.restype = ctypes.c_int64
    lib.vl_lz_bound.argtypes = [ctypes.c_int64]
    lib.vl_lz_decompress.restype = ctypes.c_int64
    lib.vl_lz_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    p64 = ctypes.POINTER(ctypes.c_uint64)
    p32 = ctypes.POINTER(ctypes.c_uint32)
    lib.vl_pack_csr.restype = ctypes.c_int64
    lib.vl_pack_csr.argtypes = [p64, p32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, p64]
    lib.vl_pack_phrase.restype = ctypes.c_int64
    lib.vl_pack_phrase.argtypes = [p64, p32, ctypes.c_int64, p64, ctypes.POINTER(ctypes.c_int64)]
    lib.vl_radix_sort_u64.restype = None
    lib.vl_radix_sort_u64.argtypes = [p64, ctypes.c_int64]
    for name in ("vl_radix_sort_u64_kv32", "vl_lexsort_u64_u32"):
        getattr(lib, name).restype = None
        getattr(lib, name).argtypes = [p64, p32, ctypes.c_int64]
    i64p = ctypes.POINTER(ctypes.c_int64)
    u16p, f32p, i32p = ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    i32 = ctypes.c_int32
    lib.vbl_doc_store_body.restype = ctypes.c_int64
    lib.vbl_doc_store_body.argtypes = [ctypes.c_char_p, ctypes.c_int64, i32, ctypes.POINTER(ctypes.c_uint8),
                                       ctypes.c_int64, p64, ctypes.c_int64, i64p, i64p, i64p]
    lib.vbl_exact_topk.restype = None
    lib.vbl_exact_topk.argtypes = [i64p, p32, u16p, i32p, f32p, i32p, i32, i32, i32, i32, p32, f32p, i32p]
    lib.vbl_encode_vint.restype = ctypes.c_int64
    lib.vbl_encode_vint.argtypes = [i64p, p32, u16p, i32, ctypes.POINTER(ctypes.c_uint8), i64p]
    lib.vbl_exact_topk_vint.restype = None
    lib.vbl_exact_topk_vint.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64p, i32p, f32p, i32, i32, i32, i32,
                                        p32, f32p, i32p]
    lib.vbl_fuzzy_topk.restype = None
    lib.vbl_fuzzy_topk.argtypes = [u16p, i32p, i32p, i32, i32, u16p, i32p, i32p, i64p, p32, u16p, i32, i32, i32,
                                   p32, f32p, i32p, i32p]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


@dataclass
class NativePath:
    name: str
    terms: List[str]
    occurrences: np.ndarray  # uint32 [num_terms]
    large_text_count: int
    leaf_anchor: np.ndarray  # uint32 [L]
    leaf_parent: np.ndarray  # uint32 [L]
    leaf_text_id: np.ndarray  # int64 [L]
    leaf_ntokens: np.ndarray  # uint32 [L]
    leaf_tok_offsets: np.ndarray  # int64 [L+1]
    tokens: np.ndarray  # uint32 [T]
    token_is_sep: np.ndarray  # uint8 [T]
    grp_token: np.ndarray  # uint32 [G] — per-(leaf, token) groups
    grp_pos: np.ndarray  # uint32 [G] — first position within the leaf
    grp_leaf: np.ndarray  # uint32 [G]
    pair_a: np.ndarray  # uint32 [P] — phrase pairs
    pair_b: np.ndarray  # uint32 [P]
    pair_anchor: np.ndarray  # uint32 [P]
    # natively packed .to_anchor_id_score (offsets u64, anchors u32,
    # scores u16) when the caller requested it — None otherwise
    packed_scores: Optional[tuple] = None


@dataclass
class NativeIdPath:
    name: str
    value_id: np.ndarray
    parent_id: np.ndarray
    anchor_id: np.ndarray


def _copy_array(ptr, count, dtype):
    if count == 0:
        return np.empty(0, dtype=dtype)
    return np.ctypeslib.as_array(ptr, shape=(count,)).astype(dtype, copy=True)


def index_ndjson(data: str, get_path_config, score_paths=None) -> tuple:
    """Run the native pipeline. ``get_path_config(path) -> (tokenize,
    do_not_store_longer_than, separators_str)``.

    ``score_paths(name, n_entries) -> bool`` (optional): when it returns
    True for a path, the hot `.to_anchor_id_score` index is packed IN C++
    (entry generation + f32 scoring + sort + dedup/bonus + CSR) and
    attached as ``NativePath.packed_scores``.

    Returns (num_docs, [NativePath], [NativeIdPath]).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")

    def cb(path, path_len, tokenize_out, max_len_out, sep_buf, sep_len):
        p = ctypes.string_at(path, path_len).decode("utf-8")
        tokenize, max_len, separators = get_path_config(p)
        tokenize_out[0] = 1 if tokenize else 0
        max_len_out[0] = int(max_len)
        enc = separators.encode("utf-8")
        cap = sep_len[0]
        enc = enc[:cap]
        ctypes.memmove(sep_buf, enc, len(enc))
        sep_len[0] = len(enc)
        return 0

    cb_ref = _CONFIG_CB(cb)
    raw = data.encode("utf-8")
    # chunked multi-threaded parse (the C call releases the GIL; the config
    # callback re-acquires it briefly per new path). VELOCI_INGEST_THREADS=1
    # takes the single-threaded walker; 0 or unset, one thread a core.
    nthreads = int(os.environ.get("VELOCI_INGEST_THREADS", "0"))
    handle = lib.vl_index_ndjson_mt(raw, len(raw), cb_ref, nthreads)
    try:
        err = lib.vl_error(handle)
        if err:
            raise ValueError(err.decode("utf-8"))
        num_docs = lib.vl_num_docs(handle)
        paths: List[NativePath] = []
        for p in range(lib.vl_num_paths(handle)):
            out = ctypes.c_char_p()
            nlen = lib.vl_path_name(handle, p, ctypes.byref(out))
            name = ctypes.string_at(out, nlen).decode("utf-8")
            blen = lib.vl_terms_blob(handle, p, ctypes.byref(out))
            blob = ctypes.string_at(out, blen)
            nt = lib.vl_num_terms(handle, p)
            # terms stay a lazy blob-backed sequence: the first dictionary
            # access (a query) decodes them
            terms = _LazyTerms(blob, int(nt))
            nl = lib.vl_num_leaves(handle, p)
            ntk = lib.vl_num_tokens(handle, p)
            ng = lib.vl_num_groups(handle, p)
            npp = lib.vl_num_phrase_pairs(handle, p)
            packed = None
            if score_paths is not None and score_paths(name, int(nl + ng)):
                nnz = lib.vl_pack_scores(handle, p)
                nk = lib.vl_score_num_keys(handle, p)
                packed = (
                    _copy_array(lib.vl_score_offsets(handle, p), nk + 1, np.uint64),
                    _copy_array(lib.vl_score_anchors(handle, p), nnz, np.uint32),
                    _copy_array(lib.vl_score_values(handle, p), nnz, np.uint16),
                )
            paths.append(
                NativePath(
                    name=name,
                    terms=terms,
                    occurrences=_copy_array(lib.vl_term_occurrences(handle, p), nt, np.uint32),
                    large_text_count=lib.vl_large_text_count(handle, p),
                    leaf_anchor=_copy_array(lib.vl_leaf_anchor(handle, p), nl, np.uint32),
                    leaf_parent=_copy_array(lib.vl_leaf_parent(handle, p), nl, np.uint32),
                    leaf_text_id=_copy_array(lib.vl_leaf_text_id(handle, p), nl, np.int64),
                    leaf_ntokens=_copy_array(lib.vl_leaf_ntokens(handle, p), nl, np.uint32),
                    leaf_tok_offsets=_copy_array(
                        lib.vl_leaf_tok_offsets(handle, p), nl + 1, np.int64
                    ),
                    tokens=_copy_array(lib.vl_tokens(handle, p), ntk, np.uint32),
                    token_is_sep=_copy_array(lib.vl_token_is_sep(handle, p), ntk, np.uint8),
                    grp_token=_copy_array(lib.vl_grp_token(handle, p), ng, np.uint32),
                    grp_pos=_copy_array(lib.vl_grp_pos(handle, p), ng, np.uint32),
                    grp_leaf=_copy_array(lib.vl_grp_leaf(handle, p), ng, np.uint32),
                    pair_a=_copy_array(lib.vl_pair_a(handle, p), npp, np.uint32),
                    pair_b=_copy_array(lib.vl_pair_b(handle, p), npp, np.uint32),
                    pair_anchor=_copy_array(lib.vl_pair_anchor(handle, p), npp, np.uint32),
                    packed_scores=packed,
                )
            )
        id_paths: List[NativeIdPath] = []
        for p in range(lib.vl_num_id_paths(handle)):
            out = ctypes.c_char_p()
            nlen = lib.vl_id_path_name(handle, p, ctypes.byref(out))
            name = ctypes.string_at(out, nlen).decode("utf-8")
            npairs = lib.vl_num_id_pairs(handle, p)
            id_paths.append(
                NativeIdPath(
                    name=name,
                    value_id=_copy_array(lib.vl_id_value(handle, p), npairs, np.uint32),
                    parent_id=_copy_array(lib.vl_id_parent(handle, p), npairs, np.uint32),
                    anchor_id=_copy_array(lib.vl_id_anchor(handle, p), npairs, np.uint32),
                )
            )
        return num_docs, paths, id_paths
    finally:
        lib.vl_free(handle)


# ------------------------------------------------------------------ LZ codec
def lz_available() -> bool:
    return _load() is not None


def lz_compress(data: bytes) -> Optional[bytes]:
    """Compress with the native LZ4-style block codec; None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    cap = int(lib.vl_lz_bound(len(data)))
    dst = ctypes.create_string_buffer(cap)
    n = lib.vl_lz_compress(data, len(data), dst, cap)
    if n <= 0:
        return None
    return dst.raw[:n]


def lz_decompress(data: bytes, raw_size: int) -> bytes:
    """Decompress one block of the native codec to its ``raw_size`` bytes
    (``veloci_tpu/native.py:434-441``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native LZ codec unavailable for decompression")
    dst = ctypes.create_string_buffer(max(raw_size, 1))
    n = lib.vl_lz_decompress(data, len(data), dst, raw_size)
    if n != raw_size:
        raise ValueError(f"corrupt LZ block (got {n}, want {raw_size})")
    return dst.raw[:raw_size]


# ------------------------------------------------------------- CSR packing
def _u64_u32_pair(keys, vals) -> bool:
    return (
        keys.dtype == np.uint64
        and vals.dtype == np.uint32
        and keys.flags.c_contiguous
        and vals.flags.c_contiguous
        and len(keys) == len(vals)
    )


def pack_csr(keys, vals, num_keys: int, sort_and_dedup: bool):
    """Whole-CSR pack in C++: sort (+ optional exact-pair dedup) + offsets.

    ``keys`` (u64, contiguous, scratch — clobbered) and ``vals`` (u32,
    contiguous, clobbered) of equal length; returns ``(offsets u64
    [num_keys+1], values u32 [m])`` (``values`` is a trimmed view of
    ``vals``) or None if the native lib is unavailable. sort_and_dedup
    requires keys < 2^31 (combined-u64 sort) — caller checks.
    """
    lib = _load()
    if lib is None or not _u64_u32_pair(keys, vals):
        return None
    offsets = np.empty(num_keys + 1, dtype=np.uint64)
    m = lib.vl_pack_csr(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
        num_keys,
        1 if sort_and_dedup else 0,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if m < 0:
        raise ValueError("pack_csr: key out of range")
    return offsets, vals[:m]


def pack_phrase(keys, vals):
    """Whole phrase-index pack in C++: lexicographic sort, pair dedup,
    unique-key compaction + offsets. ``keys`` u64 / ``vals`` u32 clobbered
    in place; returns ``(uniq_keys, offsets, values)`` or None."""
    lib = _load()
    if lib is None or not _u64_u32_pair(keys, vals):
        return None
    offsets = np.empty(len(keys) + 1, dtype=np.uint64)
    nk = ctypes.c_int64(0)
    m = lib.vl_pack_phrase(
        keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(keys),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(nk),
    )
    nk = nk.value
    return keys[:nk].copy(), offsets[: nk + 1].copy(), vals[:m].copy()


class _LazyTerms:
    """Blob-backed term sequence: defers the utf-8 decode + NUL split of the
    native term blob until first access (queries force it; builds never do).

    NB: decode by term COUNT, not blob truthiness — a single empty term
    ("" is a valid text value) yields an empty blob."""

    __slots__ = ("_blob", "_n", "_list")

    def __init__(self, blob: bytes, n: int):
        self._blob, self._n, self._list = blob, n, None

    def __len__(self) -> int:
        return self._n

    def _force(self):
        if self._list is None:
            self._list = (
                self._blob.decode("utf-8").split("\x00") if self._n else []
            )
            if len(self._list) != self._n:
                raise ValueError(f"term blob holds {len(self._list)} terms, expected {self._n}")
            self._blob = b""
        return self._list

    def __getitem__(self, i):
        return self._force()[i]

    def __iter__(self):
        return iter(self._force())


# ---------------------------------------------------------------- radix sort
def _kv_ok(keys, vals) -> bool:
    return (keys.dtype == np.uint64 and vals.dtype == np.uint32 and keys.flags.c_contiguous
            and vals.flags.c_contiguous and len(keys) == len(vals))


def sort_u64(arr) -> bool:
    """In-place stable LSD radix sort of a contiguous uint64 array; False
    (nothing done) without the native library or for another array."""
    lib = _load()
    if lib is None or not (arr.dtype == np.uint64 and arr.flags.c_contiguous):
        return False
    lib.vl_radix_sort_u64(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(arr))
    return True


def sort_kv_u64_u32(keys, vals) -> bool:
    """In-place stable sort of (keys u64, payload u32) by key; False as
    :func:`sort_u64`."""
    lib = _load()
    if lib is None or not _kv_ok(keys, vals):
        return False
    lib.vl_radix_sort_u64_kv32(keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                               vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(keys))
    return True


def lexsort_kv_u64_u32(keys, vals) -> bool:
    """In-place lexicographic (key, val) sort, ``np.lexsort((vals, keys))``
    applied to both arrays; False as :func:`sort_u64`."""
    lib = _load()
    if lib is None or not _kv_ok(keys, vals):
        return False
    lib.vl_lexsort_u64_u32(keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                           vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(keys))
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def doc_store_body(data: bytes, flush_threshold: int):
    """The document store's body from ndjson in one native pass
    (``vbl_doc_store_body``, ``native/baseline.cpp``): ``(body bytes,
    index rows uint64 [B, 3], num_docs, bytes_indexed)``, or None without
    the native library."""
    lib = _load()
    if lib is None:
        return None
    n = len(data)
    nlines = data.count(b"\n") + 1
    out_cap = n + n // 64 + 16 * nlines + (1 << 16)
    max_blocks = nlines + 2
    out = np.zeros(out_cap, dtype=np.uint8)
    idx = np.zeros(max_blocks * 3, dtype=np.uint64)
    n_blocks, num_docs, bytes_indexed = ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int64(0)
    size = lib.vbl_doc_store_body(
        data, n, flush_threshold, _ptr(out, ctypes.c_uint8), out_cap, _ptr(idx, ctypes.c_uint64), max_blocks,
        ctypes.byref(n_blocks), ctypes.byref(num_docs), ctypes.byref(bytes_indexed),
    )
    if size < 0:
        return None
    return out[:size].tobytes(), idx[: n_blocks.value * 3].reshape(-1, 3), int(num_docs.value), int(
        bytes_indexed.value)


# ------------------------------------------------------ CPU baseline engine
def _csr_args(offsets, anchors, scores) -> tuple:
    """A field's anchor-score CSR as the baselines take it: offsets int64,
    anchors uint32, scores uint16 (the index score x 100), contiguous."""
    return (np.ascontiguousarray(offsets, dtype=np.int64), np.ascontiguousarray(anchors, dtype=np.uint32),
            np.ascontiguousarray(scores, dtype=np.uint16))


def _outputs(nq: int, top_n: int) -> tuple:
    return (np.zeros((nq, top_n), dtype=np.uint32), np.zeros((nq, top_n), dtype=np.float32),
            np.zeros(nq, dtype=np.int32))


def baseline_available() -> bool:
    """Whether the native library, and with it the CPU baselines, loads."""
    return _load() is not None


def baseline_exact_topk(offsets, anchors, scores, term_ids, term_scores, term_slots, top_n: int):
    """Exact single-leaf queries on one CPU core over a field's raw
    anchor-score CSR (``vbl_exact_topk``): per query, each term id of its
    row (``term_ids`` int32 [nq, t], -1 pads) scans its postings with the
    score ``term_scores * score / 100``, hits keep the max per (slot of
    ``term_slots``, anchor), and over two slots or more an anchor's slot
    scores add up, times the square of the number of its slots that scored
    at least 1e-5 (a union); the top ``top_n`` come by score, then id,
    descending. Returns ``(ids uint32 [nq, top_n], scores float32 [nq,
    top_n], num_hits int32 [nq])``, zero past the hits, or None without the
    native library."""
    lib = _load()
    if lib is None:
        return None
    offsets, anchors, scores = _csr_args(offsets, anchors, scores)
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    term_scores = np.ascontiguousarray(term_scores, dtype=np.float32)
    term_slots = np.ascontiguousarray(term_slots, dtype=np.int32)
    nq, t_per_q = term_ids.shape
    out_ids, out_scores, out_hits = _outputs(nq, top_n)
    lib.vbl_exact_topk(
        _ptr(offsets, ctypes.c_int64), _ptr(anchors, ctypes.c_uint32), _ptr(scores, ctypes.c_uint16),
        _ptr(term_ids, ctypes.c_int32), _ptr(term_scores, ctypes.c_float), _ptr(term_slots, ctypes.c_int32),
        nq, t_per_q, len(offsets) - 1, top_n,
        _ptr(out_ids, ctypes.c_uint32), _ptr(out_scores, ctypes.c_float), _ptr(out_hits, ctypes.c_int32),
    )
    return out_ids, out_scores, out_hits


class VintBaselineIndex:
    """A field's anchor-score CSR in delta + varint storage, one blob a term
    (``varint(count)``, then ``varint(anchor delta), varint(score)`` a
    posting), for :func:`baseline_exact_topk_vint`."""

    def __init__(self, blob, blob_offsets, num_keys):
        self.blob = blob  # uint8 [size]
        self.blob_offsets = blob_offsets  # int64 [num_keys + 1]
        self.num_keys = num_keys


def baseline_encode_vint(offsets, anchors, scores) -> Optional[VintBaselineIndex]:
    """Encode a raw anchor-score CSR for :func:`baseline_exact_topk_vint`
    (``vbl_encode_vint``: once to size the blob, once to fill it); None
    without the native library."""
    lib = _load()
    if lib is None:
        return None
    offsets, anchors, scores = _csr_args(offsets, anchors, scores)
    num_keys = len(offsets) - 1
    csr = (_ptr(offsets, ctypes.c_int64), _ptr(anchors, ctypes.c_uint32), _ptr(scores, ctypes.c_uint16), num_keys)
    size = lib.vbl_encode_vint(*csr, None, None)
    blob = np.zeros(max(int(size), 1), dtype=np.uint8)
    blob_offsets = np.zeros(num_keys + 1, dtype=np.int64)
    lib.vbl_encode_vint(*csr, _ptr(blob, ctypes.c_uint8), _ptr(blob_offsets, ctypes.c_int64))
    return VintBaselineIndex(blob, blob_offsets, num_keys)


def baseline_exact_topk_vint(index: VintBaselineIndex, term_ids, term_scores, top_n: int):
    """:func:`baseline_exact_topk` over the varint storage, every posting
    decoded a query (``vbl_exact_topk_vint``); its terms share one slot (hits
    keep the max per anchor). Same returns; None without the native
    library."""
    lib = _load()
    if lib is None:
        return None
    term_ids = np.ascontiguousarray(term_ids, dtype=np.int32)
    term_scores = np.ascontiguousarray(term_scores, dtype=np.float32)
    nq, t_per_q = term_ids.shape
    out_ids, out_scores, out_hits = _outputs(nq, top_n)
    lib.vbl_exact_topk_vint(
        _ptr(index.blob, ctypes.c_uint8), _ptr(index.blob_offsets, ctypes.c_int64),
        _ptr(term_ids, ctypes.c_int32), _ptr(term_scores, ctypes.c_float), nq, t_per_q, index.num_keys, top_n,
        _ptr(out_ids, ctypes.c_uint32), _ptr(out_scores, ctypes.c_float), _ptr(out_hits, ctypes.c_int32),
    )
    return out_ids, out_scores, out_hits


class FuzzyBaselineIndex:
    """A dictionary's lowercased char matrix with its rows in lexicographic
    order (shorter terms first), for :func:`baseline_fuzzy_topk`."""

    def __init__(self, chars, lens, row_tid):
        self.chars = chars  # uint16 [m, L], lex-sorted rows
        self.lens = lens  # int32 [m]
        self.row_tid = row_tid  # int32 [m] -> dictionary term id


def baseline_fuzzy_index(dictionary) -> Optional[FuzzyBaselineIndex]:
    """The sorted matrix of a ``TermDictionary``'s compact char matrix
    (:meth:`.indices.TermDictionary.char_matrix_compact`); None without the
    native library."""
    if _load() is None:
        return None
    chars, lens, ids = dictionary.char_matrix_compact()
    # rows are zero-padded, so raw row order is lexicographic order with
    # shorter terms first, the order vbl_fuzzy_topk's prefix skip needs
    order = np.lexsort(tuple(chars[:, j] for j in range(chars.shape[1] - 1, -1, -1)))
    return FuzzyBaselineIndex(
        np.ascontiguousarray(chars[order], dtype=np.uint16),
        np.ascontiguousarray(lens[order], dtype=np.int32),
        np.ascontiguousarray(ids[order], dtype=np.int32),
    )


def baseline_fuzzy_topk(index: FuzzyBaselineIndex, queries, qlens, dists, offsets, anchors, scores, top_n: int):
    """Fuzzy single-leaf queries on one CPU core (``vbl_fuzzy_topk``): each
    query (``queries`` uint16 [nq, 32], lowercased as
    ``ops.levenshtein.encode_query`` writes them, ``qlens``, ``dists``)
    walks the sorted dictionary with a Levenshtein row a prefix, skipping
    every term under a prefix that is past its distance, then resolves its
    matches with the score of their distance as :func:`baseline_exact_topk`
    does one slot. Returns ``(ids, scores, num_hits, num_matches int32
    [nq])``, or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    m, width = index.chars.shape
    queries = np.ascontiguousarray(queries, dtype=np.uint16)
    qlens = np.ascontiguousarray(qlens, dtype=np.int32)
    dists = np.ascontiguousarray(dists, dtype=np.int32)
    offsets, anchors, scores = _csr_args(offsets, anchors, scores)
    nq = queries.shape[0]
    out_ids, out_scores, out_hits = _outputs(nq, top_n)
    out_matches = np.zeros(nq, dtype=np.int32)
    lib.vbl_fuzzy_topk(
        _ptr(index.chars, ctypes.c_uint16), _ptr(index.lens, ctypes.c_int32), _ptr(index.row_tid, ctypes.c_int32),
        m, width, _ptr(queries, ctypes.c_uint16), _ptr(qlens, ctypes.c_int32), _ptr(dists, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int64), _ptr(anchors, ctypes.c_uint32), _ptr(scores, ctypes.c_uint16),
        len(offsets) - 1, nq, top_n,
        _ptr(out_ids, ctypes.c_uint32), _ptr(out_scores, ctypes.c_float), _ptr(out_hits, ctypes.c_int32),
        _ptr(out_matches, ctypes.c_int32),
    )
    return out_ids, out_scores, out_hits, out_matches
