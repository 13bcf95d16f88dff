"""Kernel B8's design on the CPU: the folded tables it walks, the argument
cache, the one-launch entry's plain version, and the kernel's own source.

* ``build_walk_argument``: a walk in numpy that reads nothing but the
  argument, as the kernel does (each char's class offset from the ASCII
  table or the boundaries above 127, one table read a step, the accept and
  dead bits in the entry, the stop tested once a chunk of 4 or 8 chars),
  against ``regex_match_plain`` (hypothesis: patterns of the DFA parser's
  grammar, rows of ASCII and non-ASCII chars, empty and past the width,
  both layouts, both modes, with the dead state and with none named) and
  against the reference's ``regex_match_device`` (JAX on the CPU) on
  ``tests/test_regex_dfa.py``'s patterns.
* ``walk_argument``: built once a ``CompiledDfa`` and kept on it; its
  layout is the C struct's (``WALK_ARG``). ``cached_dfa``: one DFA, its
  argument built, a ``(pattern, ignore_case)`` pair, bounded, and the one
  a regex leaf takes on every field it expands over.
* ``regex_match_pair_plain`` and ``regex_match_pair`` on the CPU: the two
  walks of ``regex_match_plain`` concatenated.
* ``csrc/regex_dfa.cu`` itself, compiled by g++ against a header that
  runs a launch on the CPU, one thread a CUDA thread and a block at a
  time, with a barrier for ``__syncthreads``: its row paths (the
  transposed u16 rows, the row-major int32 rows read 4, 2 or 1 char a
  load) against ``regex_match_plain``, both matrices in one launch. What this cannot show
  (that nvcc takes the source, the card's timing) ``chip_smoke.py`` and
  ``tests/test_torch_cuda.py`` show on the card.

Tolerance: exact (bool answers, table bytes).
"""

import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import torch

import test_regex_dfa as trd
from veloci_tpu.ops import regex_dfa as ref_regex
from veloci_tpu_torch.ops import _build
from veloci_tpu_torch.ops import regex_dfa as rd
from veloci_tpu_torch.search import field_search
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

ALPHABET = ["a", "b", "c", "k", "s", "x", "z", "0", "1", "_", "-", ".", " ", "é", "K", "İ",
            "ſ", "日", "\U0001F600", "\x1c", "ÿ", "Ā"]
ATOMS = ["a", "b", "c", "k", ".", "[a-c]", "[^b]", r"\d", r"\w", r"\s", "x", "é", "[à-ÿ]",
         "[^é]", "(ab|ba)", "[0-9_]"]


def layouts(words, width=32, long_width=60):
    """``words`` lowercased as a sweep matrix (``[width, N]`` u16, code
    points past 0xFFFF as U+FFFD) and as int32 row-major codes read through
    a transposed view (``[N, long_width]``, -1 past a row's end), each with
    its lengths (the sweep's cut at ``width``)."""
    n = len(words)
    chars = np.zeros((width, n), np.uint16)
    codes = np.full((n, long_width), -1, np.int32)
    lens = np.zeros(n, np.int32)
    for i, w in enumerate(words):
        cps = [ord(c) for c in w.lower()]
        lens[i] = len(cps)
        codes[i, : min(len(cps), long_width)] = cps[:long_width]
        for j, c in enumerate(cps[:width]):
            chars[j, i] = c if c <= 0xFFFF else 0xFFFD
    lengths = torch.from_numpy(lens)
    return ((torch.from_numpy(chars), lengths.clamp(max=width).contiguous()),
            (torch.from_numpy(codes).T, lengths))


def table_walk(chars_t, lengths, arg, prefix, chunk):
    """The kernel's walk in numpy, from its argument alone."""
    w = chars_t.shape[0]
    m = chars_t.numpy() if chars_t.dtype == torch.int32 else chars_t.numpy().astype(np.int64)
    codes = m.astype(np.int64) & 0xFFFFFFFF
    codes = np.where(codes > 0xFFFF, 0xFFFD, codes)
    lens = np.minimum(lengths.numpy().astype(np.int64), w)
    states, nhigh = int(arg["states"]), int(arg["nhigh"])
    high = arg["high"][:nhigh].astype(np.int64)
    off = np.where(codes < 128, arg["ascii"][np.minimum(codes, 127)].astype(np.int64),
                   (int(arg["high_class"]) + np.searchsorted(high, codes, side="right")) * states)
    table = arg["next"].astype(np.int64)
    start = bool(arg["start_accepts"]) and prefix
    stop = (rd.ACCEPTS | rd.DEAD) if prefix else rd.DEAD
    e = np.zeros(len(lens), np.int64)
    seen = np.zeros(len(lens), np.int64)
    walking = (lens > 0) & (not start)
    for base in range(0, int(lens.max(initial=0)), chunk):
        for j in range(base, min(base + chunk, w)):
            step = walking & (j < lens)
            e = np.where(step, table[off[j] + (e & 0x3F)], e)
            seen |= np.where(step, e, 0)
        walking &= ((seen & stop) == 0) & (base + chunk < lens)
    matched = ((seen if prefix else e) & rd.ACCEPTS) != 0
    return torch.from_numpy((matched | start) & (lens > 0))


def _dfas(pattern):
    dfa = rd.compile_dfa(pattern, ignore_case=True)
    if dfa is None:
        return []
    return [dfa, rd.CompiledDfa(dfa.boundaries, dfa.trans, dfa.accept, -1)]


@st.composite
def _patterns(draw):
    parts = draw(st.lists(st.tuples(st.sampled_from(ATOMS), st.sampled_from(["", "*", "+", "?"])),
                          min_size=0, max_size=5))
    return "".join(a + q for a, q in parts)


_words = st.lists(st.lists(st.sampled_from(ALPHABET), max_size=70).map("".join), min_size=1, max_size=40)


@settings(max_examples=120, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(pattern=_patterns(), words=_words, prefix=st.booleans())
def test_table_walk_equals_plain_walk(pattern, words, prefix):
    """The folded tables walk as ``regex_match_plain`` does, in both layouts
    and at both chunk sizes, with the dead state and with none named."""
    sweep, long = layouts(words)
    for dfa in _dfas(pattern):
        arg = rd.build_walk_argument(dfa)
        for chars_t, lengths in (sweep, long):
            want = rd.regex_match_plain(chars_t, lengths, dfa, prefix)
            for chunk in (4, 8):
                assert torch.equal(table_walk(chars_t, lengths, arg, prefix, chunk), want), (pattern, chunk)


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("pattern", trd.PATTERNS)
def test_table_walk_equals_reference_device(pattern, prefix):
    """The folded tables against the reference's one-hot sweep
    (``regex_match_device``, JAX on the CPU) over the same u16 matrix."""
    rng = np.random.default_rng(41)
    words = ["".join(rng.choice(ALPHABET, size=int(k))) for k in rng.integers(0, 40, 300)]
    words[:6] = ["", "a" * 32, "abc" * 11, "café", "K", "x"]
    (chars_t, lengths), _long = layouts(words)
    dfa = rd.compile_dfa(pattern, ignore_case=True)
    assert dfa is not None
    got = table_walk(chars_t, lengths, rd.build_walk_argument(dfa), prefix, 8)
    want = np.asarray(ref_regex.regex_match_device(chars_t.numpy().T.copy(), lengths.numpy(),
                                                   ref_regex.compile_dfa(pattern, ignore_case=True),
                                                   prefix=prefix))
    assert got.numpy().tolist() == want.tolist(), pattern


def test_walk_argument_layout_and_cache():
    """The argument's bytes sit where ``WalkDfa`` reads them; it is built
    at the first walk of a ``CompiledDfa`` and kept on it."""
    fields = rd.WALK_ARG.fields
    assert rd.WALK_ARG.itemsize == 1920 + 256 + 4 * 32 + 20
    assert [fields[k][1] for k in ("next", "ascii", "high", "nhigh", "high_class", "states", "start_accepts",
                                   "used")] == [0, 1920, 2176, 2304, 2308, 2312, 2316, 2320]
    dfa = rd.compile_dfa("[a-c]x*é|k", ignore_case=True)
    assert getattr(dfa, "walk_arg", None) is None
    arg = rd.walk_argument(dfa)
    assert dfa.walk_arg is arg and rd.walk_argument(dfa) is arg
    assert arg.tobytes() == rd.build_walk_argument(dfa).tobytes()
    twin = rd.CompiledDfa(dfa.boundaries, dfa.trans, dfa.accept, dfa.dead)
    assert rd.walk_argument(twin) is not arg and twin.walk_arg.tobytes() == arg.tobytes()
    c, s = dfa.trans.shape
    assert int(arg["used"]) == c * s and int(arg["states"]) == s
    high = dfa.boundaries[(dfa.boundaries > 127) & (dfa.boundaries <= 0xFFFF)]
    assert int(arg["nhigh"]) == len(high) > 0 and (arg["high"][: len(high)] == high).all()
    assert int(rd.build_walk_argument(rd.compile_dfa(".*x", ignore_case=True))["nhigh"]) == 0  # 0x10000 only
    assert (arg["next"][c * s:] == 0).all()
    # an entry: the next state with its bits
    nxt = arg["next"][: c * s].reshape(c, s)
    assert ((nxt & 0x3F) == dfa.trans).all()
    assert (((nxt & rd.ACCEPTS) != 0) == dfa.accept[dfa.trans]).all()
    assert (((nxt & rd.DEAD) != 0) == (dfa.trans == dfa.dead)).all()


def test_cached_dfa_compiles_a_pattern_once(monkeypatch):
    """``cached_dfa`` is ``compile_dfa`` with the kernel argument built,
    one DFA a ``(pattern, ignore_case)`` pair, at most ``DFA_CACHE_SIZE``
    kept; a regex leaf's ``regex_dfa`` takes it on every field, so a
    pattern compiles once for all of them and for the requests after."""
    compiled, real = [], rd.compile_dfa

    def counting(pattern, ignore_case=False):
        compiled.append((pattern, ignore_case))
        return real(pattern, ignore_case=ignore_case)

    monkeypatch.setattr(rd, "compile_dfa", counting)
    rd.cached_dfa.cache_clear()
    try:
        assert rd.cached_dfa.cache_info().maxsize == rd.DFA_CACHE_SIZE
        dfa = rd.cached_dfa(".*ab.*", True)
        assert rd.cached_dfa(".*ab.*", True) is dfa and compiled == [(".*ab.*", True)]
        assert dfa.walk_arg.tobytes() == rd.build_walk_argument(real(".*ab.*", ignore_case=True)).tobytes()
        assert rd.cached_dfa(".*ab.*", False) is not dfa and len(compiled) == 2
        assert rd.cached_dfa("a{2}", True) is None and rd.cached_dfa("a{2}", True) is None and len(compiled) == 3
        leaves = [SimpleNamespace(terms=[".*Xy.*"], ignore_case=None, starts_with=False, path=f)
                  for f in ("title", "ent_seq", "cat", "pop")]
        got = {id(field_search.regex_dfa(leaf)[1]) for leaf in leaves * 2}
        assert len(got) == 1 and compiled[3:] == [(".*Xy.*", True)]
        for n in range(rd.DFA_CACHE_SIZE + 1):
            rd.cached_dfa(f"p{n}", True)
        assert rd.cached_dfa.cache_info().currsize == rd.DFA_CACHE_SIZE
    finally:
        rd.cached_dfa.cache_clear()


@pytest.mark.parametrize("prefix", [False, True])
def test_pair_entry_on_the_cpu(prefix):
    """``regex_match_pair`` on CPU tensors is its plain version, the two
    walks concatenated; either matrix may be empty; mixed devices and
    malformed matrices raise."""
    rng = np.random.default_rng(43)
    words = ["".join(rng.choice(ALPHABET, size=int(k))) for k in rng.integers(0, 70, 500)]
    sweep, long = layouts(words)
    empty = (torch.zeros((32, 0), dtype=torch.uint16), torch.zeros(0, dtype=torch.int32))
    for pattern in ("a.*", ".*k.*", "[^a]*b", "x", r"\w+"):
        dfa = rd.compile_dfa(pattern, ignore_case=True)
        want = torch.cat([rd.regex_match_plain(*sweep, dfa, prefix), rd.regex_match_plain(*long, dfa, prefix)])
        assert torch.equal(rd.regex_match_pair_plain(*sweep, *long, dfa, prefix), want)
        assert torch.equal(rd.regex_match_pair(*sweep, *long, dfa, prefix), want)
        assert torch.equal(rd.regex_match_pair(*empty, *long, dfa, prefix), want[len(words):])
        assert torch.equal(rd.regex_match_pair(*sweep, *empty, dfa, prefix), want[: len(words)])
    assert rd.regex_match_pair(*empty, *empty, dfa, prefix).shape == (0,)
    with pytest.raises(ValueError):
        rd.regex_match_pair(*sweep, long[0], long[1][:-1], dfa, prefix)
    with pytest.raises(ValueError):
        rd.regex_match_pair(sweep[0].to(torch.int64), sweep[1], *long, dfa, prefix)


# ---------------------------------------------------------------- the kernel's source on the CPU

_CPU_LAUNCH = r"""
#pragma once
// A CUDA launch on the CPU: one std::thread a CUDA thread, a block at a
// time; a barrier stands in for __syncthreads.
#include <barrier>
#include <cstdint>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__ static
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
inline int2 make_int2(int x, int y) { return {x, y}; }
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline dim3_ blockIdx, blockDim;
inline thread_local dim3_ threadIdx;
inline std::barrier<>* block_barrier = nullptr;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
template <typename T> inline T __ldg(const T* p) { return *p; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
template <typename F> void cpu_launch(unsigned blocks, unsigned threads, F body) {
  blockDim.x = threads;
  for (unsigned b = 0; b < blocks; ++b) {
    blockIdx.x = b;
    std::barrier<> bar(threads);
    block_barrier = &bar;
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; body(); });
    for (auto& t : ts) t.join();
  }
}
"""
_KERNEL_LAUNCH = "dfa_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(launch, arg, prefix);"


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """``csrc/regex_dfa.cu``'s ``veloci_regex_walk``, built by g++ with
    its launch run by ``_CPU_LAUNCH``."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the kernel's source for the CPU")
    src = (_build.CSRC / rd.SOURCE).read_text()
    assert src.count(_KERNEL_LAUNCH) == 1 and src.count("#include <cuda_runtime.h>") == 1
    src = src.replace("#include <cuda_runtime.h>", '#include "cpu_launch.h"').replace(
        _KERNEL_LAUNCH, "(void)stream; cpu_launch(blocks, kThreads, [&] { dfa_walk_kernel(launch, arg, prefix); });")
    d = tmp_path_factory.mktemp("regex_walk_cpu")
    (d / "cpu_launch.h").write_text(_CPU_LAUNCH)
    (d / "regex_dfa.cpp").write_text(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w", "-o", str(d / "walk.so"),
                    str(d / "regex_dfa.cpp")], check=True, capture_output=True, timeout=240)
    fn = ctypes.CDLL(str(d / "walk.so")).veloci_regex_walk
    fn.restype, fn.argtypes = ctypes.c_int, rd.SIGNATURE["veloci_regex_walk"]

    def walk(a, b, dfa, prefix):
        out = torch.full((a[1].shape[0] + b[1].shape[0],), 7, dtype=torch.uint8)
        arg = rd.walk_argument(dfa)
        err = fn(*rd._rows(*a), *rd._rows(*b), arg.ctypes.data, int(prefix), out.data_ptr(), None)
        assert err == 0 and bool((out <= 1).all())
        return out.bool()
    return walk


# the last two have boundaries in (127, 0xFFFF]: the kernel's search path
KERNEL_PATTERNS = ["a*b", ".*k.*", "[^a-c]+", r"\w+", "", "(ab|ba)*c", ".*é.*", "[à-ä]x*|[è-ë]|[ì-ï]+"]


@pytest.mark.parametrize("prefix", [False, True])
def test_kernel_source_walks_as_the_plain_walk(cpu_kernel, prefix):
    """The kernel's row paths in one launch (u16 sweep rows, then int32
    row-major rows read 4 chars a load, some past 8 and 16 chars and past
    the width), and the int32 rows alone at widths read 4, 2 and 1 char a
    load, on every pattern, with the dead state and with none named, equal
    the plain walk."""
    rng = np.random.default_rng(47)
    words = ["".join(rng.choice(ALPHABET, size=int(k))) for k in rng.integers(0, 70, 200)]
    words[:8] = ["", "a" * 32, "a" * 33, "k" * 59, "k" * 61, "café", "K", "abc"]
    sweep, long = layouts(words)
    empty = (torch.zeros((32, 0), dtype=torch.uint16), torch.zeros(0, dtype=torch.int32))
    walked = 0
    for pattern in KERNEL_PATTERNS:
        for dfa in _dfas(pattern):
            want = rd.regex_match_pair_plain(*sweep, *long, dfa, prefix)
            assert torch.equal(cpu_kernel(sweep, long, dfa, prefix), want), pattern
            walked += 1
    assert walked == 2 * len(KERNEL_PATTERNS)
    dfa = rd.compile_dfa(KERNEL_PATTERNS[-1], ignore_case=True)
    assert int(rd.build_walk_argument(dfa)["nhigh"]) > 4
    for width in (60, 62, 61):  # 4, 2 and 1 char a load
        _sweep, rows = layouts(words, long_width=width)
        for d in (dfa, rd.compile_dfa(".*k.*", ignore_case=True)):
            assert torch.equal(cpu_kernel(rows, empty, d, prefix), rd.regex_match_plain(*rows, d, prefix)), width
