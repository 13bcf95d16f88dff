"""The full-width kernel's bit-parallel algorithm (Myers, in Hyyro's
edit-distance form), run in torch on the CPU as
``levenshtein_sweep_full_batch_bitparallel``, against the plain DP that
defines the sweep (``levenshtein_sweep_full_batch_plain``), on all three
outputs. The CUDA kernel runs the same algorithm; ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it to the plain DP on the card.

Cases: code points at or above 256 (the kernel's match table covers those
below), characters that collide in their low 8 bits (``a`` / ``š``,
U+0061 / U+0161), queries of 0, 1, 31, 32 and 33 chars, terms of 0 and 32
chars. Tolerance: exact equality (integer outputs)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from veloci_tpu_torch.ops.levenshtein import encode_query
from veloci_tpu_torch.ops.levenshtein_sweep import (
    levenshtein_sweep_full_batch_bitparallel,
    levenshtein_sweep_full_batch_plain,
)
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

# 'š' and 'a', 'ā' (U+0101) and '\x01' share their low 8 bits
ALPHABET = ["a", "b", "c", "š", "ā", "\x01", "日", "\U0001F600"]


def _sweep_inputs(terms, queries):
    chars = np.zeros((32, len(terms)), np.uint16)
    lens = np.zeros(len(terms), np.int32)
    for i, t in enumerate(terms):
        chars[:, i], lens[i] = encode_query(t)
    enc = [encode_query(w)[0] for w in queries]
    qlens = torch.tensor([len(w) for w in queries], dtype=torch.int32)  # raw, may pass 32
    return (torch.from_numpy(chars), torch.from_numpy(lens),
            torch.from_numpy(np.stack(enc)), qlens)


def _assert_equal(terms, queries):
    args = _sweep_inputs(terms, queries)
    got = levenshtein_sweep_full_batch_bitparallel(*args)
    want = levenshtein_sweep_full_batch_plain(*args)
    for name, g, w in zip(("dist", "prefix_dist", "is_prefix"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, terms, queries)


words = st.lists(st.sampled_from(ALPHABET), max_size=32).map("".join)
queries = st.lists(st.sampled_from(ALPHABET), max_size=35).map("".join)


@settings(max_examples=150, deadline=None)
@given(terms=st.lists(words, min_size=1, max_size=24), qs=st.lists(queries, min_size=1, max_size=8))
def test_bitparallel_equals_dp(terms, qs):
    _assert_equal(terms, qs)


EDGES = {
    "empty_query": [""],
    "one_char": ["a", "š"],
    "collide_low_bits": ["šaš", "aša", "āa\x01"],
    "q31": ["ab" * 15 + "a"],
    "q32": ["ab" * 16, "š" * 32],
    "q33": ["ab" * 16 + "a", "a" * 33],
    "above_bmp": ["\U0001F600a", "日日"],
}
TERMS = ["", "a", "š", "ab" * 16, "a" * 32, "š" * 32, "ab" * 15 + "a", "aša", "日a", "\U0001F600a",
         "b" * 7, "ā\x01a"]


@pytest.mark.parametrize("case", list(EDGES))
def test_bitparallel_edge_cases(case):
    _assert_equal(TERMS, EDGES[case])


def test_edge_case_values():
    """The documented edge values, read off the twin."""
    dist, prefix_dist, is_prefix = levenshtein_sweep_full_batch_bitparallel(
        *_sweep_inputs(["", "abc", "ab" * 16], ["", "ab", "ab" * 16 + "a"])
    )
    assert dist[:, 0].tolist() == [1 << 20] * 3 and not is_prefix[:, 0].any()  # empty row
    assert dist[0, 1:].tolist() == [3, 32] and prefix_dist[0, 1:].tolist() == [0, 0]  # empty query
    assert is_prefix[1].tolist() == [False, True, True]
    assert not is_prefix[2].any()  # a 33-char query is no term's prefix
    assert dist[2, 2].item() == 0  # swept on its first 32 chars
