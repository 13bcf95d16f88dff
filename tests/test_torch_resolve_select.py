"""The redesigned call paths of kernels B7 and B2, on the CPU.

B7 (``ops/postings.py``): the host predicate that lets the dense resolve
take its direct path (``dense_max_row_score`` per index,
``dense_fast_path`` per leaf) on its edge cases -- -0.0, negative, NaN and
inf scores, products just under, at and just over the f32 overflow -- and
the leaf's arguments, which now travel as one buffer, against the
reference's ``resolve_to_anchor_dense`` (``_resolve_kernel`` on JAX-CPU).

B2 (``ops/levenshtein_sweep.py``): ``levenshtein_select_banded`` (on CPU
tensors, its plain twin) against the sweep path it replaced for one banded
item (the single-query sweep, then ``select_matches``), against
``_select`` of a batch that holds the item, and against the reference's
Pallas single-query kernel (interpret mode) with its ``select_matches``,
for every distance up to the band at bands 2 and 4.

Tolerance: exact equality (integer outputs; f32 planes bit for bit).
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from veloci_tpu.ops.levenshtein import select_matches as ref_select_matches
from veloci_tpu.ops.pallas_levenshtein import levenshtein_sweep_pallas_banded
from veloci_tpu_torch import Persistence, TorchIndex, create_indices_from_str
from veloci_tpu_torch.ops.levenshtein import encode_query, select_matches
from veloci_tpu_torch.ops.levenshtein_sweep import (
    levenshtein_select_banded,
    levenshtein_select_banded_plain,
    levenshtein_sweep_banded,
)
from veloci_tpu_torch.ops.postings import (
    dense_fast_path,
    dense_max_row_score,
    dense_resolve,
    dense_resolve_args,
    dense_resolve_plain,
    resolve_to_anchor_dense,
)
from veloci_tpu_torch.persistence import FieldSweep
from veloci_tpu_torch.search import field_search
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

ref_postings = importlib.import_module("veloci_tpu.ops.postings")

F32 = np.float32
FLT_MAX = float(np.finfo(np.float32).max)


def _f32(bits):
    return np.array([bits], dtype=np.uint32).view(np.float32)[0]


# ---------------------------------------------------------------- B7: the direct path's predicate
ROW_SCORES = {
    "ordinary": ([0.5, 3.25, 600.0], F32(600.0)),
    "zero rows": ([0.0, 0.0], F32(0.0)),
    "no rows": ([], F32(0.0)),
    "subnormal": ([_f32(1), 2.0], F32(2.0)),
    "largest finite": ([FLT_MAX, 1.0], F32(FLT_MAX)),
    "negative zero": ([1.0, -0.0], None),
    "negative": ([1.0, -2.0], None),
    "nan": ([1.0, np.nan], None),
    "inf": ([1.0, np.inf], None),
}


@pytest.mark.parametrize("case", sorted(ROW_SCORES))
def test_max_row_score_edge_cases(case):
    scores, want = ROW_SCORES[case]
    got = dense_max_row_score(np.array(scores, dtype=np.float32))
    if want is None:
        assert got is None
    else:
        assert np.float32(got).view(np.uint32) == np.float32(want).view(np.uint32)


TERM_SCORES = {
    "ordinary": ([2.0, 1.6666666, 0.9], True),
    "positive zero": ([0.0, 1.0], True),
    "empty leaf": ([], True),
    "subnormal": ([_f32(1)], True),
    "negative zero": ([1.0, -0.0], False),
    "negative": ([1.0, -0.5], False),
    "nan": ([np.nan], False),
    "inf": ([1.0, np.inf], False),
    "negative inf": ([-np.inf], False),
}


@pytest.mark.parametrize("case", sorted(TERM_SCORES))
def test_fast_path_term_score_edge_cases(case):
    scores, want = TERM_SCORES[case]
    assert dense_fast_path(F32(600.0), np.array(scores, dtype=np.float32)) is want
    assert dense_fast_path(None, np.array(scores, dtype=np.float32)) is False


# (max row score, max term score): the f32 product just under FLT_MAX, at
# it, at the halfway point to 2^128 (a tie that rounds to even, which is
# inf), and just over
_MID_A, _MID_B = 18631.0 * 2.0**60, 1801.0 * 2.0**43  # product 2^128 - 2^103 exactly
PRODUCTS = {
    "well under": (1e19, 1e19),
    "under": (2.0**127, float(np.nextafter(F32(2.0), F32(0.0)))),
    "largest finite": (FLT_MAX, 1.0),
    "halfway to 2^128": (_MID_A, _MID_B),
    "one ulp under halfway": (float(np.nextafter(F32(_MID_A), F32(0.0))), _MID_B),
    "over": (2.0**127, 2.0),
    "largest squared": (FLT_MAX, FLT_MAX),
}


@pytest.mark.parametrize("case", sorted(PRODUCTS))
def test_fast_path_product_overflow(case):
    """The predicate's product test agrees with f32 multiplication."""
    row, term = (F32(x) for x in PRODUCTS[case])
    with np.errstate(over="ignore"):
        finite = bool(np.isfinite(row * term))
    assert dense_fast_path(row, np.array([0.5, term], dtype=np.float32)) is finite
    if case == "halfway to 2^128":
        assert float(row) * float(term) == 2.0**128 - 2.0**103 and not finite


def _csr(rng, num_keys, num_docs, max_run):
    counts = rng.integers(0, max_run + 1, num_keys)
    counts[rng.random(num_keys) < 0.2] = 0
    anchors = [np.sort(rng.choice(num_docs, size=c, replace=False)) for c in counts]
    offsets = np.zeros(num_keys + 2, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:-1])
    offsets[-1] = offsets[-2]
    scores01 = rng.integers(0, 60000, int(counts.sum())).astype(np.float32) / np.float32(100.0)
    packed = np.stack([np.concatenate(anchors).astype(np.int32), scores01.view(np.int32)], axis=1)
    return offsets, packed, scores01


@pytest.mark.parametrize("seed", range(3))
def test_leaf_arguments_and_resolve_equal_reference(seed):
    """The leaf's one-buffer arguments hold the term ids, scores and run
    starts; the resolve from them is bit-equal to the reference's, with no
    launch on the CPU and the direct path never asked for there."""
    rng = np.random.default_rng(100 + seed)
    num_keys, num_docs, base = 400, 2000, 30
    offsets, packed, scores01 = _csr(rng, num_keys, num_docs, 150)
    num_score_keys = num_keys - base - 20
    tids = rng.integers(0, num_score_keys + 15, int(rng.integers(1, 60)))
    tscores = (rng.integers(1, 400, len(tids)) / np.float32(37.0)).astype(np.float32)
    index = SimpleNamespace(
        key_base={"f": (base, num_score_keys)}, host_offsets=offsets, num_docs=num_docs,
        offsets=torch.from_numpy(offsets), packed=torch.from_numpy(packed), device=torch.device("cpu"),
        max_row_score=dense_max_row_score(scores01),
    )
    assert index.max_row_score is not None
    args = dense_resolve_args(index, "f", tids, tscores)
    assert len(args) == 8 and args[7] is False
    keep = tids < num_score_keys
    gtids = tids[keep] + base
    starts = np.concatenate([[0], np.cumsum(offsets[gtids + 1] - offsets[gtids])])
    np.testing.assert_array_equal(args[2].numpy(), gtids)
    np.testing.assert_array_equal(args[3].numpy().view(np.int32), tscores[keep].view(np.int32))
    np.testing.assert_array_equal(args[4].numpy(), starts)
    assert args[5] == starts[-1] and args[6] == num_docs

    dev_field = SimpleNamespace(
        offsets=jnp.asarray(offsets[base:].astype(np.int32) - int(offsets[base])),
        host_offsets=offsets[base:] - offsets[base], num_score_keys=num_score_keys,
        packed=jnp.asarray(packed[offsets[base]:]), anchors=None, scores01=None,
    )
    want = np.asarray(ref_postings.resolve_to_anchor_dense(dev_field, tids, tscores, num_docs))
    launches = dense_resolve.launches
    got = resolve_to_anchor_dense(index, "f", tids, tscores).numpy()
    assert dense_resolve.launches == launches
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(dense_resolve_plain(*args).numpy().view(np.int32), want.view(np.int32))
    assert (got > 0).sum() > 0


@pytest.mark.parametrize("leaf", ["no term kept", "every run empty"])
def test_leaf_arguments_of_empty_leaves(leaf):
    offsets = np.array([0, 0, 0, 3, 3], dtype=np.int64)
    packed = np.array([[1, 0], [2, 0], [3, 0]], dtype=np.int32)
    index = SimpleNamespace(key_base={"f": (0, 3)}, host_offsets=offsets, num_docs=5,
                            offsets=torch.from_numpy(offsets), packed=torch.from_numpy(packed),
                            device=torch.device("cpu"), max_row_score=F32(0.0))
    tids = np.array([7, 9]) if leaf == "no term kept" else np.array([0, 1])
    args = dense_resolve_args(index, "f", tids, np.ones(2, np.float32))
    assert args[5] == 0 and args[4].shape[0] == args[2].shape[0] + 1
    assert resolve_to_anchor_dense(index, "f", tids, np.ones(2, np.float32)).tolist() == [0.0] * 5


def test_index_keeps_its_max_row_score():
    docs = "\n".join('{"title": "%s"}' % t for t in ("a b c", "a a b", "c d", "a"))
    index = TorchIndex.from_persistence(Persistence.from_built(create_indices_from_str(docs, "{}")), "cpu")
    scores = index.packed[:, 1].contiguous().view(torch.float32).numpy()
    assert len(scores) and index.max_row_score == scores.max() and (scores >= 0).all()


# ---------------------------------------------------------------- B2: the fused lone-request select
N_PAD = 4096


def _sweep(words, n, rng):
    """A sweep matrix of ``words`` (rows sorted by length, as at upload) in
    ``n`` rows, the rest pad rows (length 0, term id -1), and a row ->
    term id map that is a permutation."""
    words = sorted(words, key=len)
    chars = np.zeros((32, n), np.uint16)
    lens = np.zeros(n, np.int32)
    for i, w in enumerate(words):
        chars[: len(w), i] = [ord(c) for c in w]
        lens[i] = len(w)
    ids = np.full(n, -1, np.int32)
    ids[: len(words)] = rng.permutation(len(words)) + 5
    pad = np.argsort(lens == 0, kind="stable")  # pad rows last, the rest by length
    return FieldSweep(torch.from_numpy(np.ascontiguousarray(chars[:, pad])), torch.from_numpy(lens[pad]),
                      torch.from_numpy(ids[pad]))


@pytest.fixture(scope="module")
def sweeps():
    rng = np.random.default_rng(21)
    words = ([f"w{i:03d}" for i in range(300)] + ["a", "b", "ab", "hello", "help", "hells", "x" * 31,
                                                  "x" * 30 + "y", "x" * 32, "y" * 29]
             + ["".join(rng.choice(list("helowx"), size=int(k))) for k in rng.integers(1, 33, 400)])
    # every real row within distance 1 of "ab" (pad rows behind them)
    near = ["ab", "a", "b", "abc", "xab", "ac", "bb", "aab", "abb", "cb"]
    return {"main": _sweep(words, N_PAD, rng), "all match": _sweep(near * 6, 1024, rng)}


# (sweep, query): lengths 1 and 31, an ordinary one, one with no match at
# any distance, and one every real row matches at distance >= 1
SELECT_CASES = [("main", "a"), ("main", "x" * 31), ("main", "helo"), ("main", "w0015"),
                ("main", "日本語" * 5), ("all match", "ab")]


def _sweep_then_select(sweep, query, qlen, band, distance):
    """The sweep path for one banded item: the single-query sweep, then
    select_matches, read back."""
    dist, _pd, is_prefix = levenshtein_sweep_banded(
        sweep.chars_t, sweep.lengths, torch.from_numpy(query), torch.tensor([qlen], dtype=torch.int32), band)
    _rows, ids, d, p = select_matches(dist[None], is_prefix[None], dist[None],
                                      torch.tensor([distance], dtype=torch.int32), remap=sweep.sweep_ids)
    return ids.numpy(), d.numpy(), p.numpy()


@pytest.mark.parametrize("band", [2, 4])
@pytest.mark.parametrize("case", range(len(SELECT_CASES)))
def test_fused_select_equals_sweep_path_and_reference(sweeps, case, band):
    name, word = SELECT_CASES[case]
    sweep = sweeps[name]
    query, qlen = encode_query(word)
    ref = levenshtein_sweep_pallas_banded(
        jnp.asarray(sweep.chars_t.numpy()), jnp.asarray(sweep.lengths.numpy()), jnp.asarray(query),
        jnp.int32(qlen), interpret=True, band=band,
    )
    n = sweep.chars_t.shape[1]
    found = []
    for distance in range(band + 1):
        got = levenshtein_select_banded(sweep.chars_t, sweep.lengths, sweep.sweep_ids, query, qlen, band,
                                        distance)
        assert [g.dtype for g in got] == [np.dtype(np.int64), np.dtype(np.int32), np.dtype(bool)]
        for want in (_sweep_then_select(sweep, query, qlen, band, distance),
                     levenshtein_select_banded_plain(sweep.chars_t, sweep.lengths, sweep.sweep_ids, query,
                                                     qlen, band, distance)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        r_ids, r_d, r_p, total = (np.asarray(x) for x in ref_select_matches(
            ref[0], ref[2], ref[0], jnp.int32(distance), max_matches=n,
            remap=jnp.asarray(sweep.sweep_ids.numpy())))
        assert len(got[0]) == int(total)
        keep = r_ids >= 0
        for g, w in zip(got, (r_ids[keep], r_d[keep], r_p[keep])):
            np.testing.assert_array_equal(g, w)
        assert (got[0] >= 0).all()
        found.append(len(got[0]))
    if word.startswith("日"):
        assert found[-1] == 0  # no match at any distance
    if name == "all match":
        assert found[1] == int((sweep.lengths > 0).sum()) < n  # every real row, no pad row
    if word == "helo":
        assert 0 < found[1] < found[band]


@pytest.mark.parametrize("distance", [1, 2])
def test_select_of_a_lone_item_equals_its_batch(sweeps, distance):
    """``_select`` of one banded item (the fused select) gives the item's
    matches of a batch that also holds other items (one batched sweep)."""
    sweep = sweeps["main"]
    items = [("hlelo", distance, False), ("w001", 1, False), ("x" * 31, 2, False)]
    batch = field_search._select(sweep, items)
    for k, item in enumerate(items):
        (alone,) = field_search._select(sweep, [item])
        for g, w in zip(alone, batch[k]):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_select_checks_its_arguments(sweeps):
    sweep = sweeps["main"]
    query, qlen = encode_query("help")
    for band, distance in ((3, 1), (2, 3), (4, -1)):
        with pytest.raises(ValueError):
            levenshtein_select_banded(sweep.chars_t, sweep.lengths, sweep.sweep_ids, query, qlen, band,
                                      distance)
    with pytest.raises(ValueError):
        levenshtein_select_banded(sweep.chars_t, sweep.lengths, sweep.sweep_ids.long(), query, qlen, 2, 1)
    with pytest.raises(ValueError):
        levenshtein_select_banded(sweep.chars_t, sweep.lengths, sweep.sweep_ids, query[:5], qlen, 2, 1)
