"""The port's exact top-k and single-term run read against the JAX package's
``topk_dense_exact`` / ``topk_positions`` and ``batched_single_term_topk``
(``_single_term_impl``), on tie batteries; the port reads a single term's
run as its singles route does, ``gather_runs`` then ``segmented_topk``. Tolerance: exact equality of ids,
order, hit counts and f32 score bits (the same f32 products on both sides)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from veloci_tpu.ops.search_step import batched_single_term_topk as ref_single_term
from veloci_tpu.ops.topk import topk_dense_exact
from veloci_tpu_torch.ops.search_step import gather_runs
from veloci_tpu_torch.ops.topk import rank_key, segmented_topk
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture


def _dense(pattern, n, rng):
    if pattern == "all_equal":
        return np.full(n, 3.25, dtype=np.float32)
    if pattern == "two_levels":
        return np.where(rng.random(n) < 0.5, 1.0, 2.0).astype(np.float32)
    if pattern == "block_straddle":
        dense = rng.random(n).astype(np.float32) * 0.5
        dense[::128] = 0.75
        return dense
    if pattern == "quantized":
        return (rng.integers(0, 5, size=n) * 2.5).astype(np.float32)
    if pattern == "neg_inf_padding":
        dense = rng.random(n).astype(np.float32)
        dense[n // 3 :] = -np.inf
        return dense
    if pattern == "sparse":
        dense = np.zeros(n, dtype=np.float32)
        dense[rng.choice(n, size=5, replace=False)] = 1.5
        return dense
    return rng.random(n).astype(np.float32)


def _port_topk(dense, k):
    n = len(dense)
    seg, ids, scores = segmented_topk(
        torch.zeros(n, dtype=torch.int64), torch.from_numpy(dense),
        torch.arange(n), 1, torch.tensor([k]),
    )
    return ids.numpy(), scores.numpy()


@pytest.mark.parametrize(
    "pattern",
    ["all_equal", "two_levels", "block_straddle", "quantized", "neg_inf_padding",
     "sparse", "random"],
)
@pytest.mark.parametrize("n,k", [(10_000, 12), (300, 74), (5, 10)])
def test_topk_tie_battery(pattern, n, k):
    """(score desc, id desc) on ties, k > n, and -inf padding; the reference
    pads with -inf at id 0 where the port returns fewer rows."""
    dense = _dense(pattern, n, np.random.default_rng(n + k))
    r_ids, r_scores = (np.asarray(x) for x in topk_dense_exact(jnp.asarray(dense), min(k, n)))
    ids, scores = _port_topk(dense, k)
    finite = np.isfinite(r_scores)
    assert len(ids) == min(k, n)
    np.testing.assert_array_equal(ids[: finite.sum()], r_ids[finite])
    np.testing.assert_array_equal(scores[: finite.sum()].view(np.int32), r_scores[finite].view(np.int32))
    assert np.all(np.isneginf(scores[finite.sum():]))


def test_segments_rank_independently():
    rng = np.random.default_rng(5)
    segs = [(rng.integers(0, 4, size=n) * 1.5).astype(np.float32) for n in (0, 50, 7, 200)]
    ks = [3, 10, 20, 0]
    seg = torch.cat([torch.full((len(d),), i, dtype=torch.int64) for i, d in enumerate(segs)])
    ids = torch.cat([torch.arange(len(d)) for d in segs])
    out_seg, out_ids, out_scores = segmented_topk(
        seg, torch.from_numpy(np.concatenate(segs)), ids, len(segs), torch.tensor(ks)
    )
    for i, (d, k) in enumerate(zip(segs, ks)):
        mine = out_seg.numpy() == i
        want = np.lexsort((-np.arange(len(d)), -d.astype(np.float64)))[:k]
        np.testing.assert_array_equal(out_ids.numpy()[mine], want)
        np.testing.assert_array_equal(out_scores.numpy()[mine], d[want])


def test_rank_key_orders_signed_scores():
    scores = torch.tensor([-np.inf, -2.0, -0.5, 0.0, 1e-30, 0.5, 2.0, np.inf], dtype=torch.float32)
    keys = rank_key(scores, torch.zeros(8, dtype=torch.int64))
    assert torch.equal(torch.argsort(keys), torch.arange(7, -1, -1))
    same = rank_key(torch.full((3,), 1.5), torch.tensor([4, 9, 0]))
    assert torch.argsort(same).tolist() == [1, 0, 2]  # id desc


@pytest.fixture(scope="module")
def postings():
    """A CSR of runs with sorted unique anchors, quantized scores (ties
    across ids), one empty run; the reference gets tail padding."""
    rng = np.random.default_rng(7)
    nkeys, num_docs = 40, 2000
    counts = rng.integers(1, 300, size=nkeys)
    counts[5] = 0
    offsets = np.zeros(nkeys + 2, dtype=np.int64)
    np.cumsum(counts, out=offsets[1 : nkeys + 1])
    offsets[nkeys + 1] = offsets[nkeys]
    nnz = int(counts.sum())
    anchors = np.empty(nnz, dtype=np.int32)
    for t in range(nkeys):
        s, e = offsets[t], offsets[t + 1]
        anchors[s:e] = np.sort(rng.choice(num_docs, size=e - s, replace=False))
    scores01 = (rng.integers(0, 6, size=nnz) * 0.25).astype(np.float32)
    return offsets, anchors, scores01


@pytest.mark.parametrize("k", [1, 10, 512])
def test_single_term_run_equals_reference(postings, k):
    offsets, anchors, scores01 = postings
    terms = np.array([0, 3, 5, 17, 39], dtype=np.int64)
    tscore = np.array([10.0, 2.5, 10.0, 0.1, 7.3], dtype=np.float32)
    cap = 512
    pad = np.concatenate
    r_ids, r_scores, r_hits = (
        np.asarray(x)
        for x in ref_single_term(
            jnp.asarray(offsets.astype(np.int32)),
            jnp.asarray(pad([anchors, np.full(cap, 2000, np.int32)])),
            jnp.asarray(pad([scores01, np.zeros(cap, np.float32)])),
            jnp.asarray(terms.astype(np.int32)), jnp.asarray(tscore), capacity=cap, k=k,
        )
    )
    packed = np.stack([anchors, scores01.view(np.int32)], axis=1)
    hits = offsets[terms + 1] - offsets[terms]  # a run's length, as the reference counts num_hits
    q, run_anchors, run_scores = gather_runs(
        torch.from_numpy(offsets), torch.from_numpy(packed), torch.from_numpy(terms),
        torch.from_numpy(tscore), hits,
    )
    seg, ids, scores = segmented_topk(q, run_scores, run_anchors, len(terms), torch.full((len(terms),), k))
    seg, ids, scores = seg.numpy(), ids.numpy(), scores.numpy()
    np.testing.assert_array_equal(hits, r_hits)
    for row in range(len(terms)):
        mine = seg == row
        keep = r_scores[row] > 0  # the emitter's mask, applied to both
        np.testing.assert_array_equal(ids[mine][scores[mine] > 0], r_ids[row][keep])
        np.testing.assert_array_equal(
            scores[mine][scores[mine] > 0].view(np.int32), r_scores[row][keep].view(np.int32)
        )
