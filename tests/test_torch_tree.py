"""The port's tree evaluators against the JAX package's ``tree_candidates``
and ``tree_candidates_deep`` on random posting rows: several terms per slot
(their runs overlap on anchors), tied and sub-``1e-5`` scores, pad anchors
at ``num_docs``, groups that never hit. Several queries go through the port
in ONE call and are compared one by one with the reference.

Tolerance: the candidate anchors, their order and count are exact. Scores
are bit-equal where every union sums at most two values (the f32 sum of two
values does not depend on order); where a group has three or more slots, or
an anchor three or more groups or terms, the reference's associative scan
may round differently and the relative error is at most 1e-6.

Phrase boosts ride the rows as pseudo-rows (score -inf, the reference's
``_PHRASE_SLOT``); anchors that repeat among them multiply by 5 ** g, bit
for bit."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from veloci_tpu.ops.tree_step import (
    _PHRASE_SLOT,
    DEEP_GROUP_SHIFT,
    DEEP_SUB_SHIFT,
    DEEP_TERM_SHIFT,
    GROUP_SHIFT,
    tree_candidates as ref_tree_candidates,
    tree_candidates_deep as ref_tree_candidates_deep,
)
from veloci_tpu_torch.ops.tree_step import PHRASE_NG, tree_candidates, tree_candidates_deep
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

NUM_DOCS = 300
SLOT_BITS = 24  # every packed slot of the reference fits
QUERIES = 5
CAP = 2048  # the reference's row capacity: pads are anchor NUM_DOCS, score -inf

_ref_flat = jax.jit(ref_tree_candidates, static_argnums=(3,))
_ref_deep = jax.jit(ref_tree_candidates_deep, static_argnums=(4,))
PHRASE_BITS = 25  # the reference's phrase slot, 1 << 24, fits below 2**25


def _pad(a, s, slot, *rest):
    """Rows -> the reference's fixed-capacity arrays (one compile per function)."""
    n = CAP - len(a)
    assert n >= 0
    out = [
        jnp.asarray(np.concatenate([a, np.full(n, NUM_DOCS, np.int32)])),
        jnp.asarray(np.concatenate([s, np.full(n, -np.inf, np.float32)])),
        jnp.asarray(np.concatenate([slot, np.zeros(n, np.int32)])),
    ]
    return out + [jnp.asarray(np.concatenate([r, np.ones(n, r.dtype)])) for r in rest]


def _score(rng, n):
    """Quantized scores (ties across anchors and slots), some below 1e-5."""
    s = (rng.integers(1, 6, size=n) * 0.375).astype(np.float32)
    s[rng.random(n) < 0.1] = np.float32(3e-6)
    return s


def _rows(rng, term_slots):
    """One run per term (unique anchors in a run, runs overlap), the term's
    slot on each row; ~3% of the rows are pads at ``num_docs``."""
    a, s, slot = [], [], []
    for ts in term_slots:
        n = int(rng.integers(1, 60))
        anchors = rng.choice(NUM_DOCS + 1, size=n, replace=False)
        a.append(anchors)
        s.append(_score(rng, n))
        slot.append(np.full(n, ts))
    return np.concatenate(a).astype(np.int32), np.concatenate(s), np.concatenate(slot).astype(np.int32)


def _ref_candidates(a_s, final):
    a_s, final = np.asarray(a_s), np.asarray(final)
    hit = final > 0
    return a_s[hit], final[hit]


def _compare(got, want, exact):
    (ga, gf), (wa, wf) = got, want
    np.testing.assert_array_equal(ga, wa)
    if exact:
        np.testing.assert_array_equal(gf.view(np.int32), wf.view(np.int32))
    else:
        np.testing.assert_allclose(gf, wf, rtol=1e-6, atol=0)


def _port(fn, queries, *args):
    """Every query's rows in one call; -> per query (anchors, scores)."""
    seg = torch.cat([torch.full((len(q[0]),), i, dtype=torch.int64) for i, q in enumerate(queries)])
    a = torch.from_numpy(np.concatenate([q[0] for q in queries]).astype(np.int64))
    s = torch.from_numpy(np.concatenate([q[1] for q in queries]))
    # the port's slot keys count down: ascending key = the reference's slot desc
    slot = torch.from_numpy(((1 << SLOT_BITS) - 1 - np.concatenate([q[2] for q in queries])).astype(np.int64))
    out_seg, out_a, out_f = fn(seg, a, s, slot, *args)
    out_seg, out_a, out_f = out_seg.numpy(), out_a.numpy(), out_f.numpy()
    return [(out_a[out_seg == i], out_f[out_seg == i]) for i in range(len(queries))]


@pytest.mark.parametrize("shape", ["or_two_slots", "and_two_groups", "and_of_ors_wide", "or_many_slots"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_candidates_equal_reference(shape, seed):
    rng = np.random.default_rng(100 * seed + len(shape))
    groups, slots = {
        "or_two_slots": (1, 2),
        "and_two_groups": (2, 1),
        "and_of_ors_wide": (3, 3),
        "or_many_slots": (1, 6),
    }[shape]
    exact = groups <= 2 and slots <= 2
    queries, num_groups = [], []
    for _q in range(QUERIES):
        term_slots = [
            (g << GROUP_SHIFT) | int(rng.integers(slots))
            for g in range(groups) for _t in range(int(rng.integers(1, 4)))
        ]
        queries.append(_rows(rng, term_slots))
        # sometimes the AND needs a group that has no rows at all
        num_groups.append(groups + int(rng.random() < 0.2))
    got = _port(
        tree_candidates, queries, torch.tensor(num_groups), NUM_DOCS, SLOT_BITS, GROUP_SHIFT
    )
    hits = 0
    for (a, s, slot), ng, g in zip(queries, num_groups, got):
        want = _ref_candidates(*_ref_flat(*_pad(a, s, slot), NUM_DOCS, jnp.int32(ng)))
        _compare(g, want, exact)
        hits += len(want[0])
    assert hits > 0


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tree_candidates_deep_equal_reference(seed):
    """OR(AND(OR ..) ..) with repeated representative terms: subtrees that
    share a term take their maximum, distinct terms their union."""
    rng = np.random.default_rng(7 + seed)
    queries, ngs = [], []
    for _q in range(QUERIES):
        term_slots, term_ng = [], []
        for term in range(int(rng.integers(1, 4))):
            for sub in range(int(rng.integers(1, 3))):
                n_groups = int(rng.integers(1, 3))
                for g in range(n_groups):
                    for _t in range(int(rng.integers(1, 3))):
                        term_slots.append(
                            (term << DEEP_TERM_SHIFT) | (sub << DEEP_SUB_SHIFT)
                            | (g << DEEP_GROUP_SHIFT) | int(rng.integers(2))
                        )
                        term_ng.append(n_groups)
        a, s, slot = _rows(rng, term_slots)
        ng_of = dict(zip(term_slots, term_ng))
        queries.append((a, s, slot))
        ngs.append(np.array([ng_of[int(x)] for x in slot]))
    got = _port(
        tree_candidates_deep, queries, torch.from_numpy(np.concatenate(ngs)), NUM_DOCS, SLOT_BITS,
        (DEEP_TERM_SHIFT, DEEP_SUB_SHIFT, DEEP_GROUP_SHIFT),
    )
    hits = 0
    for (a, s, slot), ng, g in zip(queries, ngs, got):
        want = _ref_candidates(*_ref_deep(*_pad(a, s, slot, ng.astype(np.float32)), NUM_DOCS))
        _compare(g, want, exact=False)
        hits += len(want[0])
    assert hits > 0


def test_two_slot_union_is_bit_equal_and_gated():
    """A slot below 1e-5 adds its score but not its count (distinct^2)."""
    a = np.array([5, 5, 7, 7, 9], np.int32)
    s = np.array([0.7, 2e-6, 0.3, 0.45, 2e-6], np.float32)
    slot = np.array([0, 1, 0, 1, 1], np.int32)
    want = _ref_candidates(*_ref_flat(*_pad(a, s, slot), NUM_DOCS, jnp.int32(1)))
    (got,) = _port(tree_candidates, [(a, s, slot)], torch.tensor([1]), NUM_DOCS, SLOT_BITS, GROUP_SHIFT)
    _compare(got, want, exact=True)
    assert list(got[0]) == [7, 5]  # anchor 9 only scored below the gate


def test_empty_rows():
    e = torch.zeros(0, dtype=torch.int64)
    seg, a, f = tree_candidates(e, e, torch.zeros(0), e, torch.tensor([1]), NUM_DOCS, 4, 2)
    assert seg.numel() == a.numel() == f.numel() == 0


def _with_phrase(rng, a, s, slot, *rest):
    """Append phrase pseudo-rows: anchors drawn with repeats (g up to 3),
    some where no term hits; -> rows and the reference's phrase marker."""
    pa = rng.choice(np.concatenate([a[a < NUM_DOCS], rng.integers(0, NUM_DOCS, 20)]), size=40)
    p = len(pa)
    rows = (
        np.concatenate([a, pa.astype(np.int32)]),
        np.concatenate([s, np.full(p, -np.inf, np.float32)]),
        np.concatenate([slot, np.full(p, _PHRASE_SLOT, np.int32)]),
    )
    extra = tuple(np.concatenate([r, np.full(p, v, r.dtype)]) for r, v in rest)
    marker = np.concatenate([np.zeros(len(a), np.float32), np.ones(p, np.float32)])
    return rows, extra, marker


def _port_phrase(fn, queries, *args):
    """As _port, with each query's rows carrying (rows, marker)."""
    seg = torch.cat([torch.full((len(q[0][0]),), i, dtype=torch.int64) for i, q in enumerate(queries)])
    a = torch.from_numpy(np.concatenate([q[0][0] for q in queries]).astype(np.int64))
    s = torch.from_numpy(np.concatenate([q[0][1] for q in queries]))
    slot = torch.from_numpy(((1 << PHRASE_BITS) - 1 - np.concatenate([q[0][2] for q in queries])).astype(np.int64))
    phrase = torch.from_numpy(np.concatenate([q[1] for q in queries]) > 0)
    out_seg, out_a, out_f = fn(seg, a, s, slot, *args, phrase=phrase)
    out_seg, out_a, out_f = out_seg.numpy(), out_a.numpy(), out_f.numpy()
    return [(out_a[out_seg == i], out_f[out_seg == i]) for i in range(len(queries))]


def _phrase_pad(rows, marker, *rest):
    padded = _pad(*rows, *rest)
    n = CAP - len(marker)
    return padded, jnp.asarray(np.concatenate([marker, np.zeros(n, np.float32)]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_phrase_rows_multiply_by_five_per_group(seed):
    """Two-level trees with phrase pseudo-rows at repeated anchors: each
    candidate x 5 ** (its phrase rows), bit-equal to the reference."""
    rng = np.random.default_rng(40 + seed)
    queries, num_groups = [], []
    for _q in range(QUERIES):
        groups = int(rng.integers(1, 3))
        term_slots = [(g << GROUP_SHIFT) | int(rng.integers(2)) for g in range(groups) for _t in range(2)]
        rows, _extra, marker = _with_phrase(rng, *_rows(rng, term_slots))
        queries.append((rows, marker))
        num_groups.append(groups)
    got = _port_phrase(tree_candidates, queries, torch.tensor(num_groups), NUM_DOCS, PHRASE_BITS, GROUP_SHIFT)
    boosted = 0
    for (rows, marker), ng, g in zip(queries, num_groups, got):
        padded, pcnt = _phrase_pad(rows, marker)
        want = _ref_candidates(*_ref_flat(*padded, NUM_DOCS, jnp.int32(ng), pcnt))
        _compare(g, want, exact=True)
        pa = rows[0][marker > 0]
        boosted += sum(int((pa == x).sum()) >= 2 for x in g[0])
    assert boosted > 0  # some candidates took 5 ** 2 or more


@pytest.mark.parametrize("seed", [0, 1])
def test_phrase_rows_deep(seed):
    """The deep form with phrase pseudo-rows (their subtree gate never passes)."""
    rng = np.random.default_rng(60 + seed)
    queries, ngs = [], []
    for _q in range(QUERIES):
        term_slots, term_ng = [], []
        for term in range(int(rng.integers(1, 3))):
            n_groups = int(rng.integers(1, 3))
            for g in range(n_groups):
                term_slots.append((term << DEEP_TERM_SHIFT) | (g << DEEP_GROUP_SHIFT))
                term_ng.append(n_groups)
        a, s, slot = _rows(rng, term_slots)
        ng_of = dict(zip(term_slots, term_ng))
        ng = np.array([ng_of[int(x)] for x in slot], np.int64)
        rows, (ng,), marker = _with_phrase(rng, a, s, slot, (ng, PHRASE_NG))
        queries.append((rows, marker))
        ngs.append(ng)
    got = _port_phrase(
        tree_candidates_deep, queries, torch.from_numpy(np.concatenate(ngs)), NUM_DOCS, PHRASE_BITS,
        (DEEP_TERM_SHIFT, DEEP_SUB_SHIFT, DEEP_GROUP_SHIFT),
    )
    for (rows, marker), ng, g in zip(queries, ngs, got):
        padded, pcnt = _phrase_pad(rows, marker, ng.astype(np.float32))
        want = _ref_candidates(*_ref_deep(*padded, NUM_DOCS, pcnt))
        _compare(g, want, exact=False)
