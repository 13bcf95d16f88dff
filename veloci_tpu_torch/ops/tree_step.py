"""Tree evaluation over gathered posting rows: single-slot, two-level, deep.

Counterpart of ``tree_candidates_single``, ``tree_candidates``,
``tree_candidates_deep`` and ``candidates_topk`` inside ``batched_tree_topk``
(``veloci_tpu/ops/tree_step.py:123-328, 372``). The reference sorts each
query's rows by (anchor desc, slot desc, score desc) and reads the tree off
that order with segmented scans:

* per (anchor, slot): the maximum score -- one leaf's term variants dedup
  to their best (search_field.rs:451-465);
* per (anchor, group): the sum of slot maxima x distinct^2, where distinct
  counts the slots that reach ``1e-5`` -- union (set_op.rs:87-220);
* per anchor: the sum over groups, kept when every group scored -- AND
  (set_op.rs:368-448); a flat OR is the one-group case.

The deep form (an OR of ANDs of ORs) adds the subtree level, gated on its
own group count, the maximum over subtrees that share their leftmost term,
and a last union over those terms.

Phrase boosts ride the same sort (``tree_step.py:446-465``): each phrase
anchor is a pseudo-row with score -inf whose slot key sorts before every
real one and forms its own group (deep: its own term) that never scores;
each candidate's score is then multiplied by 5 ** (its phrase rows),
before the filter and the boosts (``:208-212, 310-312``).

Here one sort serves a whole batch: every row gets an int64 key
(query, anchor desc, slot key), ``torch.unique`` sorts and dedups the keys
and a scatter max gives each (query, anchor, slot) its best score. Each
level of the tree is then a run of equal ``key >> shift``: the host packs
the slot key with one bit field per level, outermost highest, each field
counting DOWN, so ascending keys visit the slots in the reference's slot-
descending order. A union sums its values left to right in that order: for
one or two values that is the reference's f32 sum bit for bit; for three
or more the reference's associative scan may round differently.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trace import trace_time
from .generic_step import _apply_boost
from .search_step import gather_runs
from .topk import score_desc_key

__all__ = [
    "PHRASE_NG",
    "batched_tree_candidates",
    "tree_candidates_single",
    "tree_candidates",
    "tree_candidates_deep",
    "_apply_boost_gathered",
]

_EPS = float(np.float32(1e-5))  # the reference's hit gate, as an f32 value
_I31 = (1 << 31) - 1
PHRASE_NG = 1 << 30  # a phrase pseudo-row's subtree gate: never passes


def tree_candidates_single(seg, a, s, num_docs: int):
    """Single-slot queries (one leaf's terms, or one term string over
    several fields): each anchor's maximum, kept where it reaches the gate
    (``tree_candidates_single``). Returns ``(query, anchor, score)`` ordered
    by (query, anchor desc)."""
    with trace_time("tree_candidates_single"):
        # rows sorted by (query, anchor desc, score desc): each anchor's first
        # row in its query holds its maximum
        order = torch.argsort(((_I31 - a) << 32) | score_desc_key(s), stable=True)
        order = order[torch.argsort(seg[order], stable=True)]
        seg, a, s = seg[order], a[order], s[order]
        first = torch.ones_like(seg, dtype=torch.bool)
        first[1:] = (seg[1:] != seg[:-1]) | (a[1:] != a[:-1])
        cand = first & (a < num_docs) & (s >= _EPS)
        return seg[cand], a[cand], s[cand]


def _anchor_bits(num_docs: int) -> int:
    return max(1, (num_docs - 1).bit_length())


def _slot_entries(seg, a, s, slot, num_docs: int, slot_bits: int, *per_row, phrase=None):
    """Rows -> one entry per (query, anchor, slot), ascending by key
    (query, anchor desc, slot key), with its best score, for each
    ``per_row`` tensor (constant within an entry) its value, and, given the
    ``phrase`` row flags, each entry's count of phrase rows (else None)."""
    with trace_time("_slot_entries"):
        ab = _anchor_bits(num_docs)
        if seg.numel() and int(seg.max()).bit_length() + ab + slot_bits > 63:
            raise ValueError("query, anchor and slot keys do not fit an int64 key")
        keep = (a >= 0) & (a < num_docs)
        seg, a, s, slot = seg[keep], a[keep], s[keep], slot[keep]
        key = (seg << (ab + slot_bits)) | ((num_docs - 1 - a) << slot_bits) | slot
        ekey, inv = torch.unique(key, sorted=True, return_inverse=True)
        best = torch.full(ekey.shape, -torch.inf, dtype=s.dtype, device=s.device)
        best.scatter_reduce_(0, inv, s, "amax")
        extra = [torch.zeros(ekey.shape, dtype=t.dtype, device=t.device).scatter_(0, inv, t[keep])
                 for t in per_row]
        pcount = None
        if phrase is not None:
            pcount = torch.zeros(ekey.shape, dtype=torch.int64, device=s.device)
            pcount.index_add_(0, inv, phrase[keep].to(torch.int64))
        return ekey, best, extra, pcount


def _phrase_factor(final, pcount, run_of):
    """``final`` x 5 ** (phrase rows per anchor): ``pcount`` per entry of a
    level below the anchors, ``run_of`` each entry's anchor. 5 ** g is exact
    in f32 up to g = 10, and correctly rounded from f64 above."""
    if pcount is None:
        return final
    g = torch.zeros(final.shape, dtype=torch.int64, device=final.device)
    g.index_add_(0, run_of, pcount)
    return final * torch.pow(5.0, g.to(torch.float64)).to(torch.float32)


def _runs(keys):
    """Runs of equal consecutive ``keys``: (run keys, run of each key, run lengths)."""
    return torch.unique_consecutive(keys, return_inverse=True, return_counts=True)


def _firsts(values, counts):
    return values[torch.cumsum(counts, 0) - counts]


def _ordered_sum(values, counts):
    """Per run of ``counts`` consecutive ``values``, their f32 sum taken
    left to right (deterministic on every device)."""
    if counts.numel() == 0:
        return values[:0]
    starts = torch.cumsum(counts, 0) - counts
    acc = values[starts]
    for r in range(1, int(counts.max())):
        live = counts > r
        acc = torch.where(live, acc + values[torch.where(live, starts + r, starts)], acc)
    return acc


def _count(flags, run_of, num_runs):
    """Per run, how many ``flags`` are set, as f32 (the reference's counts)."""
    out = torch.zeros(num_runs, dtype=torch.int64, device=flags.device)
    return out.index_add_(0, run_of, flags.to(torch.int64)).to(torch.float32)


def _union(values, run_of, counts):
    """Sum of ``values`` x distinct^2 per run, distinct = values >= 1e-5."""
    total = _ordered_sum(values, counts)
    cnt = _count(values >= _EPS, run_of, counts.numel())
    return total, cnt


def _candidates(akey, final, num_docs):
    """Anchor keys + scores -> (query, anchor, score) where the score > 0."""
    ab = _anchor_bits(num_docs)
    hit = final > 0
    akey, final = akey[hit], final[hit]
    return akey >> ab, (num_docs - 1) - (akey & ((1 << ab) - 1)), final


def tree_candidates(
    seg, a, s, slot, num_groups, num_docs: int, slot_bits: int, group_shift: int, phrase=None,
):
    """Two-level tree (flat OR, flat AND, AND of ORs) over gathered rows.

    ``seg [M]`` query of each row, ``a [M]`` int64 anchors, ``s [M]`` f32
    scores, ``slot [M]`` int64 slot keys below ``2**slot_bits`` whose bits
    from ``group_shift`` up name the group; ``num_groups [Q]`` the groups
    each query's AND needs; ``phrase [M]`` (optional) bool, True on the
    phrase pseudo-rows (see the module note). Returns ``(query, anchor,
    score)`` of every anchor with a score > 0, ordered by (query, anchor
    desc)."""
    ekey, slot_max, _, pcount = _slot_entries(seg, a, s, slot, num_docs, slot_bits, phrase=phrase)
    gkey, g_of, g_len = _runs(ekey >> group_shift)
    sum2, cnt2 = _union(slot_max, g_of, g_len)
    group_score = torch.where(cnt2 > 0, sum2 * cnt2 * cnt2, 0.0)
    akey, a_of, a_len = _runs(gkey >> (slot_bits - group_shift))
    sum3 = _ordered_sum(group_score, a_len)
    cnt3 = _count(group_score > 0, a_of, a_len.numel())
    need = num_groups[akey >> _anchor_bits(num_docs)].to(torch.float32)
    final = torch.where(cnt3 >= need, sum3, 0.0)
    final = _phrase_factor(final, pcount, a_of[g_of])
    return _candidates(akey, final, num_docs)


def tree_candidates_deep(seg, a, s, slot, ng, num_docs: int, slot_bits: int, shifts, phrase=None):
    """OR of (leaf | AND of (leaf | OR of leaves)) over gathered rows.

    As :func:`tree_candidates`, with ``shifts = (term, subtree, group)``:
    the slot key's bits from each shift up name the row's leftmost-term
    slot, its subtree and its group; ``ng [M]`` is each row's subtree group
    count (its AND gate; ``PHRASE_NG`` on a phrase pseudo-row)."""
    term_shift, sub_shift, group_shift = shifts
    ekey, slot_max, (ng_e,), pcount = _slot_entries(
        seg, a, s, slot, num_docs, slot_bits, ng, phrase=phrase
    )
    # stage 2: union within each leaf-OR group
    gkey, g_of, g_len = _runs(ekey >> group_shift)
    sum2, cnt2 = _union(slot_max, g_of, g_len)
    group_score = torch.where(cnt2 > 0, sum2 * cnt2 * cnt2, 0.0)
    ng_g = _firsts(ng_e, g_len)
    # stage 3: AND over a subtree's groups, gated on all of them
    ukey, u_of, u_len = _runs(gkey >> (sub_shift - group_shift))
    sum3 = _ordered_sum(group_score, u_len)
    cnt3 = _count(group_score > 0, u_of, u_len.numel())
    sub_score = torch.where(cnt3 >= _firsts(ng_g, u_len).to(torch.float32), sum3, 0.0)
    # stage 4: max over subtrees with the same leftmost term (identity 0)
    tkey, t_of, t_len = _runs(ukey >> (term_shift - sub_shift))
    term_max = torch.zeros(t_len.numel(), dtype=sub_score.dtype, device=sub_score.device)
    term_max.scatter_reduce_(0, t_of, sub_score, "amax")
    # stage 5: union over the distinct terms of each anchor
    akey, a_of, a_len = _runs(tkey >> (slot_bits - term_shift))
    sum5, cnt5 = _union(term_max, a_of, a_len)
    final = _phrase_factor(sum5 * cnt5 * cnt5, pcount, a_of[t_of[u_of[g_of]]])
    return _candidates(akey, final, num_docs)


def batched_tree_candidates(
    offsets, packed, term_ids, term_scores, term_query, counts, num_docs: int, *,
    term_slots=None, slot_bits: int = 0, shifts=(), num_groups=None, term_ngs=None,
    phrase_rows=None,
):
    """Many tree queries, one gather and one sort for the batch -> the flat
    ``(query, anchor, score)`` candidates (score > 0), ordered by (query,
    anchor desc).

    Per term on the device: ``term_ids``, ``term_scores``, ``term_query``
    and, for multi-slot trees, ``term_slots`` (slot keys, see
    :func:`tree_candidates`) and for deep trees ``term_ngs``; ``counts``
    [T] run lengths on the host. With no ``term_slots`` every query is
    single-slot (:func:`tree_candidates_single`). Two-level trees pass
    ``num_groups [num_queries]`` and ``shifts = (group_shift,)``, deep
    trees ``term_ngs`` and ``shifts = (term, subtree, group)``.
    ``phrase_rows = (query, anchor, slot key)`` [P] adds the phrase
    pseudo-rows (multi-slot trees only)."""
    if term_slots is None:
        _t, a, s, seg = gather_runs(offsets, packed, term_ids, term_scores, counts, term_query)
        return tree_candidates_single(seg, a, s, num_docs)
    per_term = (term_query, term_slots) + (() if term_ngs is None else (term_ngs,))
    _t, a, s, seg, slot, *ng = gather_runs(offsets, packed, term_ids, term_scores, counts, *per_term)
    phrase = None
    if phrase_rows is not None:
        pq, pa, pslot = phrase_rows
        phrase = torch.cat([torch.zeros_like(a, dtype=torch.bool), torch.ones_like(pa, dtype=torch.bool)])
        seg, a, slot = torch.cat([seg, pq]), torch.cat([a, pa]), torch.cat([slot, pslot])
        s = torch.cat([s, torch.full(pa.shape, -torch.inf, dtype=s.dtype, device=s.device)])
        if ng:
            ng = [torch.cat([ng[0], torch.full_like(pa, PHRASE_NG)])]
    if term_ngs is None:
        return tree_candidates(
            seg, a, s, slot, num_groups, num_docs, slot_bits, shifts[0], phrase=phrase
        )
    return tree_candidates_deep(seg, a, s, slot, ng[0], num_docs, slot_bits, shifts, phrase=phrase)


def _apply_boost_gathered(final, a_s, pre):
    """A boost column read at the candidate anchors ``a_s`` (all below
    ``num_docs``) only (``tree_step.py:331``): ``pre`` from
    :func:`.generic_step._precompute_boost`, gathered at ``a_s`` and applied
    as :func:`.generic_step._apply_boost` applies it to a plane."""
    mode, fac, pres, skip, expr_add, folded = pre

    def at(t):
        return None if t is None else t[a_s]

    if folded is not None:
        folded = (at(folded[0]), at(folded[1]))
    return _apply_boost(final, (mode, at(fac), at(pres), skip, at(expr_add), folded))
