"""Per-document boost factors, and the dense-plane forms of the generic step.

Counterpart of ``veloci_tpu/ops/generic_step.py``: ``_precompute_boost``
(``:46``), which the batched tree route reads at candidate anchors
(:func:`.tree_step._apply_boost_gathered`), and the dense-plane forms that
the reference's mesh route runs on each document shard (ROADMAP B4):
``_apply_boost`` (``:91``), ``tree_dense`` (``:113``), ``tree_dense_deep``
(``:138``), ``phrase_factor`` (``:187``) and the fused batch
``batched_generic_topk`` (``:202``).

The reference builds them in XLA; here they are plain PyTorch over
``[num_docs]`` planes, but for the one step that is kernel B7's
computation: a plane's terms, their posting runs gathered and each anchor's
maximum taken, go through :func:`.postings.csr_resolve` (the CUDA kernel on
a card). The reference adds a union's values with ``jnp.sum`` /
``segment_sum``, in an order XLA chooses; here every sum runs left to right
over the planes, groups, subtrees and terms in DESCENDING index order,
which is the order the port's tree route adds them in
(:mod:`.tree_step`: its keys count down), so that a plane numbered by
ascending slot gives the tree route's f32 bits. Two or fewer values sum
alike in either order; three or more may round apart from the reference
(ROADMAP C2). The mesh's batched route calls :func:`tree_dense_deep` and
:func:`generic_plane` (which applies :func:`phrase_factor` and
:func:`_apply_boost`), and the tree route :func:`_apply_boost`;
:func:`tree_dense` and :func:`batched_generic_topk` are the reference's
forms, kept so that the parity tests hold them to it, and nothing in the
search calls them. Facet counts are exact integers from a doc -> value CSR
(:func:`..search.facet.facet_counts`), not the reference's bf16 matmul.
"""

from __future__ import annotations

import numpy as np
import torch

from .postings import csr_resolve
from .topk import topk_dense

__all__ = [
    "_HIT_EPS",
    "_apply_boost",
    "_precompute_boost",
    "batched_generic_topk",
    "generic_plane",
    "phrase_factor",
    "tree_dense",
    "tree_dense_deep",
]

# boosted hits floor here, so a boost that yields 0 or less keeps the hit
_HIT_EPS = float(np.float32(1e-30))
_EPS = float(np.float32(1e-5))  # a union's hit gate, as an f32 value
_SKIP_TOL = 1e-5  # skip_when_score: |score - value| below this exempts a hit


def _precompute_boost(bv, pres, spec):
    """Per-doc boost factor arrays, computed once per boost column and spec.

    ``bv [num_docs]`` f32 boost values, ``pres [num_docs]`` bool presence,
    ``spec = (fun, param, skip_when_score tuple, expression add vector or
    None)`` (reference boost.rs:283-379). Returns ``(mode, fac, pres, skip,
    expr_add, folded)``: with no ``skip_when_score`` and a mul / add / no
    function the presence folds into the factors (absent -> multiplier 1,
    adder 0), ``folded = (m, a)``, either may be None."""
    fun, param, skip, expr_add = spec
    b = bv + float(np.float32(param or 0.0))
    if fun in ("Log10", "Log2"):
        # numpy's f32 logarithm, as the reference's host boost takes it
        # (torch's rounds otherwise on some values)
        with np.errstate(divide="ignore", invalid="ignore"):
            log = np.log10 if fun == "Log10" else np.log2
            fac, mode = torch.from_numpy(log(b.cpu().numpy(), dtype=np.float32)).to(b.device), "mul"
    elif fun == "Multiply":
        fac, mode = b, "mul"
    elif fun == "Add":
        fac, mode = b, "add"
    elif fun == "Replace":
        fac, mode = b, "replace"
    else:
        fac, mode = None, "none"
    folded = None
    if not skip and mode in ("mul", "add", "none"):
        if mode == "mul":
            m = torch.where(pres, fac, 1.0)
            a = torch.where(pres, expr_add, 0.0) if expr_add is not None else None
        else:  # add / none
            base = fac if mode == "add" else torch.zeros_like(bv)
            add_vec = base + expr_add if expr_add is not None else base
            m = None
            a = torch.where(pres, add_vec, 0.0)
        folded = (m, a)
    return (mode, fac, pres, tuple(skip or ()), expr_add, folded)


def _apply_boost(dense, pre):
    """A boost column over a plane (``_apply_boost``): ``pre`` from
    :func:`_precompute_boost`, its arrays shaped like ``dense``. Only hits
    (score > 0) with a present value are boosted, ``skip_when_score``
    exempts listed scores, and a boosted score floors at 1e-30. The folded
    modes read one array per boost (an absent value multiplies by 1 or adds
    0). Products and sums are separate f32 operations, as in the reference
    (no fused multiply-add)."""
    mode, fac, pres, skip, expr_add, folded = pre
    if folded is not None:
        m, add = folded
        boosted = dense * m if m is not None else dense
        if add is not None:
            boosted = boosted + add
        return torch.where(dense > 0, torch.clamp(boosted, min=_HIT_EPS), dense)
    if mode == "mul":
        boosted = dense * fac
    elif mode == "add":
        boosted = dense + fac
    elif mode == "replace":
        boosted = fac
    else:
        boosted = dense
    if expr_add is not None:
        boosted = boosted + expr_add
    apply_mask = (dense > 0) & pres
    for sv in skip:
        apply_mask &= torch.abs(dense - float(np.float32(sv))) >= _SKIP_TOL
    return torch.where(apply_mask, torch.clamp(boosted, min=_HIT_EPS), dense)


def _planes(csr, tids, tscs, rows, num_planes: int, nd: int):
    """One ``[nd]`` plane per plane index: the terms whose ``rows`` entry
    names it, resolved by B7 (:func:`.postings.csr_resolve`). ``tids``
    global term ids (pad -1, dropped), ``tscs`` their f32 scores."""
    tids = np.asarray(tids, dtype=np.int64)
    tscs = np.asarray(tscs, dtype=np.float32)
    rows = np.asarray(rows, dtype=np.int64)
    live = tids >= 0
    return [csr_resolve(csr, tids[live & (rows == p)], tscs[live & (rows == p)], nd) for p in range(num_planes)]


def _ordered_sum(planes, zeros):
    """The planes summed left to right in descending index order."""
    total = zeros
    for p in reversed(planes):
        total = total + p
    return total


def tree_dense(csr, tids, tscs, tslots, nd: int, num_slots: int, is_and: bool):
    """One flat tree -> its ``[nd]`` plane (``tree_dense``): each slot's
    plane (its terms' runs, each anchor's maximum); an AND keeps the sum of
    the slots where every slot hits, an OR (set_op.rs:87-220) multiplies
    the sum by distinct squared, distinct the slots that reach 1e-5.
    ``csr`` a :class:`.postings.Csr` (an index's, or a document shard's,
    ``nd`` its documents), ``tids``, ``tscs``, ``tslots`` host arrays."""
    planes = _planes(csr, tids, tscs, tslots, num_slots, nd)
    zeros = torch.zeros(nd, dtype=torch.float32, device=csr.packed.device)
    total = _ordered_sum(planes, zeros)
    if is_and:
        all_hit = torch.ones(nd, dtype=torch.bool, device=zeros.device)
        for p in planes:
            all_hit &= p > 0
        return torch.where(all_hit, total, 0.0)
    distinct = torch.zeros(nd, dtype=torch.float32, device=zeros.device)
    for p in reversed(planes):
        distinct = distinct + (p >= _EPS).to(torch.float32)
    return total * distinct * distinct


def tree_dense_deep(csr, tids, tscs, tplanes, s2g, g2s, s2t, ng_sub, nd: int,
                    num_planes: int, num_groups: int, num_subs: int, num_terms: int):
    """One deep (OR-of-ANDs) tree -> its ``[nd]`` plane (``tree_dense_deep``),
    the tree given as data: ``tplanes`` each term's plane, ``s2g`` /
    ``g2s`` / ``s2t`` plane -> group -> subtree -> representative term,
    ``ng_sub`` each subtree's AND gate (its group count); host arrays.

      stage 1  per (plane, doc): the maximum of its terms' rows   (B7)
      stage 2  per group: sum of plane maxima x distinct^2        (union)
      stage 3  per subtree: sum over groups, all ``ng`` must hit  (intersect)
      stage 4  per representative term: MAX over its subtrees
      stage 5  per doc: sum of term maxima x distinct^2           (union)

    Every sum runs in descending index order (see the module note)."""
    planes = _planes(csr, tids, tscs, tplanes, num_planes, nd)
    dev = csr.packed.device
    zeros = torch.zeros(nd, dtype=torch.float32, device=dev)
    s2g, g2s, s2t = (np.asarray(m, dtype=np.int64) for m in (s2g, g2s, s2t))
    ng_sub = np.asarray(ng_sub, dtype=np.float32)
    g_sum, g_cnt = [zeros] * num_groups, [zeros] * num_groups
    for p in reversed(range(num_planes)):
        g = s2g[p]
        g_sum[g] = g_sum[g] + planes[p]
        g_cnt[g] = g_cnt[g] + (planes[p] >= _EPS).to(torch.float32)
    g_score = [torch.where(c > 0, s * c * c, 0.0) for s, c in zip(g_sum, g_cnt)]
    s_sum, s_cnt = [zeros] * num_subs, [zeros] * num_subs
    for g in reversed(range(num_groups)):
        u = g2s[g]
        s_sum[u] = s_sum[u] + g_score[g]
        s_cnt[u] = s_cnt[u] + (g_score[g] > 0).to(torch.float32)
    t_max = [zeros] * num_terms
    for u in range(num_subs):
        sub = torch.where(s_cnt[u] >= float(ng_sub[u]), s_sum[u], 0.0)
        t_max[s2t[u]] = torch.maximum(t_max[s2t[u]], sub)
    t_hit = zeros
    for t in reversed(t_max):
        t_hit = t_hit + (t >= _EPS).to(torch.float32)
    return _ordered_sum(t_max, zeros) * t_hit * t_hit


def phrase_factor(panch, nd: int):
    """The phrase factor over ``[nd]`` (``phrase_factor``;
    BoostAnchorFromPhraseResults, plan_steps.rs:262-283): 5 ** g at an
    anchor that appears g times in ``panch`` (an int64 tensor of anchors;
    those outside ``[0, nd)`` are pads). 5 ** g is taken in f64 and rounded
    to f32, as the tree route takes it: exact up to g = 10."""
    panch = panch[(panch >= 0) & (panch < nd)]
    g = torch.bincount(panch, minlength=nd)
    return torch.pow(5.0, g.to(torch.float64)).to(torch.float32)


def generic_plane(dense, fmask=None, pre_boosts=(), panch=None, phrase_first: bool = False):
    """A tree's plane with the generic extras, in the reference's batched
    order (search.rs:143-228): the filter mask, the boost columns in
    request order (:func:`_apply_boost`), then the phrase factor. With
    ``phrase_first`` the phrase factor comes first, as the port's tree
    route applies it (:mod:`.tree_step`), which the mesh's batched route
    follows so that it answers as the unsharded index does."""
    nd = dense.shape[0]
    if panch is not None and phrase_first:
        dense = dense * phrase_factor(panch, nd)
    if fmask is not None:
        dense = torch.where(fmask, dense, 0.0)
    for pre in pre_boosts:
        dense = _apply_boost(dense, pre)
    if panch is not None and not phrase_first:
        dense = dense * phrase_factor(panch, nd)
    return dense


def batched_generic_topk(csr, term_ids, term_scores, term_slots, filter_masks, filter_idx, phrase_anchors,
                         boost_arrays, facet_relations, num_docs: int, k: int, num_slots: int, is_and: bool,
                         boost_specs, phrase_first: bool = False):
    """A batch of generic queries on one device -> ``(ids, scores,
    num_hits [Q], facet counts)`` (``batched_generic_topk``): per query its
    tree's plane (:func:`tree_dense`), the extras (:func:`generic_plane`),
    the hit count, each facet relation's counts over the hits
    (``[Q, G_i]`` int64, exact) and the exact top ``k`` by (score desc, id
    desc) as two lists of tensors.

    ``term_ids``, ``term_scores``, ``term_slots`` ``[Q, T]`` host arrays
    (ids padded with -1); ``filter_masks [NF, num_docs]`` bool and
    ``filter_idx [Q]`` (-1: no filter), or None; ``phrase_anchors [Q, P]``
    int64 (pad ``num_docs``) or None; ``boost_arrays`` per boost ``(bv, pres,
    expr_add or None)`` with its ``(fun, param, skip)`` in ``boost_specs``;
    ``facet_relations`` :class:`..search.facet.FacetRelation` s."""
    from ..search.facet import facet_counts

    pre_boosts = tuple(
        _precompute_boost(bv, pres, spec + (expr_add,))
        for (bv, pres, expr_add), spec in zip(boost_arrays, boost_specs)
    )
    dev = csr.packed.device
    ids, scores, num_hits = [], [], []
    counts = [[] for _ in facet_relations]
    for q in range(len(term_ids)):
        dense = tree_dense(csr, term_ids[q], term_scores[q], term_slots[q], num_docs, num_slots, is_and)
        fi = None if filter_idx is None else int(filter_idx[q])
        panch = None
        if phrase_anchors is not None:
            panch = torch.as_tensor(np.asarray(phrase_anchors[q], dtype=np.int64), device=dev)
        dense = generic_plane(dense, filter_masks[fi] if fi is not None and fi >= 0 else None, pre_boosts,
                              panch, phrase_first)
        hits = torch.nonzero(dense > 0).squeeze(1)
        num_hits.append(int(hits.numel()))
        for c, rel in zip(counts, facet_relations):
            c.append(facet_counts(rel, torch.zeros_like(hits), hits, 1)[0])
        i, s = topk_dense(dense, k)
        ids.append(i)
        scores.append(s)
    return ids, scores, np.asarray(num_hits, dtype=np.int64), tuple(
        torch.stack(c) if c else torch.zeros((0, rel.num_targets), dtype=torch.int64, device=dev)
        for c, rel in zip(counts, facet_relations))
