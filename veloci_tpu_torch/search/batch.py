"""Batched serving for trees of exact, fuzzy and ``starts_with`` leaves, with
filters, boosts, facets and phrase boosts.

Counterpart of ``search_batch`` (``veloci_tpu/search/batch.py:983-1177``) for
the requests its batched routes take: a tree that is one search leaf, a
flat OR, a flat AND or an AND of ORs (``_node_groups``, ``:108``), or an OR
whose children are leaves and such ANDs (``_node_deep``, ``:198``), after
the redundant nesting is flattened (``_normalize_node``, ``:177``). Leaves
hold one term, exact or fuzzy at any distance, with or without
``starts_with`` and a ``token_value`` boost. Plain trees take the routes
of ``_plain_eligible`` (``:686-712``); a request with a filter, boost
columns, facets or phrase boosts takes the same tree evaluators with the
extras of ``_run_generic_group`` (``:1250-1452``, ``_generic_eligible``
``:484-647``).

The batch's fuzzy leaves, in the trees, the filters and the phrase pairs,
get their matches from one sweep launch per field and kernel
(``_prefetch_request_fuzzy``, ``:297-336``). Then each request takes one
route, as in the reference (``:1030-1068``): a plain tree that resolves to
ONE term reads that term's posting run ("singles"); a tree of one group
whose matched terms share one slot takes the single-slot evaluator (not
with phrase boosts); other two-level trees the tree evaluator, and OR-of-AND
trees its deep form. The extras follow the reference's order
(``ops/tree_step.py:466-495``): the tree with its phrase factor, the filter,
the boosts in request order, ``num_hits`` = the scores > 0, the facet counts
over that hit set, and the exact top-k. Results are windowed as
``_make_emit`` does (``:870-891``).

The reference sends a request past its caps (leaf term counts, slots,
groups, sort capacity, phrase anchors) to its per-request executor; here
every admitted request is answered on its tree route, and a batch whose
gathered posting rows exceed ``_ROW_BUDGET`` is split into several sorts.
A ``why_found`` request takes the route its shape takes; its result then
gets the leaves' matched terms and, with ``select``, its top hits'
highlighted texts (``_attach_why_found``, ``:828-868``). The shapes the
tree routes do not take -- the reference's own causes for its executor
(``_generic_eligible``, ``:484-647``; ``:1062``) -- go to the per-request
dense executor (:func:`.executor.search`), one request at a time, as
there; so does every request that asks for ``explain``, as the reference's
batched routes decline it. One table decides (:data:`_ADMISSION`); no
request falls through to another engine on an error. Each request's route
is counted on ``index.path_counts`` and in :mod:`.stats`.
"""

from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..create import BOOST_VALID_TO_VALUE, PHRASE_PAIR_TO_ANCHOR, TEXTINDEX
from ..error import InvalidRequestError
from ..query.request import SearchRequest
from ..ops.generic_step import _precompute_boost
from ..ops.search_step import batched_single_term_topk
from ..ops.topk import segmented_topk
from ..ops.tree_step import _apply_boost_gathered, batched_tree_candidates
from ..persistence import as_index
from .boost import ScoreExpression, expr_vec, resolve_ids_to_anchor
from .facet import facet_counts, facet_relation, format_counts
from .field_search import (
    fuzzy_spec,
    leaf_field,
    match_term_ids,
    prefetch_fuzzy_matches,
    search_field,
    term_ids_and_scores,
)
from .result import Hit, SearchResult
from .stats import count_path
from .why_found import get_why_found, merge_field_hits

__all__ = ["search_batch"]

SEARCH, OR, AND = SearchRequest.SEARCH, SearchRequest.OR, SearchRequest.AND

# gathered posting rows per sort: bounds the device memory of one sort
# (about 64 bytes a row across the key, score, order and run arrays)
_ROW_BUDGET = 1 << 23

def _text_path(path: str) -> str:
    return path if path.endswith(TEXTINDEX) else path + TEXTINDEX


def _boost_path(boost) -> str:
    bp = boost.path
    return bp if bp.endswith(BOOST_VALID_TO_VALUE) else bp + BOOST_VALID_TO_VALUE


def _has_extras(request) -> bool:
    return bool(request.filter or request.boost or request.facets or request.phrase_boosts)


def _extra_parts(request):
    """The leaves of the request's filter and phrase boosts."""
    if request.filter is not None:
        yield from request.filter.walk_parts()
    for pb in request.phrase_boosts or ():
        yield pb.search1
        yield pb.search2


class _Tree(NamedTuple):
    """What admission reads of a request's tree, from one pass over it."""

    explain: bool  # a leaf's options ask for explain
    regex: bool  # a regex leaf
    snippet: bool  # a leaf asks for snippets
    fits: bool  # the tree routes take every leaf and node


def _scan(node, index) -> _Tree:
    """One pass over the tree. The tree routes take it (``_leaf_ok``,
    ``:52``) when every leaf has one term, no options and a field with
    postings, and no node has options."""
    explain = regex = snippet = False
    fits = True
    stack = [node]
    while stack:
        node = stack.pop()
        if node.kind != SEARCH:
            fits = fits and not node.options
            stack.extend(node.queries)
            continue
        p = node.part
        explain = explain or bool(p.options and p.options.get("explain"))
        regex = regex or p.is_regex
        snippet = snippet or bool(p.snippet)
        fits = fits and len(p.terms) == 1 and not p.options and leaf_field(p) in index.key_base
    return _Tree(explain, regex, snippet, fits)


# Admission: (route, key, predicate(request, index, _Tree), reason). The
# first row whose predicate holds decides: "executor" sends the request to
# the per-request dense executor, which counts the row's key as its
# fallback reason (search/stats.py); "generic" and "plain" admit it to the
# tree routes, unless its tree is beyond OR(AND(OR)) once flattened
# (_plan), which goes to the executor too ("tree_shape"). why_found has no
# row: it rides any route, and the route's results get its metadata
# (_attach_why_found). The executor rows are where the reference sends a
# request to its executor (its fast paths and search_batch decline
# explain; _generic_eligible the rest); its caps that exist only for the
# TPU compile and memory model (_MAX_FILTER_ANCHORS on phrase anchors, the
# t/q/p pad buckets, _MAX_LEAF_TERMS_FUZZY with its "fz" route) have no
# row. Admission runs for every request of a batch, so the tree is read
# once (_scan) and each row reads its flags.
_ADMISSION = (
    ("executor", "explain", lambda r, ix, t: r.explain or t.explain,
     "request or leaf 'explain': the executor keeps the planes its entries read"),
    ("executor", "boost_term", lambda r, ix, t: r.boost_term, "a 'boost_term' factor"),
    ("executor", "text_locality", lambda r, ix, t: r.text_locality, "a 'text_locality' factor"),
    ("executor", "suggest", lambda r, ix, t: r.suggest,
     "a request that carries 'suggest' (its search_req is answered)"),
    ("executor", "regex_leaf", lambda r, ix, t: t.regex or any(p.is_regex for p in _extra_parts(r)),
     "a regex leaf, in the tree, a filter or a phrase boost"),
    ("executor", "snippet_leaf", lambda r, ix, t: t.snippet, "a leaf that asks for snippets"),
    ("executor", "boost_1n", lambda r, ix, t: any("[]" in b.path for b in r.boost or ()),
     "a boost over a 1:n path ('[]')"),
    ("executor", "boost_without_column",
     lambda r, ix, t: any(not ix.has_index(_boost_path(b)) for b in r.boost or ()),
     "a boost path without a boost column"),
    ("executor", "facet_relation",
     lambda r, ix, t: any(facet_relation(ix, f.field) is None for f in r.facets or ()),
     "a facet field without a fast relation, or past the facet gates"),
    ("executor", "phrase_two_fields",
     lambda r, ix, t: any(pb.search1.path != pb.search2.path for pb in r.phrase_boosts or ()),
     "a phrase boost over two fields (the executor raises InvalidRequestError)"),
    ("executor", "leaf_shape", lambda r, ix, t: not t.fits,
     "leaves with several terms, leaf or node options, or a field without postings"),
    ("generic", "generic", lambda r, ix, t: _has_extras(r),
     "filter, boost columns, facets or phrase boosts: the tree routes with their extras"),
    ("plain", "plain", lambda r, ix, t: True, "a plain tree: the singles and tree routes"),
)


def _normalize_node(node):
    """Flatten same-kind nesting and collapse single-child nodes (``:177``):
    the reference's ``simplify()`` and its executor's one-child shortcut, so
    shapes that differ only by redundant nesting take the same route."""
    if node.kind == SEARCH:
        return node
    children = []
    for q in node.queries:
        qn = _normalize_node(q)
        children.extend(qn.queries if qn.kind == node.kind else [qn])
    if len(children) == 1:
        return children[0]
    return SearchRequest(node.kind, queries=children)


def _leaf_or(node):
    """The leaves of a node that is one leaf or an OR of leaves, else None."""
    if node.kind == SEARCH:
        return [node.part]
    if node.kind == OR and all(q.kind == SEARCH for q in node.queries):
        return [q.part for q in node.queries]
    return None


def _node_groups(node):
    """A two-level tree -> its groups of leaves under an implicit AND
    (``:108``): a leaf or an OR of leaves is one group, an AND has one
    group per child. None for other shapes."""
    leaves = _leaf_or(node)
    if leaves is not None:
        return [leaves]
    if node.kind != AND:
        return None
    groups = [_leaf_or(q) for q in node.queries]
    return None if any(g is None for g in groups) else groups


def _node_deep(node):
    """``OR(leaf | AND(leaf | OR(leaves)))`` -> ``[(repr_term, groups)]``,
    one per child of the OR (``:198``); None for other shapes. A child's
    representative is its leftmost leaf's term: the executor's OR unions its
    children grouped by that term."""
    if node.kind != OR:
        return None
    supers = []
    for q in node.queries:
        if q.kind == SEARCH:
            supers.append((q.part.terms[0], [[q.part]]))
            continue
        if q.kind != AND:
            return None
        groups = [_leaf_or(c) for c in q.queries]
        if any(g is None for g in groups):
            return None
        supers.append((groups[0][0].terms[0], groups))
    return supers


def _leaf_slots(supers):
    """Deep tree -> [(part, (term slot, subtree, group, slot in group))] with
    ``_tree_spec_deep``'s numbering (``:248``); the subtree's group count
    rides along for its AND gate."""
    term_slot = {t: i for i, t in enumerate(sorted({t for t, _g in supers}))}
    sub_count: dict = {}
    out = []
    for repr_term, groups in supers:
        ts = term_slot[repr_term]
        sub = sub_count.get(ts, 0)
        sub_count[ts] = sub + 1
        for gi, parts in enumerate(groups):
            slots = {t: i for i, t in enumerate(sorted({p.terms[0] for p in parts}))}
            out.extend((p, (ts, sub, gi, slots[p.terms[0]]), len(groups)) for p in parts)
    return out


def _group_slots(groups):
    """Two-level tree -> [(part, (group, slot in group))]: within a group,
    one slot per distinct term STRING (``_tree_spec``, ``:144-174``), so the
    same term over several fields is ONE slot and takes their maximum."""
    out = []
    for gi, parts in enumerate(groups):
        slots = {t: i for i, t in enumerate(sorted({p.terms[0] for p in parts}))}
        out.extend((p, (gi, slots[p.terms[0]]), 0) for p in parts)
    return out


class _Query(NamedTuple):
    """One admitted request resolved to global term ids."""

    qi: int  # index in the batch
    k: int  # top + skip, capped at num_docs
    gtids: np.ndarray  # [t] int64 global term ids
    scores: np.ndarray  # [t] f32
    levels: np.ndarray  # [t, levels] int64 slot numbering of each term
    ng: np.ndarray  # [t] int64 subtree group count (deep trees)
    num_groups: int
    fkey: Optional[tuple] = None  # the filter's tree key
    panchors: np.ndarray = np.empty(0, np.int64)  # phrase anchors, with multiplicity


def _resolve(index, qi, req, plan, fuzzy, memo) -> _Query:
    kind, shape = plan.kind, plan.shape
    leaves = _leaf_slots(shape) if kind == "deep" else _group_slots(shape)
    g, sc, lv, ng = [np.empty(0, np.int64)], [np.empty(0, np.float32)], [], []
    for part, levels, n_groups in leaves:
        key = part.key()
        hit = memo.get(key)
        if hit is None:
            ids, scores = term_ids_and_scores(index, part, fuzzy)
            base, nk = index.key_base[leaf_field(part)]
            keep = ids < nk
            hit = memo[key] = (ids[keep] + base, scores[keep])
        g.append(hit[0])
        sc.append(hit[1])
        lv.append(levels)
        ng.append(n_groups)
    counts = [len(t) for t in g[1:]]
    width = 4 if kind == "deep" else 2
    k = min(index.num_docs, (req.top if req.top is not None else 10) + (req.skip or 0))
    return _Query(
        qi, k, np.concatenate(g), np.concatenate(sc),
        np.repeat(np.array(lv, np.int64).reshape(-1, width), counts, axis=0),
        np.repeat(np.array(ng, np.int64), counts),
        1 if kind == "deep" else len(shape),
    )


def _slot_keys(queries, phrase: bool):
    """Pack each term's slot numbering into one int64 key for the batch:
    one bit field per level, outermost highest, counting down, so ascending
    keys are the reference's slot-descending order. With ``phrase``, the
    phrase pseudo-rows get the key of one outermost value past every real
    one: it sorts first, as the reference's ``_PHRASE_SLOT`` does, in a
    group (deep: a term) of its own. Returns (keys [T], slot_bits, shifts
    of the levels above the innermost, the phrase rows' key or None)."""
    levels = np.concatenate([q.levels for q in queries])
    if phrase:
        top = np.zeros((1, levels.shape[1]), np.int64)
        top[0, 0] = int(levels[:, 0].max(initial=-1)) + 1
        levels = np.concatenate([levels, top])
    bits = [int(m).bit_length() for m in levels.max(axis=0)] if len(levels) else [0] * levels.shape[1]
    shifts = [sum(bits[i + 1 :]) for i in range(len(bits))]
    packed = np.zeros(len(levels), np.int64)
    for col, shift in enumerate(shifts):
        packed |= levels[:, col] << shift
    slot_bits = sum(bits)
    keys = ((1 << slot_bits) - 1) - packed
    if phrase:
        return keys[:-1], slot_bits, tuple(shifts[:-1]), int(keys[-1])
    return keys, slot_bits, tuple(shifts[:-1]), None


def _chunks(rows: np.ndarray, max_queries: int):
    """Consecutive query ranges whose gathered rows stay within the budget;
    a query over it goes alone."""
    out, lo, acc = [], 0, 0
    for qi, r in enumerate(rows):
        if qi > lo and (acc + r > _ROW_BUDGET or qi - lo >= max_queries):
            out.append((lo, qi))
            lo, acc = qi, 0
        acc += int(r)
    if lo < len(rows):
        out.append((lo, len(rows)))
    return out


def _emit(request, ids, scores, num_hits, start, facets=None) -> SearchResult:
    """Drop non-positive scores, then window by the request's skip/top."""
    mask = scores > 0
    ids, scores = ids[mask], scores[mask]
    top = request.top if request.top is not None else 10
    skip = request.skip or 0
    res = SearchResult()
    res.num_hits = int(num_hits)
    res.data = [Hit(int(i), float(s)) for i, s in list(zip(ids, scores))[skip : skip + top]]
    res.facets = facets
    res.execution_time_ns = time.time_ns() - start
    return res


def _split(seg, ids, scores, n):
    """Flat per-query rows (grouped by query) -> per-query numpy arrays."""
    seg, ids, scores = seg.cpu().numpy(), ids.cpu().numpy(), scores.cpu().numpy()
    bounds = np.searchsorted(seg, np.arange(n + 1))
    return [(ids[a:b], scores[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


class _Extras(NamedTuple):
    """A generic group's extras: its boost columns (request order), its
    facet fields and, when a query carries one, its distinct filters."""

    boosts: tuple  # _precompute_boost tuples
    facets: tuple  # (field, FacetRelation)
    fmasks: Optional[torch.Tensor]  # [NF, num_docs] bool, or None
    fkey_row: Dict[tuple, int]  # filter tree key -> row of fmasks


def _filter_tree_key(node) -> tuple:
    if node.kind == SEARCH:
        return ("s", node.part.key())
    return (node.kind, tuple(_filter_tree_key(q) for q in node.queries))


def _bounded(index, name: str, limit: int) -> dict:
    """A memo in the index's cache, emptied when it outgrows ``limit``."""
    memo = index.cache.setdefault(name, {})
    if len(memo) > limit:
        memo.clear()
    return memo


def _filter_anchor_list(index, node, fuzzy) -> np.ndarray:
    """The filter's anchors, resolved on the host and memoised per index
    (``_filter_anchor_list``, ``:382``): a leaf's matched ids (all of them,
    before any leaf ``top``) resolved to anchors; an OR their union, an AND
    their intersection."""
    memo = _bounded(index, "filter_anchors", 4096)
    tkey = _filter_tree_key(node)
    hit = memo.get(tkey)
    if hit is not None:
        return hit
    if node.kind == SEARCH:
        ids = match_term_ids(index, node.part, fuzzy)[0]
        anchors = resolve_ids_to_anchor(index, _text_path(node.part.path), ids)
        out = np.unique(anchors[(anchors >= 0) & (anchors < index.num_docs)])
    else:
        out = np.empty(0, dtype=np.int64)
        subs = [_filter_anchor_list(index, q, fuzzy) for q in node.queries]
        if subs:
            out = subs[0]
            for sub in subs[1:]:
                out = np.union1d(out, sub) if node.kind == OR else np.intersect1d(out, sub)
    memo[tkey] = out
    return out


def _filter_mask_device(index, node, fuzzy) -> torch.Tensor:
    """The filter as a ``[num_docs]`` bool mask on the device, built once per
    distinct filter (``_filter_mask_device``, ``:460``)."""
    memo = _bounded(index, "filter_masks", 512)
    tkey = _filter_tree_key(node)
    mask = memo.get(tkey)
    if mask is None:
        anchors = _filter_anchor_list(index, node, fuzzy)
        mask = torch.zeros(index.num_docs, dtype=torch.bool, device=index.device)
        mask[torch.from_numpy(anchors).to(index.device)] = True
        memo[tkey] = mask
    return mask


def _filter_mask_stack(index, nodes: Dict[tuple, object], fuzzy):
    """The distinct filters of a group as one cached ``[NF, num_docs]`` bool
    tensor, rows in a canonical order so that the same set reuses one
    stack, and each filter key's row (``_filter_mask_stack``, ``:427``)."""
    skey = tuple(sorted(nodes, key=repr))
    memo = _bounded(index, "filter_stacks", 128)
    stack = memo.get(skey)
    if stack is None:
        stack = memo[skey] = torch.stack([_filter_mask_device(index, nodes[k], fuzzy) for k in skey])
    return stack, {k: i for i, k in enumerate(skey)}


def _phrase_anchor_list(index, phrase_boosts, fuzzy) -> np.ndarray:
    """Phrase-pair anchors with group multiplicity (``_phrase_anchor_list``,
    ``:650``): per distinct (term1, term2), the anchors of every matched id
    pair, once each; an anchor in g such groups appears g times (factor
    5 ** g)."""
    groups: dict = {}
    for pb in phrase_boosts:
        store = index.phrase_indices.get(_text_path(pb.search1.path) + PHRASE_PAIR_TO_ANCHOR)
        a_ids = match_term_ids(index, pb.search1, fuzzy)[0]
        b_ids = match_term_ids(index, pb.search2, fuzzy)[0]
        if store is None:
            continue
        key = (pb.search1.terms[0], pb.search2.terms[0])
        groups.setdefault(key, []).append(store.get_values_for_pairs(a_ids, b_ids))
    parts = [np.unique(np.concatenate(v).astype(np.int64)) for v in groups.values()]
    out = np.concatenate(parts) if parts else np.empty(0, dtype=np.int64)
    return out[out < index.num_docs]


def _boost_key(boost) -> tuple:
    return (
        _boost_path(boost), boost.boost_fun or "", float(boost.param or 0.0),
        tuple(float(v) for v in boost.skip_when_score or ()), boost.expression or "",
    )


def _boost_factors(index, bkey) -> tuple:
    """One boost column's factor arrays on the device, once per index and
    boost spec (``_boost_device_arrays``, ``:1454``). They are computed on
    the host and uploaded: a logarithm rounds differently on the card and
    on the CPU, and computed once the factors are the same on both, so the
    card's answers equal the CPU path's bit for bit; the logs are numpy's,
    as the reference's host boost (and so its explain) takes them."""
    memo = index.cache.setdefault("boost_factors", {})
    pre = memo.get(bkey)
    if pre is None:
        path, fun, param, skip, expr = bkey
        bv, pres = (t.cpu() for t in index.device_boost(path))
        expr_add = expr_vec(ScoreExpression(expr), bv) if expr else None
        pre = _precompute_boost(bv, pres, (fun, param, skip, expr_add))
        pre = memo[bkey] = _to_device(pre, index.device)
    return pre


def _to_device(obj, device):
    """Every tensor in a nest of tuples, on ``device``."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple):
        return tuple(_to_device(o, device) for o in obj)
    return obj


def _group_extras(index, boost_keys, facet_fields, queries, requests, fuzzy) -> _Extras:
    nodes = {q.fkey: requests[q.qi].filter for q in queries if q.fkey is not None}
    fmasks, fkey_row = _filter_mask_stack(index, nodes, fuzzy) if nodes else (None, {})
    return _Extras(
        tuple(_boost_factors(index, b) for b in boost_keys),
        tuple((f, facet_relation(index, f)) for f in facet_fields),
        fmasks, fkey_row,
    )


def _facets_of(index, request, fields, rows) -> Dict[str, list]:
    """The request's facet lists from its count rows (``_facets_of``, ``:1467``)."""
    return {
        f.field: format_counts(index, f.field, rows[fields.index(f.field)], f.top)
        for f in request.facets
    }


def _answer(index, route, queries, requests, results, start, extras=None) -> None:
    """Answer one route's queries, a chunk of queries per gather and sort;
    ``extras`` (a generic group's) are applied to each chunk's candidates."""
    if not queries:
        return
    dev, ho = index.device, index.host_offsets
    g = np.concatenate([q.gtids for q in queries])
    counts = ho[g + 1] - ho[g]
    t_start = np.cumsum([0] + [len(q.gtids) for q in queries])
    rows = np.concatenate([[0], np.cumsum(counts)])[t_start]
    rows = rows[1:] - rows[:-1]  # gathered rows per query
    index.count_rows(route, int(rows.sum()))
    rows = rows + np.array([len(q.panchors) for q in queries])
    phrase = any(len(q.panchors) for q in queries)
    max_queries = len(queries)
    if route in ("tree", "deep"):
        keys, slot_bits, shifts, phrase_key = _slot_keys(queries, phrase)
        ab = max(1, (index.num_docs - 1).bit_length())
        max_queries = 1 << max(0, 63 - ab - slot_bits)

    def up(arr, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(dev)

    for lo, hi in _chunks(rows, max_queries):
        chunk = queries[lo:hi]
        n = len(chunk)
        sl = slice(t_start[lo], t_start[hi])
        tids, cnt = up(g[sl]), counts[sl]
        tsc = up(np.concatenate([q.scores for q in chunk]), np.float32)
        k = torch.tensor([q.k for q in chunk], dtype=torch.int64, device=dev)
        tq = up(np.repeat(np.arange(n), t_start[lo + 1 : hi + 1] - t_start[lo:hi]))
        facet_rows = ()
        if route == "single":
            (seg, ids, scores), num_hits = batched_single_term_topk(
                index.offsets, index.packed, tids, tsc, cnt, k
            )
        else:
            phrase_rows = None
            if extras is not None:
                # the chunk's small per-query arrays (filter rows, phrase
                # rows) staged in one host buffer, one copy
                frow, pq, pa = _stage(
                    dev, [-1 if q.fkey is None else extras.fkey_row[q.fkey] for q in chunk],
                    [q.panchors for q in chunk],
                )
                if phrase:
                    phrase_rows = (pq, pa, torch.full_like(pa, phrase_key))
            if route == "single_slot":
                seg, a, final = batched_tree_candidates(
                    index.offsets, index.packed, tids, tsc, tq, cnt, index.num_docs
                )
            else:
                deep = route == "deep"
                seg, a, final = batched_tree_candidates(
                    index.offsets, index.packed, tids, tsc, tq, cnt, index.num_docs,
                    term_slots=up(keys[sl]), slot_bits=slot_bits, shifts=shifts,
                    num_groups=None if deep else up([q.num_groups for q in chunk], np.int64),
                    term_ngs=up(np.concatenate([q.ng for q in chunk])) if deep else None,
                    phrase_rows=phrase_rows,
                )
            if extras is not None:
                if extras.fmasks is not None:
                    fr = frow[seg]
                    keep = (fr < 0) | extras.fmasks[fr.clamp(min=0), a]
                    final = torch.where(keep, final, 0.0)
                for pre in extras.boosts:
                    final = _apply_boost_gathered(final, a, pre)
                hit = final > 0
                seg, a, final = seg[hit], a[hit], final[hit]
                facet_rows = [
                    facet_counts(rel, seg, a, n).cpu().numpy() for _f, rel in extras.facets
                ]
            num_hits = torch.bincount(seg, minlength=n)
            seg, ids, scores = segmented_topk(seg, final, a, n, k)
        nh = num_hits.cpu().numpy() if torch.is_tensor(num_hits) else num_hits
        fields = [f for f, _rel in extras.facets] if facet_rows else []
        for row, (q, (i, s), h) in enumerate(zip(chunk, _split(seg, ids, scores, n), nh)):
            req = requests[q.qi]
            facets = _facets_of(index, req, fields, [c[row] for c in facet_rows]) if fields else None
            results[q.qi] = _emit(req, i, s, h, start, facets)


def _stage(dev, frow, panchors):
    """Per query its filter row, and its phrase anchors: one int64 host
    buffer, one copy -> (frow [Q], phrase query [P], phrase anchor [P])."""
    pa = np.concatenate(panchors)
    pq = np.repeat(np.arange(len(panchors)), [len(p) for p in panchors])
    buf = np.concatenate([np.asarray(frow, np.int64), pq, pa]).astype(np.int64)
    flat = torch.from_numpy(buf).to(dev)
    q, p = len(frow), len(pa)
    return flat[:q], flat[q : q + p], flat[q + p :]


class _Plan(NamedTuple):
    """A request's admission: its tree route ("flat", "deep") or
    "executor", the shape the route reads, whether its extras apply, and
    the admission row's key (the executor's fallback reason)."""

    kind: str
    shape: object
    generic: bool
    reason: str


def _plan(request, index) -> _Plan:
    """Admit a request (:data:`_ADMISSION`): ("flat", groups, generic),
    ("deep", subtrees, generic) or ("executor", None, False), with the
    deciding row's key."""
    if request.search_req is None:
        raise InvalidRequestError("search_req is required in search")
    tree = _scan(request.search_req, index)
    route, key = next((route, key) for route, key, predicate, _reason in _ADMISSION
                      if predicate(request, index, tree))
    if route == "executor":
        return _Plan("executor", None, False, key)
    node = _normalize_node(request.search_req)
    generic = route == "generic"
    groups = _node_groups(node)
    if groups is not None:
        return _Plan("flat", groups, generic, key)
    supers = _node_deep(node)
    if supers is not None:
        return _Plan("deep", supers, generic, key)
    return _Plan("executor", None, False, "tree_shape")


def admission_reason(key: str) -> str:
    """What sent a request down the route of :class:`_Plan` ``reason``
    ``key``: its :data:`_ADMISSION` row's text, or the tree shape's."""
    return next((why for _route, k, _p, why in _ADMISSION if k == key),
                "a tree beyond OR(AND(OR)) once flattened")


def _fuzzy_specs(requests):
    """Every fuzzy leaf of the batch's trees, filters and phrase pairs, as
    a prefetch spec (``_prefetch_request_fuzzy``, ``:314-336``)."""
    for req in requests:
        for p in (*req.search_req.walk_parts(), *_extra_parts(req)):
            spec = fuzzy_spec(p)
            if spec is not None:
                yield spec


def _group(index, requests, plans, fuzzy):
    """The admitted requests of a batch resolved (:func:`_resolve`) and
    grouped by route: ``plain`` ``{route: [_Query]}`` for plain trees and
    ``generic`` ``{(route, boost keys, facet fields): [_Query]}`` for trees
    with extras; each request's route is counted."""
    plain = {"single": [], "single_slot": [], "tree": [], "deep": []}
    generic: Dict[tuple, list] = {}  # (route, boost keys, facet fields) -> queries
    memo: dict = {}  # leaf key -> (global term ids, scores), for this batch
    for qi, (req, plan) in enumerate(zip(requests, plans)):
        kind, with_extras = plan.kind, plan.generic
        if kind == "executor":
            continue
        q = _resolve(index, qi, req, plan, fuzzy, memo)
        if kind == "deep":
            route = "deep"
        elif not with_extras and q.num_groups == 1 and len(q.gtids) == 1:
            route = "single"
        elif q.num_groups == 1 and len(np.unique(q.levels[:, 1])) <= 1 and not req.phrase_boosts:
            route = "single_slot"
        else:
            route = "tree"
        if not with_extras:
            plain[route].append(q)
            continue
        q = q._replace(
            fkey=None if req.filter is None else _filter_tree_key(req.filter),
            panchors=_phrase_anchor_list(index, req.phrase_boosts, fuzzy)
            if req.phrase_boosts else q.panchors,
        )
        gkey = (route, tuple(_boost_key(b) for b in req.boost or ()),
                tuple(dict.fromkeys(f.field for f in req.facets or ())))
        generic.setdefault(gkey, []).append(q)
    for route, n in (("batched_single_term", len(plain["single"])),
                     ("batched_tree", len(plain["single_slot"]) + len(plain["tree"])),
                     ("batched_tree_deep", len(plain["deep"])),
                     ("batched_generic", sum(len(v) for v in generic.values()))):
        index.count_path(route, n)
        count_path(route, n)
    return plain, generic


def search_batch(requests: List, index) -> List[SearchResult]:
    """Answer a batch of requests on ``index``'s device. Results equal the
    reference's ``search_batch``: ids, order (score desc, id desc),
    ``num_hits``, facet lists and f32 scores (see :mod:`..ops.tree_step` for
    the sum order of unions of three or more slots). Requests the tree
    routes do not take go to the per-request executor, one at a time.
    With a mesh attached (``TorchIndex.attach_mesh``) the batch is
    answered on it (:func:`..parallel.mesh_executor.search_batch_mesh`).
    ``index`` may be a ``Persistence``: its upload answers
    (:func:`..persistence.as_index`)."""
    from .executor import execute

    index = as_index(index)
    if index.mesh_ctx is not None:
        from ..parallel.mesh_executor import search_batch_mesh

        return search_batch_mesh(requests, index)
    start = time.time_ns()
    plans = [_plan(req, index) for req in requests]
    results: List = [None] * len(requests)
    for qi, (req, plan) in enumerate(zip(requests, plans)):
        if plan.kind == "executor":
            results[qi] = execute(req, index, plan.reason)
    fuzzy = prefetch_fuzzy_matches(
        index, set(_fuzzy_specs([r for r, p in zip(requests, plans) if p.kind != "executor"]))
    )
    plain, generic = _group(index, requests, plans, fuzzy)
    for route, queries in plain.items():
        _answer(index, route, queries, requests, results, start)
    for (route, boost_keys, facet_fields), queries in generic.items():
        extras = _group_extras(index, boost_keys, facet_fields, queries, requests, fuzzy)
        _answer(index, route, queries, requests, results, start, extras)
    for req, plan, res in zip(requests, plans, results):
        if req.why_found and plan.kind != "executor":
            _attach_why_found(index, req, res, fuzzy)
    return results


def _attach_why_found(index, req, res, fuzzy) -> None:
    """A why_found request's metadata on its tree route's result
    (``_why_found_meta``, ``_attach_why_found``, ``:828-868``): each leaf's
    field search again, with its term id hits and texts, then the executor's
    finalisation on the route's top hits."""
    term_id_hits, term_texts = merge_field_hits(
        search_field(index, p, fuzzy, store_term_id_hits=True, store_term_texts=True)
        for p in req.search_req.walk_parts()
    )
    res.why_found_terms = term_texts
    if req.select is not None:
        res.why_found_info = get_why_found(index, [h.id for h in res.data], term_id_hits)
