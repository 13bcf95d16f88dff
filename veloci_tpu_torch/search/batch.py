"""Batched serving for trees of exact, fuzzy and ``starts_with`` leaves.

Counterpart of ``search_batch`` (``veloci_tpu/search/batch.py:983-1177``) for
the requests its plain routes take (``_plain_eligible``, ``:686-712``): a
tree that is one search leaf, a flat OR, a flat AND or an AND of ORs
(``_node_groups``, ``:108``), or an OR whose children are leaves and such
ANDs (``_node_deep``, ``:198``), after the redundant nesting is flattened
(``_normalize_node``, ``:177``). Leaves hold one term, exact or fuzzy at any
distance, with or without ``starts_with``.

The batch's fuzzy leaves get their matches from one sweep launch per field
and kernel (``_prefetch_request_fuzzy``, ``:297-336``). Then each request
takes one route, as in the reference (``:1030-1068``): a tree that resolves
to ONE term reads that term's posting run ("singles"); a tree of one group
whose matched terms share one slot takes the single-slot evaluator; other
two-level trees the tree evaluator, and OR-of-AND trees its deep form.
Results are windowed as ``_make_emit`` does (``:870-891``).

The reference sends a request past its caps (leaf term counts, slots,
groups, sort capacity) to its per-request executor; here every admitted
request is answered on its tree route, and a batch whose gathered posting
rows exceed ``_ROW_BUDGET`` is split into several sorts. Every other request
shape raises ``NotImplementedError`` naming the ROADMAP item that brings
it; no request falls through to another engine.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple

import numpy as np
import torch

from ..error import InvalidRequestError
from ..query.request import SearchRequest
from ..ops.search_step import batched_single_term_topk
from ..ops.tree_step import batched_tree_topk, batched_tree_topk_single_slot
from .field_search import (
    clamped_distance,
    get_term_ids_in_field,
    leaf_field,
    prefetch_fuzzy_matches,
)
from .result import Hit, SearchResult

__all__ = ["search_batch"]

SEARCH, OR, AND = SearchRequest.SEARCH, SearchRequest.OR, SearchRequest.AND

# gathered posting rows per sort: bounds the device memory of one sort
# (about 64 bytes a row across the key, score, order and run arrays)
_ROW_BUDGET = 1 << 23

# request-level features outside the slice -> the ROADMAP item bringing them
_REQUEST_FEATURES = (
    ("filter", "A6 (generic batched route)"),
    ("boost", "A6 (generic batched route)"),
    ("facets", "A6 (generic batched route)"),
    ("phrase_boosts", "A6 (generic batched route)"),
    ("boost_term", "A7 (per-request executor)"),
    ("why_found", "A7 (per-request executor)"),
    ("text_locality", "A7 (per-request executor)"),
    ("explain", "A7 (per-request executor)"),
    ("suggest", "A7 (per-request executor)"),
)


def _unsupported(what: str, item: str):
    return NotImplementedError(
        f"{what} is outside the port's current slice; see ROADMAP.md {item}"
    )


def _check_tree(node) -> None:
    """Raise for leaves and nodes the tree routes do not take (``_leaf_ok``,
    ``:52``)."""
    if node.kind != SEARCH:
        if node.options:
            raise _unsupported("tree node options", "A7 (per-request executor)")
        for q in node.queries:
            _check_tree(q)
        return
    part = node.part
    if len(part.terms) != 1:
        raise _unsupported("a leaf with several terms", "A7 (per-request executor)")
    if part.is_regex:
        raise _unsupported("a regex leaf", "A8 (regex prefilter)")
    if part.snippet or part.options:
        raise _unsupported("leaf snippets and options", "A7 (per-request executor)")
    if part.token_value is not None:
        raise _unsupported("a token-value boost", "A6 (generic batched route)")


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


def _resolve(index, qi, req, plan, fuzzy, memo) -> _Query:
    kind, shape = plan
    leaves = _leaf_slots(shape) if kind == "deep" else _group_slots(shape)
    g, sc, lv, ng = [np.empty(0, np.int64)], [np.empty(0, np.float32)], [], []
    for part, levels, n_groups in leaves:
        key = part.key()
        hit = memo.get(key)
        if hit is None:
            ids, scores = get_term_ids_in_field(index, part, fuzzy)
            field = leaf_field(part)
            if field not in index.key_base:
                raise _unsupported(f"field {field!r} without postings", "A7 (per-request executor)")
            base, nk = index.key_base[field]
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


def _slot_keys(queries):
    """Pack each term's slot numbering into one int64 key for the batch:
    one bit field per level, outermost highest, counting down, so ascending
    keys are the reference's slot-descending order. Returns (keys [T],
    slot_bits, shifts of the levels above the innermost)."""
    levels = np.concatenate([q.levels for q in queries])
    bits = [int(m).bit_length() for m in levels.max(axis=0)] if len(levels) else [0] * levels.shape[1]
    shifts = [sum(bits[i + 1 :]) for i in range(len(bits))]
    packed = np.zeros(len(levels), np.int64)
    for col, shift in enumerate(shifts):
        packed |= levels[:, col] << shift
    slot_bits = sum(bits)
    return ((1 << slot_bits) - 1) - packed, slot_bits, tuple(shifts[:-1])


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


def _emit(request, ids, scores, num_hits, start) -> SearchResult:
    """Drop non-positive scores, then window by the request's skip/top."""
    mask = scores > 0
    ids, scores = ids[mask], scores[mask]
    top = request.top if request.top is not None else 10
    skip = request.skip or 0
    res = SearchResult()
    res.num_hits = int(num_hits)
    res.data = [Hit(int(i), float(s)) for i, s in list(zip(ids, scores))[skip : skip + top]]
    res.execution_time_ns = time.time_ns() - start
    return res


def _split(seg, ids, scores, n):
    """Flat per-query rows (grouped by query) -> per-query numpy arrays."""
    seg, ids, scores = seg.cpu().numpy(), ids.cpu().numpy(), scores.cpu().numpy()
    bounds = np.searchsorted(seg, np.arange(n + 1))
    return [(ids[a:b], scores[a:b]) for a, b in zip(bounds[:-1], bounds[1:])]


def _answer(index, route, queries, requests, results, start) -> None:
    """Answer one route's queries, a chunk of queries per gather and sort."""
    if not queries:
        return
    dev, ho = index.device, index.host_offsets
    g = np.concatenate([q.gtids for q in queries])
    counts = ho[g + 1] - ho[g]
    t_start = np.cumsum([0] + [len(q.gtids) for q in queries])
    rows = np.concatenate([[0], np.cumsum(counts)])[t_start]
    rows = rows[1:] - rows[:-1]  # gathered rows per query
    index.gathered_rows[route] += int(rows.sum())
    max_queries = len(queries)
    if route in ("tree", "deep"):
        keys, slot_bits, shifts = _slot_keys(queries)
        ab = max(1, (index.num_docs - 1).bit_length())
        max_queries = 1 << max(0, 63 - ab - slot_bits)

    def up(arr, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(dev)

    for lo, hi in _chunks(rows, max_queries):
        chunk = queries[lo:hi]
        sl = slice(t_start[lo], t_start[hi])
        tids, cnt = up(g[sl]), counts[sl]
        tsc = up(np.concatenate([q.scores for q in chunk]), np.float32)
        k = torch.tensor([q.k for q in chunk], dtype=torch.int64, device=dev)
        tq = up(np.repeat(np.arange(len(chunk)), t_start[lo + 1 : hi + 1] - t_start[lo:hi]))
        if route == "single":
            (seg, ids, scores), num_hits = batched_single_term_topk(
                index.offsets, index.packed, tids, tsc, cnt, k
            )
        elif route == "single_slot":
            (seg, ids, scores), num_hits = batched_tree_topk_single_slot(
                index.offsets, index.packed, tids, tsc, tq, cnt, len(chunk), index.num_docs, k
            )
        else:
            deep = route == "deep"
            (seg, ids, scores), num_hits = batched_tree_topk(
                index.offsets, index.packed, tids, tsc, tq, up(keys[sl]), cnt, len(chunk),
                index.num_docs, k, slot_bits=slot_bits, shifts=shifts,
                num_groups=None if deep else up([q.num_groups for q in chunk], np.int64),
                term_ngs=up(np.concatenate([q.ng for q in chunk])) if deep else None,
            )
        nh = num_hits.cpu().numpy() if torch.is_tensor(num_hits) else num_hits
        for q, (i, s), n in zip(chunk, _split(seg, ids, scores, len(chunk)), nh):
            results[q.qi] = _emit(requests[q.qi], i, s, n, start)


def _plan(request):
    """Admit a request: ("flat", groups) or ("deep", subtrees), or raise for
    shapes outside the slice."""
    if request.search_req is None:
        raise InvalidRequestError("search_req is required in search")
    for attr, item in _REQUEST_FEATURES:
        if getattr(request, attr):
            raise _unsupported(f"request {attr!r}", item)
    _check_tree(request.search_req)
    node = _normalize_node(request.search_req)
    groups = _node_groups(node)
    if groups is not None:
        return "flat", groups
    supers = _node_deep(node)
    if supers is not None:
        return "deep", supers
    raise _unsupported("a tree beyond OR(AND(OR))", "A7 (per-request executor)")


def search_batch(requests: List, index) -> List[SearchResult]:
    """Answer a batch of tree requests on ``index``'s device. Results equal
    the reference's ``search_batch``: ids, order (score desc, id desc),
    ``num_hits`` and f32 scores (see :mod:`..ops.tree_step` for the sum
    order of unions of three or more slots)."""
    start = time.time_ns()
    plans = [_plan(req) for req in requests]
    fuzzy = prefetch_fuzzy_matches(
        index,
        {
            (leaf_field(p), p.terms[0].lower(), clamped_distance(p), bool(p.starts_with))
            for req in requests
            for p in req.search_req.walk_parts()
            if clamped_distance(p) > 0
        },
    )

    routes = {"single": [], "single_slot": [], "tree": [], "deep": []}
    memo: dict = {}  # leaf key -> (global term ids, scores), for this batch
    for qi, (req, plan) in enumerate(zip(requests, plans)):
        q = _resolve(index, qi, req, plan, fuzzy, memo)
        if plan[0] == "deep":
            route = "deep"
        elif q.num_groups == 1 and len(q.gtids) == 1:
            route = "single"
        elif q.num_groups == 1 and len(np.unique(q.levels[:, 1])) <= 1:
            route = "single_slot"
        else:
            route = "tree"
        routes[route].append(q)
    index.path_counts["batched_single_term"] += len(routes["single"])
    index.path_counts["batched_tree"] += len(routes["single_slot"]) + len(routes["tree"])
    index.path_counts["batched_tree_deep"] += len(routes["deep"])

    results: List = [None] * len(requests)
    for route, queries in routes.items():
        _answer(index, route, queries, requests, results, start)
    return results
