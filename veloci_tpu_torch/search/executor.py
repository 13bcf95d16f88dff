"""The per-request search: :func:`search` and its dense executor.

Counterpart of ``search`` (``veloci_tpu/search/executor.py:684-920``) and
of the executor pieces it runs: ``_Ctx`` / ``_collect_parts`` (``:58-129``),
``_resolve_leaf_dense`` (``:149``, its device branch), ``_matching_1n_boost``
(``:171``), ``_eval_scores`` (``:189-294``) and ``_eval_ids_device``
(``:317``); reference src/search.rs:143-228.

A request that the batched route admits (:data:`.batch._ADMISSION`) is
answered as a batch of one, as the reference's fused paths answer it
(``:710-736``). Every other request, and every request with
``dense_only``, goes through the dense executor: each search leaf becomes a
``[num_docs]`` f32 plane on ``index.device`` (:func:`..ops.postings.resolve_to_anchor_dense`,
kernel B7 on the card), the tree combines the planes (an OR sums the
per-term maxima in sorted-term order and multiplies by distinct squared, an
AND sums its children, the shortest last, where all of them hit), 1:n
boosts apply at their leaves, then the filter mask, the boost columns, the
phrase factor, ``num_hits`` = the count of scores > 0, the facet counts
over that hit set and the exact top-k. The reference computes these planes
with numpy below ``SMALL_DOCS`` documents; the port has no host branch.

The executor keeps no memo of field searches across requests: each request
runs its own (its fuzzy leaves in one sweep launch per field and kernel,
its regex leaves one DFA walk, kernel B8, per field and matrix). Regex
leaves and leaves that ask for snippets resolve like any other leaf.

:func:`search_to_result_with_doc` reads a result's documents back
(``to_documents``, ``search_to_result_with_doc``, ``:923-963``): with
``select``, each hit's fields are rebuilt from the index's stores
(:func:`.read_document.read_data`); without, the whole document is read
from the document store and highlighted for ``why_found_terms``.
"""

from __future__ import annotations

import json
import time
from typing import List

import numpy as np
import torch

from ..create import PHRASE_PAIR_TO_ANCHOR
from ..error import InvalidRequestError
from ..ops.postings import resolve_to_anchor_dense
from ..ops.topk import topk_dense
from ..query.request import RequestBoostPart, SearchRequest
from . import batch
from .boost import (
    apply_anchor_boost_values_device,
    apply_boost_dense_device,
    boost_to_anchor_values,
    scatter_factor_device,
)
from .facet import get_facet
from .field_search import get_term_ids_in_field, leaf_field, prefetch_fuzzy_matches
from .highlight import highlight_on_original_document
from .read_document import read_data
from .result import DocWithHit, Hit, SearchResult, SearchResultWithDoc

__all__ = ["search", "search_to_result_with_doc", "to_documents"]

SEARCH, OR, AND = SearchRequest.SEARCH, SearchRequest.OR, SearchRequest.AND
_DISTINCT_MIN = float(np.float32(1e-5))  # a union counts a term whose maximum reaches this


class _Ctx:
    """One request's index, fuzzy matches and field-search results."""

    def __init__(self, index, fuzzy):
        self.index = index
        self.fuzzy = fuzzy
        self.num_docs = index.num_docs
        self._fields: dict = {}

    def field_search(self, part):
        """The leaf's scored term ids (its first term only, as the
        reference searches, ``field_search.py:423``), once per leaf key."""
        key = part.key()
        hit = self._fields.get(key)
        if hit is None:
            hit = self._fields[key] = get_term_ids_in_field(self.index, part, self.fuzzy)
        return hit

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.num_docs, dtype=torch.float32, device=self.index.device)


def _option_boosts(options) -> list:
    return [RequestBoostPart.from_dict(b) for b in (options or {}).get("boost") or ()]


def _matching_1n_boost(part, boosts):
    """The 1:n boost whose path shares the leaf's last ``[]`` level
    (plan_creator_search_part, execution_plan.rs:436-470), or None."""
    pos = part.path.rfind("[]")
    if pos < 0 or not boosts:
        return None
    end_obj = part.path[:pos]
    matches = [b for b in boosts if b.path.rfind("[]") >= 0 and b.path[: b.path.rfind("[]")] == end_obj]
    if len(matches) > 1:
        raise InvalidRequestError("multiple 1:n boosts match a single field")
    return matches[0] if matches else None


def _union(ctx, children):
    """union_hits_score (set_op.rs:87-220): per distinct representative
    term its children's maximum, the maxima summed in sorted-term order,
    times distinct squared (distinct: maxima >= 1e-5)."""
    total = ctx.zeros()
    distinct = torch.zeros(ctx.num_docs, dtype=torch.int32, device=ctx.index.device)
    for term in sorted({t for _d, t, _p in children}):
        vecs = [d for d, t, _p in children if t == term]
        mx = vecs[0]
        for v in vecs[1:]:
            mx = torch.maximum(mx, v)
        total = total + mx
        distinct = distinct + (mx >= _DISTINCT_MIN).to(torch.int32)
    df = distinct.to(torch.float32)
    return total * df * df


def _intersect(ctx, children):
    """intersect_hits_score (set_op.rs:368-448): where every child hits, the
    children summed in child order, the one with the fewest hits (the first
    such) added last."""
    hit = [d > 0 for d, _t, _p in children]
    mask = hit[0]
    for h in hit[1:]:
        mask = mask & h
    shortest = int(np.argmin(torch.stack([h.sum() for h in hit]).cpu().numpy()))
    total = ctx.zeros()
    for i, (d, _t, _p) in enumerate(children):
        if i != shortest:
            total = total + d
    total = total + children[shortest][0]
    return torch.where(mask, total, 0.0)


def _eval_scores(ctx, node, boosts):
    """The tree -> (plane, representative term, representative path): a
    child's representative is its leftmost leaf's first term."""
    if node.kind == SEARCH:
        part = node.part
        ids, scores = ctx.field_search(part)
        dense = resolve_to_anchor_dense(ctx.index, leaf_field(part), ids, scores)
        b1n = _matching_1n_boost(part, list(boosts) + _option_boosts(part.options))
        if b1n is not None:
            anchors, values = boost_to_anchor_values(ctx.index, part.path, b1n, ids)
            dense = apply_anchor_boost_values_device(dense, anchors, values, b1n)
        return dense, part.terms[0], part.path
    # node-level option boosts join the subtree's (merge_vec, execution_plan.rs:268-275)
    sub_boosts = list(boosts) + _option_boosts(node.options)
    children = [_eval_scores(ctx, q, sub_boosts) for q in node.queries]
    if not children:
        return ctx.zeros(), "", ""
    if len(children) == 1:
        return children[0]
    if node.kind == OR:
        dense = _union(ctx, children)
    elif node.kind == AND:
        dense = _intersect(ctx, children)
    else:
        raise InvalidRequestError(f"unknown node kind {node.kind}")
    return dense, children[0][1], children[0][2]


def _phrase_boost(ctx, phrase_boosts, dense):
    """The phrase factor (plan_steps.rs:237-283): 5 ** g at an anchor in g
    distinct (term1, term2) groups (:func:`.batch._phrase_anchor_list`);
    then, where a field has phrase pairs, only hits stay."""
    if any(pb.search1.path != pb.search2.path for pb in phrase_boosts):
        raise InvalidRequestError("phrase boost paths must match")
    if not any(_phrase_store(ctx.index, pb) is not None for pb in phrase_boosts):
        return dense
    anchors = batch._phrase_anchor_list(ctx.index, phrase_boosts, ctx.fuzzy)
    return torch.where(dense > 0, scatter_factor_device(dense, anchors, 5.0), 0.0)


def _phrase_store(index, pb):
    return index.phrase_indices.get(batch._text_path(pb.search1.path) + PHRASE_PAIR_TO_ANCHOR)


def _execute(request, index, start) -> SearchResult:
    """The dense executor (``search``, ``:758-920``)."""
    index.path_counts["executor"] += 1
    fuzzy = prefetch_fuzzy_matches(index, set(batch._fuzzy_specs([request])))
    ctx = _Ctx(index, fuzzy)
    boosts = list(request.boost or ())
    dense, _term, _path = _eval_scores(ctx, request.search_req, boosts)
    if request.filter is not None:
        dense = torch.where(batch._filter_mask_device(index, request.filter, fuzzy), dense, 0.0)
    for b in boosts:  # boost columns at anchors (execution_plan.rs:168-183)
        if "[]" not in b.path:
            dense = apply_boost_dense_device(dense, batch._boost_factors(index, batch._boost_key(b)))
    if request.phrase_boosts:
        dense = _phrase_boost(ctx, request.phrase_boosts, dense)
    result = SearchResult()
    result.num_hits = int((dense > 0).sum())
    if request.facets:
        result.facets = {f.field: get_facet(index, f, dense) for f in request.facets}
    top = request.top if request.top is not None else 10
    skip = request.skip or 0
    ids, scores = topk_dense(dense, top + skip)
    ids, scores = ids[skip:].cpu().numpy(), scores[skip:].cpu().numpy()
    result.data = [Hit(int(i), float(s)) for i, s in zip(ids, scores)]
    result.execution_time_ns = time.time_ns() - start
    return result


def search(request, index, dense_only: bool = False) -> SearchResult:
    """Answer one request on ``index``'s device (``search``, ``:684``).

    A request the batched route admits is answered as
    ``search_batch([request], index)[0]``; the rest, and every request when
    ``dense_only`` is set, by the dense executor. Shapes outside the port
    raise ``NotImplementedError`` naming their ROADMAP item (``boost_term``,
    ``text_locality``, ``why_found``, ``explain`` and ``suggest``: A13)."""
    start = time.time_ns()
    if batch._plan(request, index)[0] != "executor" and not dense_only:
        return batch.search_batch([request], index)[0]
    return _execute(request, index, start)


def to_documents(index, hits: List[Hit], select, result: SearchResult) -> List[DocWithHit]:
    """Each hit with its document (``to_documents``, ``:923``; reference
    src/search.rs:65-102): the ``select`` fields rebuilt from the index, or
    the whole stored document, highlighted for the result's
    ``why_found_terms``."""
    tokens_set = {path: set(terms) for path, terms in result.why_found_terms.items()}
    docs = []
    for hit in hits:
        if select is not None:
            docs.append(DocWithHit(doc=read_data(index, hit.id, select), hit=hit,
                                   explain=result.explain.get(hit.id),
                                   why_found=result.why_found_info.get(hit.id, {})))
        else:
            doc = json.loads(index.doc_loader.get_doc(hit.id))
            why = highlight_on_original_document(index, doc, tokens_set)
            docs.append(DocWithHit(doc=doc, hit=hit, explain=result.explain.get(hit.id), why_found=why))
    return docs


def search_to_result_with_doc(index, result: SearchResult, select=None) -> SearchResultWithDoc:
    """A result with its hits' documents (``search_to_result_with_doc``,
    ``:952``; reference search::to_search_result, src/search.rs:104-111)."""
    return SearchResultWithDoc(
        data=to_documents(index, result.data, select, result),
        num_hits=result.num_hits,
        facets=result.facets,
        execution_time_ns=result.execution_time_ns,
    )
