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
phrase factor, the ``boost_term`` factor (B10, :func:`.boost.term_boost_factor_device`)
and the text-locality factor (``:836-868``), ``num_hits`` = the count of
scores > 0, the facet counts over that hit set and the exact top-k; with
``why_found``, the leaves' matched terms and, with ``select``, the top
hits' highlighted texts (:mod:`.why_found`); with ``explain``, on the
request or in a leaf's options, each top hit's entries
(:mod:`.explain`): the OR nodes keep their children's planes and each 1:n
or column boost its old and new plane, on the device, and the entries read
them at the hits only. The reference computes these planes with numpy
below ``SMALL_DOCS`` documents, and always with explain; the port has no
host branch, and its device planes give the host's bits (the boosts' logs
and sums are taken on the host).

:func:`explain_plan` renders the plan as graphviz text, the reference's,
with a ``path`` node that names the port's route and kernels.

The executor keeps no memo of field searches across requests: each request
runs its own (its fuzzy leaves, and its ``boost_term`` parts not cached yet,
in one sweep launch per field and kernel, its regex leaves one DFA walk,
kernel B8, per field and matrix). A ``boost_term`` part's anchors are cached
per index (``TorchIndex.term_boost_cache``), as the reference's are. Regex
leaves and leaves that ask for snippets resolve like any other leaf.

:func:`search_to_result_with_doc` reads a result's documents back
(``to_documents``, ``search_to_result_with_doc``, ``:923-963``): with
``select``, each hit's fields are rebuilt from the index's stores
(:func:`.read_document.read_data`); without, the whole document is read
from the document store and highlighted for ``why_found_terms``.

:func:`suggest` and :func:`suggest_batch` answer suggest requests
(``_suggest_fast``, ``suggest_batch``, ``suggest``, ``:966-1127``).
"""

from __future__ import annotations

import bisect
import json
import time
from typing import List

import numpy as np
import torch

from ..create import PHRASE_PAIR_TO_ANCHOR
from ..error import FstNotFoundError, InvalidRequestError, VelociError
from ..ops.postings import resolve_to_anchor_dense
from ..ops.topk import topk_dense
from ..persistence import as_index
from ..query.request import RequestBoostPart, SearchRequest
from ..trace import debug_time, info_time
from . import batch
from .boost import (
    apply_anchor_boost_values_device,
    apply_boost_dense_device,
    boost_to_anchor_values,
    scatter_factor_device,
    term_boost_anchors,
    term_boost_factor_device,
    text_locality_boost,
)
from .explain import BoostRecord, ExplainNode, collect_explain
from .facet import get_facet
from .field_search import (
    clamped_distance,
    fuzzy_spec,
    leaf_field,
    prefetch_fuzzy_matches,
    regex_dfa,
    search_field,
    sweep_kernel,
    sweep_launches,
)
from .highlight import highlight_on_original_document
from .read_document import read_data
from .result import DocWithHit, Hit, SearchResult, SearchResultWithDoc
from .stats import count_fallback, count_path
from .why_found import get_why_found, merge_field_hits

__all__ = ["execute", "explain_plan", "search", "search_to_result_with_doc", "suggest", "suggest_batch",
           "to_documents"]

SEARCH, OR, AND = SearchRequest.SEARCH, SearchRequest.OR, SearchRequest.AND
_F32 = np.float32
_DISTINCT_MIN = float(np.float32(1e-5))  # a union counts a term whose maximum reaches this


class _Ctx:
    """One request's index, fuzzy matches and field-search results, and,
    when it asks for explain, the boost applications its entries read."""

    def __init__(self, index, fuzzy, request):
        self.index = index
        self.fuzzy = fuzzy
        self.num_docs = index.num_docs
        # the tree's metadata, as the reference collects it (:107-118)
        self.store_hits = bool(request.why_found or request.text_locality)
        self.store_texts = bool(request.why_found)
        self._fields: dict = {}
        self.explain = _wants_explain(request)
        self.boost_log: List[BoostRecord] = []

    def field_search(self, part):
        """The leaf's field search (its first term only, as the reference
        searches, ``field_search.py:423``), once per leaf key."""
        key = part.key()
        hit = self._fields.get(key)
        if hit is None:
            hit = self._fields[key] = search_field(
                self.index, part, self.fuzzy, store_term_id_hits=self.store_hits,
                store_term_texts=self.store_texts)
        return hit

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.num_docs, dtype=torch.float32, device=self.index.device)


def _wants_explain(request) -> bool:
    """``explain`` on the request or in any leaf's options turns it on for
    the whole request (``:740-743``)."""
    return bool(request.explain) or any(
        p.options and p.options.get("explain") for p in request.search_req.walk_parts())


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
    for term in sorted({c[1] for c in children}):
        vecs = [c[0] for c in children if c[1] == term]
        mx = vecs[0]
        for v in vecs[1:]:
            mx = torch.maximum(mx, v)
        total = total + mx
        distinct = distinct + (mx >= _DISTINCT_MIN).to(torch.int32)
    df = distinct.to(torch.float32)
    return total * df * df


def _intersect(ctx, children, shortest=None):
    """intersect_hits_score (set_op.rs:368-448): where every child hits, the
    children summed in child order, the one with the fewest hits (the first
    such, or child ``shortest`` when the caller counted them) added last."""
    hit = [c[0] > 0 for c in children]
    mask = hit[0]
    for h in hit[1:]:
        mask = mask & h
    if shortest is None:
        shortest = int(np.argmin(torch.stack([h.sum() for h in hit]).cpu().numpy()))
    total = ctx.zeros()
    for i, c in enumerate(children):
        if i != shortest:
            total = total + c[0]
    total = total + children[shortest][0]
    return torch.where(mask, total, 0.0)


def _eval_scores(ctx, node, boosts):
    """The tree -> (plane, representative term, representative path,
    explain node or None): a child's representative is its leftmost leaf's
    first term. With explain, a leaf's 1:n boost records its application."""
    if node.kind == SEARCH:
        with debug_time("execute.leaves"):
            return _eval_leaf(ctx, node.part, boosts)
    # node-level option boosts join the subtree's (merge_vec, execution_plan.rs:268-275)
    sub_boosts = list(boosts) + _option_boosts(node.options)
    children = [_eval_scores(ctx, q, sub_boosts) for q in node.queries]
    if not children:
        return ctx.zeros(), "", "", None
    if len(children) == 1:
        return children[0]
    enode = None
    if node.kind == OR:
        with debug_time("execute.combine"):
            dense = _union(ctx, children)
        if ctx.explain:
            enode = ExplainNode("or", children=[c[3] for c in children], planes=[c[0] for c in children],
                                terms=[c[1] for c in children])
    elif node.kind == AND:
        with debug_time("execute.combine"):
            dense = _intersect(ctx, children)
        if ctx.explain:
            enode = ExplainNode("and", children=[c[3] for c in children])
    else:
        raise InvalidRequestError(f"unknown node kind {node.kind}")
    return dense, children[0][1], children[0][2], enode


def _eval_leaf(ctx, part, boosts):
    """A leaf's plane, as :func:`_eval_scores` returns it."""
    fsr = ctx.field_search(part)
    ids = fsr.term_ids
    dense = resolve_to_anchor_dense(ctx.index, leaf_field(part), ids, fsr.term_scores)
    b1n = _matching_1n_boost(part, list(boosts) + _option_boosts(part.options))
    if b1n is not None:
        anchors, values = boost_to_anchor_values(ctx.index, part.path, b1n, ids)
        old = dense
        dense = apply_anchor_boost_values_device(dense, anchors, values, b1n, host_sums=ctx.explain)
        if ctx.explain:
            ctx.boost_log.append(BoostRecord(old, dense, ("ratio", None) if b1n.boost_fun == "Log10" else None))
    enode = ExplainNode("leaf", fsr=fsr) if ctx.explain else None
    return dense, part.terms[0], part.path, enode


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


def execute(request, index, reason: str) -> SearchResult:
    """The dense executor (``search``, ``:758-920``): ``reason`` is why the
    request came here, counted as its fallback in :mod:`.stats`."""
    start = time.time_ns()
    index.count_path("executor")
    count_fallback(reason)
    boost_terms = list(request.boost_term or ())
    with debug_time("execute.leaves"):
        # the tree's, the filter's and the phrase pairs' fuzzy leaves in one
        # prefetch, with the boost_term parts' not cached yet, to share its
        # launch (term_boost_anchors sweeps any it still misses)
        specs = set(batch._fuzzy_specs([request]))
        uncached = [p for p in boost_terms if p.key() not in index.term_boost_cache]
        specs.update(s for s in map(fuzzy_spec, uncached) if s is not None)
        fuzzy = prefetch_fuzzy_matches(index, specs)
    ctx = _Ctx(index, fuzzy, request)
    boosts = list(request.boost or ())
    dense, _term, _path, enode = _eval_scores(ctx, request.search_req, boosts)
    with debug_time("execute.combine"):
        if request.filter is not None:
            dense = torch.where(batch._filter_mask_device(index, request.filter, fuzzy), dense, 0.0)
        for b in boosts:  # boost columns at anchors (execution_plan.rs:168-183)
            if "[]" not in b.path:
                old = dense
                dense = apply_boost_dense_device(dense, batch._boost_factors(index, batch._boost_key(b)))
                if ctx.explain:  # Log10 explains its factor, log10(value + param), too
                    log10 = (("column", (index.get_boost(batch._boost_path(b))[0], _F32(b.param or 0.0)))
                             if b.boost_fun == "Log10" else None)
                    ctx.boost_log.append(BoostRecord(old, dense, log10))
        if request.phrase_boosts:
            dense = _phrase_boost(ctx, request.phrase_boosts, dense)
    result = SearchResult()
    with debug_time("execute.extras"):
        term_id_hits, term_texts = merge_field_hits(map(ctx.field_search, request.search_req.walk_parts()))
        if boost_terms:  # boost.rs:89-196
            dense = dense * term_boost_factor_device(
                index, boost_terms, term_boost_anchors(index, boost_terms, fuzzy))
        if request.text_locality:  # boost.rs:11-87, a host factor uploaded once
            factor = text_locality_boost(index, term_id_hits, ctx.num_docs)
            dense = dense * torch.from_numpy(factor).to(index.device)
        result.why_found_terms = term_texts
        result.num_hits = int((dense > 0).sum())
        if request.facets:
            result.facets = {f.field: get_facet(index, f, dense) for f in request.facets}
    top = request.top if request.top is not None else 10
    skip = request.skip or 0
    with debug_time("execute.topk"):
        # topk_dense selects over the plane's hits, whose count the host holds
        index.count_sorted("executor", result.num_hits)
        ids, scores = topk_dense(dense, top + skip)
        ids, scores = ids[skip:].cpu().numpy(), scores[skip:].cpu().numpy()
    with debug_time("execute.emit"):
        result.data = [Hit(int(i), float(s)) for i, s in zip(ids, scores)]
        if request.why_found and request.select is not None:
            result.why_found_info = get_why_found(index, [h.id for h in result.data], term_id_hits)
        if ctx.explain:
            result.explain = collect_explain(index, enode, [h.id for h in result.data], ctx.boost_log)
    result.execution_time_ns = time.time_ns() - start
    return result


def search(request, index, dense_only: bool = False) -> SearchResult:
    """Answer one request on ``index``'s device (``search``, ``:684``).

    A request the batched route admits is answered as
    ``search_batch([request], index)[0]``; the rest, and every request when
    ``dense_only`` is set, by the dense executor (:func:`execute`), which
    answers ``explain``, on the request or a leaf, too. With a mesh
    attached (``TorchIndex.attach_mesh``) every request but those that ask
    for ``explain`` or carry ``suggest`` is answered on the mesh
    (:func:`..parallel.mesh_executor.mesh_search`, ``:699-707``).

    ``index`` is a :class:`..persistence.TorchIndex` or a ``Persistence``,
    which answers on its upload (:func:`..persistence.as_index`). The call
    runs inside ``info_time("search")`` (``:737``): with the log at info
    (:func:`..trace.enable_log`), one ``search took`` line a call."""
    index = as_index(index)
    with info_time("search"):
        if index.mesh_ctx is not None and not (_wants_explain(request) or request.suggest):
            from ..parallel.mesh_executor import mesh_search

            count_path("mesh_per_request")
            return mesh_search(request, index, dense_only)
        with debug_time("search.plan"):
            plan = batch._plan(request, index)
        if plan.kind != "executor" and not dense_only:
            return batch._search_batch([request], index)[0]
        return execute(request, index, plan.reason if plan.kind == "executor" else "dense_only")


def _plan_parts(request):
    """The request's distinct field searches in the reference's collection
    order, each with the flags its plan node shows (``_collect_parts``,
    ``:108-126``): ``{part key: (part, the set of "scores", "ids",
    "term_hits")}``."""
    parts: dict = {}

    def register(part, *flags):
        _part, on = parts.setdefault(part.key(), (part, set()))
        on.update(f for f, want in flags if want)

    store_hits = bool(request.why_found or request.text_locality)
    for part in request.search_req.walk_parts():
        register(part, ("scores", True), ("term_hits", store_hits))
    for pb in request.phrase_boosts or ():
        register(pb.search1, ("ids", True), ("scores", True))
        register(pb.search2, ("ids", True), ("scores", True))
    if request.filter is not None:
        for part in request.filter.walk_parts():
            register(part, ("ids", True))
    return parts


_SWEEP_NAMES = {"select": "B2 fused select", "banded": "B1 banded sweep", "full": "B3 full-width sweep"}


def _route_label(request, index) -> str:
    """The port's route for the request (:func:`.batch._plan`, with the
    admission row's key) and the kernels it launches, read from the same
    decisions the search makes, without device work: each sweep launch of
    the fuzzy prefetch (:func:`.field_search.sweep_launches`,
    :func:`.field_search.sweep_kernel`), B8 for a regex leaf with a DFA
    (:func:`.field_search.regex_dfa`; B3 for its distances), B7 for the
    executor's leaves. On an index on the CPU the kernels' plain versions
    run instead."""
    plan = batch._plan(request, index)
    parts = (*request.search_req.walk_parts(), *batch._extra_parts(request))
    kernels = [f"{field}: {_SWEEP_NAMES[sweep_kernel(items)]}"
               for (field, _full), items in sweep_launches(batch._fuzzy_specs([request])).items()]
    regex = [p for p in parts if p.is_regex]
    if any(regex_dfa(p)[1] is not None for p in regex):
        kernels.append("B8 DFA walk and B3 distances (regex leaves)")
    if any(regex_dfa(p)[1] is None for p in regex):
        kernels.append("re scan on the host (regex leaves without a DFA)")
    why = f"{plan.reason}: {batch.admission_reason(plan.reason)}"
    if plan.kind == "executor":
        route = f"dense executor ({why}); a [num_docs] plane a leaf"
        kernels.append("B7 dense resolve")
    elif plan.kind == "deep":
        route = f"deep tree ({why}); the sorted-run deep evaluator"
    else:
        route = f"flat tree ({why}); singles when one term matches, else the sorted-run tree evaluator"
    mc = index.mesh_ctx
    if mc is not None and not (_wants_explain(request) or request.suggest):  # as search() dispatches
        tree = "a dense executor" if plan.kind == "executor" else "the dense tree evaluator"
        route = (f"mesh ({mc.q} x {mc.d} [q, d] grid, {mc.d} document shards, top-k merged on the lead "
                 f"device; {tree} on each shard's plane); admission: {why}")
        kernels = [f"{k} on each shard's length window" if ": B" in k else k for k in kernels]
        if "B7 dense resolve" not in kernels:
            kernels.append("B7 dense resolve")
    device = "" if index.device.type == "cuda" else f" (plain versions on {index.device.type})"
    return f"{route}; kernels{device}: {', '.join(kernels) or 'none'}"


def explain_plan(request, index) -> str:
    """The plan as graphviz dot (``explain_plan``, ``:1132-1308``; reference
    plan.rs:81-125): the deduplicated field searches with their flags and
    reuse counts, the 1:n boost splits, the filter mask, the boost,
    phrase, ``term_boost``, ``text_locality`` and facet nodes and the
    result node, as the reference renders them; its ``path`` node names
    the port's route and kernels (:func:`_route_label`). No device work
    beyond a ``Persistence``'s upload."""
    index = as_index(index)
    if request.search_req is None:
        raise InvalidRequestError("search_req is required in search")
    lines = ["digraph plan {"]
    parts = _plan_parts(request)
    refs: dict = {}
    for node in (request.search_req, request.filter):
        for part in node.walk_parts() if node is not None else ():
            refs[part.key()] = refs.get(part.key(), 0) + 1
    for pb in request.phrase_boosts or ():
        for part in (pb.search1, pb.search2):
            refs[part.key()] = refs.get(part.key(), 0) + 1
    lines.append(f'  path [label="execution path: {_route_label(request, index)}", shape=note];')

    fs_name: dict = {}
    for i, (key, (part, on)) in enumerate(parts.items()):
        flags = "+".join(f for f in ("scores", "ids", "term_hits") if f in on)
        reuse = refs.get(key, 1)
        reuse_txt = f", reused x{reuse}" if reuse > 1 else ""
        fs_name[key] = f"fs{i}"
        lines.append(f'  fs{i} [label="field_search {part.path} {part.terms} [{flags}{reuse_txt}]", shape=box];')

    boosts = list(request.boost or ())

    def node_name() -> str:
        return f"n{len(lines)}"

    def walk(node) -> str:
        name = node_name()
        if node.kind == SEARCH:
            fs = fs_name[node.part.key()]
            lines.append(f'  {name} [label="resolve_to_anchor"];')
            lines.append(f"  {fs} -> {name};")
            b1n = _matching_1n_boost(node.part, boosts)
            if b1n is None:
                return name
            bname = node_name()  # the 1:n boost split (execution_plan.rs:439-443)
            lines.append(f'  {bname} [label="boost_to_anchor {b1n.path}"];')
            lines.append(f"  {fs} -> {bname};")
            aname = node_name()
            lines.append(f'  {aname} [label="apply_anchor_boost"];')
            lines.append(f"  {name} -> {aname};")
            lines.append(f"  {bname} -> {aname};")
            return aname
        lines.append(f'  {name} [label="{"union" if node.kind == OR else "intersect"}"];')
        for q in node.queries:
            lines.append(f"  {walk(q)} -> {name};")
        return name

    def step(label: str, *inputs: str) -> str:
        name = node_name()
        lines.append(f'  {name} [label="{label}"];')
        lines.extend(f"  {i} -> {name};" for i in inputs)
        return name

    final = walk(request.search_req)
    if request.filter is not None:
        lines.append('  filter [label="filter mask (computed ONCE, broadcast)", shape=box];')
        lines.extend(f"  {fs_name[p.key()]} -> filter;" for p in request.filter.walk_parts())
        lines.append('  fstep [label="intersect scores with filter mask"];')
        lines.append("  filter -> fstep;")
        lines.append(f"  {final} -> fstep;")
        final = "fstep"
    for b in boosts:
        if "[]" not in b.path:  # a 1:n boost is rendered as its split above
            final = step(f"boost {b.path} {b.boost_fun or b.expression}", final)
    for pb in request.phrase_boosts or ():
        pair = step(f"phrase_pair_to_anchor {pb.search1.terms[0]} {pb.search2.terms[0]}",
                    fs_name[pb.search1.key()], fs_name[pb.search2.key()])
        final = step("boost_anchor_from_phrase", pair, final)
    if request.boost_term:
        final = step("term_boost (LRU-cached anchors)", final)
    if request.text_locality:
        final = step("text_locality_boost", final)
    if request.facets:
        fields = ",".join(f.field for f in request.facets)
        lines.append(f'  facets [label="facet counts ({fields}): masked segment-sum"];')
        lines.append(f"  {final} -> facets;")
    lines.append('  result [label="exact 2-stage top_k + fetch"];')
    lines.append(f"  {final} -> result;")
    lines.append("}")
    return "\n".join(lines)


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
    index = as_index(index)
    return SearchResultWithDoc(
        data=to_documents(index, result.data, select, result),
        num_hits=result.num_hits,
        facets=result.facets,
        execution_time_ns=result.execution_time_ns,
    )


def _suggest_fast(index, request):
    """The vectorised suggest for the canonical shape (``_suggest_fast``,
    ``:966-1071``): every part one term, ``starts_with``, distance 0 once
    clamped, case folded, no regex, snippet, token value, options or
    part-level ``top`` / ``skip``; else None.

    In a prefix range a term's score falls with its length alone (distance
    = length - prefix length, the prefix formula), so (score desc, text
    desc) is (length asc, text desc), and each part's best ``top + skip``
    are taken by position in the lowercase-sorted slice, without the other
    strings. Equal lowercase texts keep the smallest id; across parts the
    earlier part keeps an equal score, as :func:`suggest`'s merge does."""
    if request.top is None:
        return None
    skip = request.skip or 0
    need = request.top + skip
    if need <= 0:
        return []
    per_part = []
    for part in request.suggest:
        if (
            len(part.terms) != 1 or not part.starts_with or clamped_distance(part) or part.is_regex
            or part.snippet or (part.options or None) or part.token_value is not None
            or part.top is not None or part.skip is not None or part.ignore_case is False
        ):
            return None
        try:
            dictionary = index.get_dictionary(leaf_field(part))
        except FstNotFoundError:
            return None
        prefix = part.terms[0].lower()
        arr = dictionary._lower_sorted
        i = bisect.bisect_left(arr, prefix)
        j = bisect.bisect_right(arr, prefix + "\U0010FFFF", lo=i)
        if j <= i:
            continue
        perm = dictionary.lower_perm_np[i:j]
        lens = dictionary.char_lengths()[perm]
        # (length asc, slice position desc) == (score desc, text desc);
        # equal lowercase texts are adjacent in the slice and stay so
        order = np.lexsort((-np.arange(len(perm)), lens))
        boost = _F32(part.boost) if part.boost is not None else None
        sel = []  # (lowercase text, score, term id)
        prev_txt = None
        for oi in order.tolist():
            txt = arr[i + oi]
            tid = int(perm[oi])
            if txt == prev_txt:
                if tid < sel[-1][2]:  # the smallest id of equal lowercase texts
                    sel[-1] = (txt, sel[-1][1], tid)
                continue
            if len(sel) >= need:
                break  # a new text past the window: done
            dist = _F32(int(lens[oi]) - len(prefix))
            score = _F32(2.0) / (np.log2(dist + _F32(1.0)) + _F32(0.2))
            if boost is not None:
                score = _F32(score * boost)
            sel.append((txt, float(score), tid))
            prev_txt = txt
        per_part.append(sel)
    return _merge_suggestions(((term, score, tid) for sel in per_part for term, score, tid in sel),
                              skip, request.top)


def _merge_suggestions(triples, skip: int, top):
    """(text, score, term id) over the parts, in part order -> the best score
    per text (an earlier equal score stays), text descending, then score
    descending (get_text_score_id_from_result, search_field.rs:160-192),
    windowed by ``skip`` and ``top``."""
    merged = {}
    for term, score, tid in triples:
        prev = merged.get(term)
        if prev is None or score > prev[0]:
            merged[term] = (score, tid)
    out = [(term, score, tid) for term, (score, tid) in merged.items()]
    out.sort(key=lambda el: el[0], reverse=True)
    out.sort(key=lambda el: -el[1])
    out = out[skip:]
    return out if top is None else out[:top]


def _suggest_general(index, request, fuzzy):
    """Each part's field search, its kept terms lowercased, merged
    (``suggest``, ``:1080-1127``)."""
    triples = []
    for part in request.suggest:
        fsr = search_field(index, part, fuzzy, return_term=True, return_term_lowercase=True)
        triples.extend((fsr.terms[tid], float(score), tid)
                       for tid, score in zip(fsr.term_ids.tolist(), fsr.term_scores))
    return _merge_suggestions(triples, request.skip or 0, request.top)


def suggest_batch(index, requests) -> list:
    """Answer suggest requests (``suggest_batch``, ``:1073``): each is a
    list of ``(lowercase text, score, term id)``, the reference's. A
    request of the canonical prefix shape takes the vectorised path
    (:func:`_suggest_fast`), the rest the general one, their fuzzy parts
    matched in one prefetch for the whole batch. ``index.path_counts``
    counts each path ("suggest_fast", "suggest_general")."""
    index = as_index(index)
    out: list = [None] * len(requests)
    general = []
    for i, request in enumerate(requests):
        if not request.suggest:
            raise VelociError("only suggest allowed in suggest function")
        out[i] = _suggest_fast(index, request)
        if out[i] is None:
            general.append(i)
    index.count_path("suggest_fast", len(requests) - len(general))
    index.count_path("suggest_general", len(general))
    if general:
        specs = {fuzzy_spec(p) for i in general for p in requests[i].suggest} - {None}
        fuzzy = prefetch_fuzzy_matches(index, specs)
        for i in general:
            out[i] = _suggest_general(index, requests[i], fuzzy)
    return out


def suggest(index, request) -> list:
    """One suggest request (``suggest``, ``:1080``; reference
    search_field::suggest_multi, search_field.rs:194-219)."""
    return suggest_batch(index, [request])[0]
