"""``search`` and ``search_batch`` over a document-sharded mesh.

Counterpart of ``veloci_tpu/parallel/mesh_executor.py`` (``MeshContext``,
``mesh_search``, ``_filter_mask_host``, ``_apply_anchor_boost_sharded``)
and of the mesh route of ``search_batch`` (``veloci_tpu/search/batch.py:1900``
``_search_batch_mesh``). Usage::

    mesh = build_doc_mesh(8)        # eight shards on the card
    index.attach_mesh(mesh)         # the combined postings cut into shards
    search(request, index)          # -> answered on the mesh
    search_batch(requests, index)   # -> answered on the mesh

Every ``[num_docs]`` plane of the unsharded path becomes a list of
``[shard docs]`` planes, one on each shard's device
(:func:`.sharding.doc_bounds`). A leaf resolves on each shard (kernel B7,
:class:`.sharding.ShardedPostings`); set operations, the filter mask, the
boost columns, 1:n, phrase, ``boost_term`` and text-locality factors apply
elementwise on each shard, with each shard's slice of the host vectors;
fuzzy leaves match on the term-sharded dictionary
(:func:`.sharding.sharded_select`). The only data that crosses shards are
the collectives of :mod:`.sharding`: the hit count and the facet counts
(``psum``), an intersection's per-child hit counts (``psum``, to pick its
shortest child), and the per-shard top-k, merged exactly (``all_gather``).

The mesh answers as the unsharded index does, bit for bit: each request
takes the route the unsharded ``search`` would take it on. A request the
batched route admits (``search/batch.py`` ``_ADMISSION``) goes through
:func:`search_batch_mesh`, whose trees evaluate on dense planes
(:func:`..ops.generic_step.tree_dense_deep`) in the tree route's order of
f32 steps; every other request through :func:`mesh_execute`, the dense
executor's steps shard by shard. A request that asks for ``explain`` or
carries ``suggest`` is answered on the unsharded index, as the reference
sends it (``executor.py:699-707``). Nothing falls back: a shard step that
fails raises.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.generic_step import _HIT_EPS, generic_plane, tree_dense_deep
from ..ops.postings import csr_resolve
from ..query.request import SearchRequest
from ..search import batch
from ..search.boost import (
    apply_anchor_boost_values_device,
    apply_boost_dense_device,
    boost_to_anchor_values,
    scatter_factor_device,
    term_boost_anchors,
    text_locality_boost,
)
from ..search.executor import (
    _Ctx,
    _intersect,
    _matching_1n_boost,
    _option_boosts,
    _phrase_store,
    _union,
    _wants_explain,
    execute,
)
from ..search.facet import facet_list, facet_relation
from ..search.field_search import (
    _long_matches,
    _merge_matches,
    fuzzy_spec,
    leaf_field,
    sweep_launches,
)
from ..search.result import Hit, SearchResult
from ..search.stats import count_fallback
from ..search.why_found import get_why_found, merge_field_hits
from .sharding import (
    Mesh,
    ShardedDictionary,
    ShardedPostings,
    all_gather,
    build_mesh,
    doc_bounds,
    merge_topk,
    psum,
    shard_relation,
    shard_topk,
    sharded_facet_counts,
    sharded_fuzzy_match,
    sharded_select,
)

__all__ = ["MeshContext", "build_doc_mesh", "mesh_execute", "mesh_search", "search_batch_mesh"]

SEARCH, OR, AND = SearchRequest.SEARCH, SearchRequest.OR, SearchRequest.AND


def build_doc_mesh(n_shards: int, devices=None) -> Mesh:
    """A ``[1, n_shards]`` mesh: document shards only (``build_doc_mesh``)."""
    return build_mesh(n_shards, 1, devices)


class _ShardedField(NamedTuple):
    """One field's postings on the mesh: its key range of the sharded
    combined CSR (global term id = ``base`` + the field's term id)."""

    postings: ShardedPostings
    base: int
    num_keys: int


class MeshContext:
    """An index's state on an attached mesh: the combined postings cut into
    the mesh's ``d`` document shards (built on attach), and, made at first
    use and cached, each field's term-sharded dictionary, the boost
    factors, filter masks and facet relations cut at the shard bounds."""

    def __init__(self, index, mesh: Mesh) -> None:
        self.index = index
        self.mesh = mesh
        self.d = mesh.shape["d"]
        self.q = mesh.shape["q"]
        self.num_docs = index.num_docs
        self.bounds = doc_bounds(self.num_docs, self.d)
        self.dps = int(self.bounds[1] - self.bounds[0])
        self.cache: dict = {}
        packed = index.packed.cpu()
        self._combined = ShardedPostings(
            index.host_offsets[:-1], packed[:, 0].numpy(), packed[:, 1].contiguous().view(torch.float32).numpy(),
            self.num_docs, mesh,
        )

    # ------------------------------------------------------------- plumbing
    def combined(self) -> ShardedPostings:
        """The combined global-key posting CSR, document-sharded (the mesh
        twin of the index's own; ``combined``)."""
        return self._combined

    def field(self, field: str) -> Optional[_ShardedField]:
        """A field's postings on the mesh, or None for a field without."""
        kb = self.index.key_base.get(field)
        return None if kb is None else _ShardedField(self._combined, kb[0], kb[1])

    def devices(self, row: int = 0) -> list:
        return self.mesh.devices[row]

    def shard_docs(self, i: int) -> int:
        return int(self.bounds[i + 1] - self.bounds[i])

    def zeros(self, row: int = 0) -> List[torch.Tensor]:
        return [torch.zeros(self.shard_docs(i), dtype=torch.float32, device=dev)
                for i, dev in enumerate(self.devices(row))]

    def shard_host_vector(self, vec, row: int = 0) -> List[torch.Tensor]:
        """A ``[num_docs]`` vector (numpy or a tensor) -> its slice on each
        shard's device (``shard_host_vector``)."""
        out = []
        for i, dev in enumerate(self.devices(row)):
            part = vec[self.bounds[i] : self.bounds[i + 1]]
            out.append(part.to(dev) if torch.is_tensor(part) else torch.from_numpy(np.ascontiguousarray(part)).to(dev))
        return out

    def split_anchors(self, anchors: np.ndarray):
        """Global anchors -> per shard its local anchors (list order kept)
        and the positions they came from."""
        anchors = np.asarray(anchors, dtype=np.int64)
        out = []
        for i in range(self.d):
            pos = np.flatnonzero((anchors >= self.bounds[i]) & (anchors < self.bounds[i + 1]))
            out.append((anchors[pos] - self.bounds[i], pos))
        return out

    def _memo(self, key, make):
        hit = self.cache.get(key)
        if hit is None:
            hit = self.cache[key] = make()
        return hit

    def boost_factors(self, bkey: tuple, row: int = 0) -> list:
        """A boost spec's factor arrays (:func:`..search.batch._boost_factors`)
        sliced for each shard: one ``pre`` tuple a shard."""
        def make():
            pre = batch._boost_factors(self.index, bkey)
            return [_slice_pre(pre, int(self.bounds[i]), int(self.bounds[i + 1]), dev)
                    for i, dev in enumerate(self.devices(row))]
        return self._memo(("boost", bkey, row), make)

    def boost_column(self, path: str, row: int = 0):
        """A boost column, zero-padded to ``[num_docs]`` (values f32,
        present bool; :meth:`..persistence.TorchIndex.device_boost`), its
        slice on each shard (``boost_column``): two lists, one tensor a
        shard. The search reads a column as its factors
        (:meth:`boost_factors`); only the parity tests call this."""
        def make():
            values, present = self.index.device_boost(path)
            return self.shard_host_vector(values, row), self.shard_host_vector(present, row)
        return self._memo(("column", path, row), make)

    def sharded_dict(self, field: str) -> ShardedDictionary:
        """The field's sweep matrix, term-sharded (lazy, cached)."""
        def make():
            sweep = self.index.fields[field]
            return ShardedDictionary(sweep.chars_t.cpu().numpy().T, sweep.lengths.cpu().numpy(), self.mesh,
                                     sweep.sweep_ids.cpu().numpy())
        return self._memo(("dictionary", field), make)

    def fuzzy_match(self, field: str, lower_term: str, distance: int, starts_with: bool = False, row: int = 0):
        """One fuzzy term over the field's term-sharded sweep rows
        (``fuzzy_match``): each shard sweeps its ``[len - distance, len +
        distance]`` length window, or all its rows for ``starts_with``
        (:func:`.sharding.sharded_fuzzy_match`). Returns ``(global term ids
        ascending, distances, is_prefix)``. The field's long terms are not
        swept here; the search matches them in :meth:`prefetch`, which it
        calls instead, and only the parity tests call this."""
        n = len(lower_term)
        ids, dists, prefixes, _total = sharded_fuzzy_match(self.sharded_dict(field), lower_term, distance,
                                                           starts_with, n - distance, n + distance, row)
        return ids, dists, prefixes

    def prefetch(self, specs, row: int = 0) -> dict:
        """The mesh twin of :func:`..search.field_search.prefetch_fuzzy_matches`
        (the reference's ``fuzzy_match``, here for all of a request's or a
        batch's fuzzy leaves at once): every match of every ``(field,
        lower_term, distance, starts_with)`` spec, per field and launch
        group one sharded sweep (:func:`.sharding.sharded_select`), the
        field's long terms matched as on one device, all merged by term id."""
        out = {}
        for (field, _full), items in sweep_launches(specs).items():
            dictionary = self.index.get_dictionary(field)
            matches = sharded_select(self.sharded_dict(field), items, row=row)
            extras = _long_matches(self.index.long_terms[field], items)
            for item, swept, extra in zip(items, matches, extras):
                out[(field, *item)] = _merge_matches(dictionary, swept, extra)
        return out

    def filter_masks(self, node, fuzzy, row: int = 0) -> List[torch.Tensor]:
        """A filter's mask (:func:`_filter_mask_host`) on each shard, cached
        per distinct filter."""
        memo = self._memo(("filters", row), dict)
        key = batch._filter_tree_key(node)
        if key not in memo:
            if len(memo) > 512:
                memo.clear()
            memo[key] = self.shard_host_vector(_filter_mask_host(self, node, fuzzy), row)
        return memo[key]

    def filter_mask_stack(self, node_of: Dict[tuple, object], fuzzy, row: int = 0):
        """A group's distinct filters as one ``[NF, shard docs]`` bool stack
        a shard, rows in a canonical order, and each filter key's row
        (``filter_mask_stack``)."""
        skey = tuple(sorted(node_of, key=repr))
        memo = self._memo(("filter_stacks", row), dict)
        if skey not in memo:
            if len(memo) > 64:
                memo.clear()
            masks = [self.filter_masks(node_of[k], fuzzy, row) for k in skey]
            memo[skey] = [torch.stack([m[i] for m in masks]) for i in range(self.d)]
        return memo[skey], {k: i for i, k in enumerate(skey)}

    def facet_relations(self, field: str, gated: bool, row: int = 0):
        """A facet relation (:func:`..search.facet.facet_relation`) cut at
        the shard bounds, cached per field, gate and row; None where the
        index has none."""
        def make():
            rel = facet_relation(self.index, field, gated)
            return None if rel is None else shard_relation(rel, self.bounds, self.devices(row))
        return self._memo(("facet", field, gated, row), make)

    # ------------------------------------------------------------- shard steps
    def resolve_leaf(self, field: str, term_ids, term_scores, row: int = 0) -> List[torch.Tensor]:
        """A leaf's matched term ids and f32 scores -> its planes, one a
        shard (B7 on each; ``resolve_leaf``); zeros for a field without
        postings. Term ids past the field's scored keys are dropped."""
        sf = self.field(field)
        if sf is None or not len(term_ids):
            return self.zeros(row)
        term_ids = np.asarray(term_ids, dtype=np.int64)
        keep = term_ids < sf.num_keys
        return sf.postings.resolve(term_ids[keep] + sf.base, np.asarray(term_scores, np.float32)[keep], row)

    def num_hits(self, planes, row: int = 0) -> int:
        """The count of scores > 0 over the shards (``psum``)."""
        return int(psum([(p > 0).sum() for p in planes], self.mesh.lead(row)))

    def topk(self, planes, k: int, row: int = 0):
        """The exact global top ``k`` by (score desc, id desc) and the hit
        count (``topk``): each shard's top ``k`` (B9's top_k step,
        :func:`..ops.topk.topk_dense`), gathered and merged on the lead
        device. Returns host ``(ids, scores, num_hits)``."""
        ids, scores = merge_topk(shard_topk(planes, self.bounds, k), k, self.mesh.lead(row))
        return ids.cpu().numpy(), scores.cpu().numpy(), self.num_hits(planes, row)

    def facet_counts(self, facet_req, planes, row: int = 0) -> list:
        """A facet's list over the hit set ``plane > 0`` of the shards
        (``facet_counts``): a fast relation counted on each shard and added
        over ``d`` (:func:`.sharding.sharded_facet_counts`), exact; other
        fields joined on the host from the gathered hit ids."""
        lead = self.mesh.lead(row)

        def fast(_rel):
            rels = self.facet_relations(facet_req.field, False, row)
            return sharded_facet_counts(rels, planes, lead).cpu().numpy()

        def hit_ids():
            return all_gather([torch.nonzero(p > 0).squeeze(1) + int(self.bounds[i]) for i, p in enumerate(planes)],
                              lead).cpu().numpy()

        return facet_list(self.index, facet_req, fast, hit_ids)


def _slice_pre(pre, lo: int, hi: int, dev):
    """Every tensor of a ``_precompute_boost`` tuple cut to ``[lo, hi)`` and
    moved to ``dev``."""
    if torch.is_tensor(pre):
        return pre[lo:hi].to(dev)
    if isinstance(pre, tuple):
        return tuple(_slice_pre(p, lo, hi, dev) for p in pre)
    return pre


def _shard_ctx(mc: MeshContext, i: int, row: int):
    """What the executor's set operations read of their context, for shard
    ``i``: its size, device and zeros."""
    n, dev = mc.shard_docs(i), mc.devices(row)[i]
    return SimpleNamespace(num_docs=n, index=SimpleNamespace(device=dev),
                           zeros=lambda: torch.zeros(n, dtype=torch.float32, device=dev))


# ---------------------------------------------------------------- one request, the dense executor's steps
def _filter_mask_host(mc: MeshContext, node, fuzzy) -> np.ndarray:
    """A filter's ``[num_docs]`` bool mask on the host, from its anchors
    (:func:`..search.batch._filter_anchor_list`, memoised per index)."""
    mask = np.zeros(mc.num_docs, dtype=bool)
    mask[batch._filter_anchor_list(mc.index, node, fuzzy)] = True
    return mask


def _apply_anchor_boost_sharded(mc: MeshContext, planes, anchors, values, boost_part):
    """A 1:n boost's ``(anchor, value)`` lists over the shards' planes: each
    shard takes its anchors, in list order
    (:func:`..search.boost.apply_anchor_boost_values_device`); a shard with
    none floors its hits at 1e-30, as a non-empty list does everywhere."""
    if not len(anchors):
        return planes
    values = np.asarray(values, dtype=np.float32)
    out = []
    for plane, (local, pos) in zip(planes, mc.split_anchors(anchors)):
        if len(local):
            out.append(apply_anchor_boost_values_device(plane, local, values[pos], boost_part))
        else:
            out.append(torch.where(plane > 0, torch.clamp(plane, min=_HIT_EPS), plane))
    return out


def _eval_planes(mc: MeshContext, ctx, node, boosts, row: int):
    """The tree -> (its planes, representative term), as the executor's
    ``_eval_scores``: a union per shard, an intersection per shard with the
    shortest child counted over all of them."""
    if node.kind == SEARCH:
        part = node.part
        fsr = ctx.field_search(part)
        planes = mc.resolve_leaf(leaf_field(part), fsr.term_ids, fsr.term_scores, row)
        b1n = _matching_1n_boost(part, list(boosts) + _option_boosts(part.options))
        if b1n is not None:
            anchors, values = boost_to_anchor_values(mc.index, part.path, b1n, fsr.term_ids)
            planes = _apply_anchor_boost_sharded(mc, planes, anchors, values, b1n)
        return planes, part.terms[0]
    sub_boosts = list(boosts) + _option_boosts(node.options)
    children = [_eval_planes(mc, ctx, q, sub_boosts, row) for q in node.queries]
    if not children:
        return mc.zeros(row), ""
    if len(children) == 1:
        return children[0]
    if node.kind == OR:
        planes = [_union(_shard_ctx(mc, i, row), [(c[0][i], c[1]) for c in children]) for i in range(mc.d)]
    elif node.kind == AND:
        counts = [mc.num_hits(c[0], row) for c in children]
        shortest = int(np.argmin(counts))
        planes = [_intersect(_shard_ctx(mc, i, row), [(c[0][i],) for c in children], shortest)
                  for i in range(mc.d)]
    else:
        from ..error import InvalidRequestError

        raise InvalidRequestError(f"unknown node kind {node.kind}")
    return planes, children[0][1]


def _phrase_boost_sharded(mc: MeshContext, ctx, phrase_boosts, planes):
    """The executor's phrase factor on each shard: 5 ** g at an anchor in g
    phrase groups, then only hits stay, where a field has phrase pairs."""
    if any(pb.search1.path != pb.search2.path for pb in phrase_boosts):
        from ..error import InvalidRequestError

        raise InvalidRequestError("phrase boost paths must match")
    if not any(_phrase_store(mc.index, pb) is not None for pb in phrase_boosts):
        return planes
    anchors = batch._phrase_anchor_list(mc.index, phrase_boosts, ctx.fuzzy)
    return [torch.where(p > 0, scatter_factor_device(p, local, 5.0), 0.0)
            for p, (local, _pos) in zip(planes, mc.split_anchors(anchors))]


def _term_boost_factors(mc: MeshContext, boost_terms, anchors, row: int):
    """B10's factor (:func:`..search.boost.term_boost_factor_device`) on
    each shard: per part, ``boost ** count`` at each anchor, the powers
    taken on the host in f32, the counts over the shard's anchors."""
    factors = [torch.ones(mc.shard_docs(i), dtype=torch.float32, device=dev)
               for i, dev in enumerate(mc.devices(row))]
    for part, (part_anchors, most) in zip(boost_terms, anchors):
        if not len(part_anchors):
            continue
        boost = np.float32(part.boost if part.boost is not None else 2.0)
        powers = np.power(boost, np.arange(most + 1, dtype=np.float32), dtype=np.float32)
        for i, dev in enumerate(mc.devices(row)):
            lo, hi = int(mc.bounds[i]), int(mc.bounds[i + 1])
            local = part_anchors[(part_anchors >= lo) & (part_anchors < hi)].to(dev) - lo
            counts = torch.bincount(local, minlength=hi - lo)
            factors[i] = factors[i] * torch.from_numpy(powers).to(dev)[counts]
    return factors


def mesh_execute(request, index, reason: str, row: int = 0) -> SearchResult:
    """One request on the mesh, the dense executor's steps
    (:func:`..search.executor.execute`) shard by shard (``mesh_search``):
    the tree's planes, the filter mask, the boost columns, the phrase
    factor, the ``boost_term`` and text-locality factors, then the hit
    count, the facets and the top-k over the shards. ``reason`` is why
    the request left the batched route, counted as its fallback."""
    mc = index.mesh_ctx
    start = time.time_ns()
    index.count_path("mesh_executor")
    count_fallback(reason)
    boost_terms = list(request.boost_term or ())
    specs = set(batch._fuzzy_specs([request]))
    uncached = [p for p in boost_terms if p.key() not in index.term_boost_cache]
    specs.update(s for s in map(fuzzy_spec, uncached) if s is not None)
    fuzzy = mc.prefetch(specs, row)
    ctx = _Ctx(index, fuzzy, request)
    boosts = list(request.boost or ())
    planes, _term = _eval_planes(mc, ctx, request.search_req, boosts, row)
    if request.filter is not None:
        planes = [torch.where(m, p, 0.0) for m, p in zip(mc.filter_masks(request.filter, fuzzy, row), planes)]
    for b in boosts:  # boost columns at anchors
        if "[]" not in b.path:
            planes = [apply_boost_dense_device(p, pre)
                      for p, pre in zip(planes, mc.boost_factors(batch._boost_key(b), row))]
    if request.phrase_boosts:
        planes = _phrase_boost_sharded(mc, ctx, request.phrase_boosts, planes)
    term_id_hits, term_texts = merge_field_hits(map(ctx.field_search, request.search_req.walk_parts()))
    if boost_terms:
        factors = _term_boost_factors(mc, boost_terms, term_boost_anchors(index, boost_terms, fuzzy), row)
        planes = [p * f for p, f in zip(planes, factors)]
    if request.text_locality:
        factor = text_locality_boost(index, term_id_hits, mc.num_docs)
        planes = [p * f for p, f in zip(planes, mc.shard_host_vector(factor, row))]
    result = SearchResult()
    result.why_found_terms = term_texts
    if request.facets:
        result.facets = {f.field: mc.facet_counts(f, planes, row) for f in request.facets}
    top = request.top if request.top is not None else 10
    skip = request.skip or 0
    ids, scores, result.num_hits = mc.topk(planes, top + skip, row)
    result.data = [Hit(int(i), float(s)) for i, s in zip(ids[skip:], scores[skip:])]
    if request.why_found and request.select is not None:
        result.why_found_info = get_why_found(index, [h.id for h in result.data], term_id_hits)
    result.execution_time_ns = time.time_ns() - start
    return result


def mesh_search(request, index, dense_only: bool = False) -> SearchResult:
    """One request on the attached mesh (``mesh_search``): on the batched
    mesh route (:func:`search_batch_mesh`, a batch of one) when the batched
    route admits it and ``dense_only`` is not set, as the unsharded
    ``search`` answers it, else on :func:`mesh_execute`."""
    plan = batch._plan(request, index)
    if plan.kind != "executor" and not dense_only:
        return search_batch_mesh([request], index)[0]
    return mesh_execute(request, index, plan.reason if plan.kind == "executor" else "dense_only")


# ---------------------------------------------------------------- the batched route
class _TreeMaps(NamedTuple):
    """A tree as ``tree_dense_deep`` reads it: each term's plane and the
    plane -> group -> subtree -> term maps, numbered by ascending slot
    levels, so that a descending walk is the tree route's order."""

    tplanes: np.ndarray
    s2g: np.ndarray
    g2s: np.ndarray
    s2t: np.ndarray
    ng_sub: np.ndarray


def _tree_maps(q) -> _TreeMaps:
    """A resolved query's slot levels -> its :class:`_TreeMaps`. A
    two-level tree ``(group, slot)`` is the deep tree of one term and one
    subtree whose gate is its group count."""
    lv, ng = q.levels, q.ng
    if lv.shape[1] == 2:
        lv = np.concatenate([np.zeros((len(lv), 2), np.int64), lv], axis=1)
        ng = np.full(len(lv), q.num_groups, np.int64)
    planes, tplanes = np.unique(lv, axis=0, return_inverse=True)
    groups, s2g = np.unique(planes[:, :3], axis=0, return_inverse=True)
    subs, g2s = np.unique(groups[:, :2], axis=0, return_inverse=True)
    _terms, s2t = np.unique(subs[:, :1], axis=0, return_inverse=True)
    sub_of_term = g2s[s2g[tplanes.reshape(-1)]]
    ng_sub = np.zeros(len(subs), np.float32)
    ng_sub[sub_of_term] = ng
    return _TreeMaps(tplanes.reshape(-1), s2g.reshape(-1), g2s.reshape(-1), s2t.reshape(-1), ng_sub)


def _shard_planes(mc: MeshContext, q, route: str, row: int, maps) -> List[torch.Tensor]:
    """One admitted query's tree planes on every shard: a lone term's run
    (B7) on the single-term route, else :func:`..ops.generic_step.tree_dense_deep`."""
    postings = mc.combined()
    out = []
    for i in range(mc.d):
        csr, n = postings.csr(i, row), mc.shard_docs(i)
        if route == "single":
            out.append(csr_resolve(csr, q.gtids, q.scores, n))
        else:
            out.append(tree_dense_deep(csr, q.gtids, q.scores, maps.tplanes, maps.s2g, maps.g2s, maps.s2t,
                                       maps.ng_sub, n, len(maps.s2g), len(maps.g2s), len(maps.s2t),
                                       int(maps.s2t.max(initial=-1)) + 1))
    return out


def _answer_mesh(mc: MeshContext, route: str, queries, requests, results, start, fuzzy, boost_keys=(),
                 facet_fields=()) -> None:
    """One group of the batched mesh route (``MeshContext.generic_batch``):
    the group splits over the mesh's ``q`` rows; each query's planes on its
    row's shards, its phrase factor (with the tree, as the tree route
    applies it), filter and boost columns (:func:`..ops.generic_step.generic_plane`),
    then its hit count, facet counts and top-k over the shards."""
    if not queries:
        return
    index = mc.index
    nodes = {q.fkey: requests[q.qi].filter for q in queries if q.fkey is not None}
    for row, part in enumerate(np.array_split(np.arange(len(queries)), mc.q)):
        lead = mc.mesh.lead(row)
        stacks, fkey_row = mc.filter_mask_stack(nodes, fuzzy, row) if nodes else (None, {})
        pres = [mc.boost_factors(b, row) for b in boost_keys]
        rels = [mc.facet_relations(f, True, row) for f in facet_fields]
        for qi in part.tolist():
            q = queries[qi]
            req = requests[q.qi]
            planes = _shard_planes(mc, q, route, row, None if route == "single" else _tree_maps(q))
            local = mc.split_anchors(q.panchors) if len(q.panchors) else None
            fr = None if q.fkey is None else fkey_row[q.fkey]
            planes = [generic_plane(p, None if fr is None else stacks[i][fr], [pre[i] for pre in pres],
                                    None if local is None else torch.from_numpy(local[i][0]).to(p.device),
                                    phrase_first=True)
                      for i, p in enumerate(planes)]
            if route == "single":  # the run's length, as the single-term route counts
                ho = index.host_offsets
                num_hits = int((ho[q.gtids + 1] - ho[q.gtids]).sum())
            else:
                num_hits = mc.num_hits(planes, row)
            facets = None
            if facet_fields:
                counts = [sharded_facet_counts(r, planes, lead).cpu().numpy() for r in rels]
                facets = batch._facets_of(index, req, list(facet_fields), counts)
            ids, scores = merge_topk(shard_topk(planes, mc.bounds, q.k), q.k, lead)
            results[q.qi] = batch._emit(req, ids.cpu().numpy(), scores.cpu().numpy(), num_hits, start, facets)


def search_batch_mesh(requests: List, index) -> List[SearchResult]:
    """A batch on the attached mesh (``_search_batch_mesh``): each request
    admitted as the unsharded ``search_batch`` admits it
    (:func:`..search.batch._plan`, ``_ADMISSION``) and grouped by route,
    boost columns and facet fields (:func:`..search.batch._group`), each
    group one sharded step (:func:`_answer_mesh`; ``meshdeep`` trees among
    them); the requests the batched route does not take one at a time on
    :func:`mesh_execute`, or, asking for ``explain`` or carrying
    ``suggest``, on the unsharded executor. Fuzzy leaves match on the
    term-sharded dictionaries, in one prefetch for the batch."""
    mc = index.mesh_ctx
    start = time.time_ns()
    plans = [batch._plan(req, index) for req in requests]
    results: List = [None] * len(requests)
    for qi, (req, plan) in enumerate(zip(requests, plans)):
        if plan.kind == "executor":
            if _wants_explain(req) or req.suggest:
                results[qi] = execute(req, index, plan.reason)
            else:
                results[qi] = mesh_execute(req, index, plan.reason)
    fuzzy = mc.prefetch(set(batch._fuzzy_specs([r for r, p in zip(requests, plans) if p.kind != "executor"])))
    plain, generic = batch._group(index, requests, plans, fuzzy)
    index.count_path("mesh_batch", sum(map(len, plain.values())) + sum(map(len, generic.values())))
    for route, queries in plain.items():
        _answer_mesh(mc, route, queries, requests, results, start, fuzzy)
    for (route, boost_keys, facet_fields), queries in generic.items():
        _answer_mesh(mc, route, queries, requests, results, start, fuzzy, boost_keys, facet_fields)
    for req, plan, res in zip(requests, plans, results):
        if req.why_found and plan.kind != "executor":
            batch._attach_why_found(index, req, res, fuzzy)
    return results
