"""The document-sharded mesh: a grid of torch devices, its two collectives,
and the sharded postings and dictionary with their shard steps.

Counterpart of ``veloci_tpu/parallel/sharding.py`` (ROADMAP A11, with B9's
shard steps). The reference is single-controller: one process builds a
``jax.sharding.Mesh`` and runs per-shard steps with ``all_gather`` /
``psum`` inside ``shard_map``. Here the mesh is a ``[q, d]`` grid of
``torch.device`` s (:func:`build_mesh`; one device may stand in several
cells, so eight shards can share one card or the CPU). Each shard's
tensors live on its device, every per-shard step runs there, and the two
collectives are explicit copies to the lead device (:func:`all_gather`,
concatenation in shard order; :func:`psum`, addition in shard order), the
only places data crosses shards.

* document sharding (axis ``d``): shard ``i`` holds the anchors
  ``[i * dps, min((i + 1) * dps, num_docs))``, ``dps = ceil(num_docs /
  d)``; the last shards may be short or empty. :class:`ShardedPostings`
  keeps each shard's posting CSR with shard-local anchors, in the layout
  kernel B7 reads (:class:`..ops.postings.Csr`), so a leaf resolves into a
  ``[shard docs]`` plane on each shard and the top-k of each merges
  exactly (:func:`merge_topk`).
* the dictionary's term axis (:class:`ShardedDictionary`): each shard
  sweeps its slice, sorted by length locally, over the length window of
  the query (lev(a, b) >= |len(a) - len(b)|), with the kernel the port's
  field search would launch for the same items on one card
  (:func:`..search.field_search.sweep_kernel`).
* query-batch parallelism (axis ``q``): a batch splits into ``q`` parts,
  part ``j`` on row ``j`` of the grid, and gathers back in order.

The search reaches the mesh through :mod:`.mesh_executor`, which calls
:class:`ShardedPostings`, :class:`ShardedDictionary`, :func:`sharded_select`,
:func:`merge_topk`, :func:`shard_topk` and :func:`sharded_facet_counts`.
:func:`sharded_search_topk` and :func:`sharded_fuzzy_match` are the
reference's entry points of the same names, kept so that the parity tests
hold the shard steps to the reference's; nothing in the search calls them.

The reference pads each shard's postings to one static shape (rounded to
128 rows, pad anchors) and retries its top-M fuzzy selection with four
times M until nothing was clipped; neither exists here: shapes are the
data's, and the select returns every match.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.postings import Csr, csr_resolve, dense_max_row_score
from ..ops.topk import rank_key, topk_dense
from ..persistence import FieldSweep, _device, default_device
from ..search.facet import FacetRelation, facet_counts

__all__ = [
    "Mesh",
    "ShardedDictionary",
    "ShardedPostings",
    "all_gather",
    "build_mesh",
    "doc_bounds",
    "merge_topk",
    "psum",
    "shard_relation",
    "sharded_facet_counts",
    "sharded_fuzzy_match",
    "sharded_search_topk",
    "sharded_select",
]


class Mesh:
    """A ``[q, d]`` grid of torch devices, its axes named ``q`` and ``d``."""

    def __init__(self, grid: Sequence[Sequence[torch.device]]) -> None:
        self.devices = [list(row) for row in grid]
        if not self.devices or not self.devices[0] or any(len(r) != len(self.devices[0]) for r in self.devices):
            raise ValueError("a mesh is a non-empty [q, d] grid of devices")
        self.shape = {"q": len(self.devices), "d": len(self.devices[0])}

    def lead(self, row: int = 0) -> torch.device:
        """Where row ``row``'s collectives meet: its first shard's device."""
        return self.devices[row][0]


def _normal(device) -> torch.device:
    dev = _device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def build_mesh(n_docs_shards: int, n_query_shards: int = 1, devices=None) -> Mesh:
    """A ``[n_query_shards, n_docs_shards]`` mesh over ``devices`` (taken in
    row order; one device may repeat). By default every cell is the default
    device (``persistence.default_device``, the card); with no GPU a card
    raises, as an index loaded onto the card does."""
    n = n_docs_shards * n_query_shards
    if devices is None:
        devices = [default_device()] * n
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devs = [_normal(d) for d in devices[:n]]
    return Mesh([devs[j * n_docs_shards : (j + 1) * n_docs_shards] for j in range(n_query_shards)])


def all_gather(tensors: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The per-shard tensors, copied to ``lead`` and concatenated in shard
    order (``jax.lax.all_gather`` over ``d``, flattened)."""
    return torch.cat([t.to(lead) for t in tensors])


def psum(tensors: Sequence[torch.Tensor], lead: torch.device) -> torch.Tensor:
    """The per-shard tensors, copied to ``lead`` and added in shard order
    (``jax.lax.psum`` over ``d``)."""
    total = tensors[0].to(lead)
    for t in tensors[1:]:
        total = total + t.to(lead)
    return total


def doc_bounds(num_docs: int, d: int) -> np.ndarray:
    """``[d + 1]`` shard bounds: shard ``i`` holds ``[b[i], b[i + 1])``."""
    dps = max(1, -(-num_docs // d))
    return np.minimum(np.arange(d + 1, dtype=np.int64) * dps, num_docs)


class ShardedPostings:
    """Anchor-range shards of a posting CSR (``ShardedPostings``): shard
    ``i`` (along ``d``) holds the rows whose anchor lies in its range, with
    anchors made local, as a :class:`..ops.postings.Csr` on its device:
    ``offsets [num_keys + 2]`` int64 (double tail) and ``packed [nnz_i, 2]``
    int32 (local anchor, f32 bits of the score). Rows keep their CSR order
    (runs sorted by anchor, one row per anchor)."""

    def __init__(self, offsets, anchors, scores01, num_docs: int, mesh: Mesh) -> None:
        offsets = np.asarray(offsets, dtype=np.int64)  # [num_keys + 1]
        d = mesh.shape["d"]
        self.mesh = mesh
        self.num_shards = d
        self.num_docs = int(num_docs)
        self.num_keys = len(offsets) - 1
        self.bounds = doc_bounds(self.num_docs, d)
        nnz = int(offsets[-1])
        anchors = np.asarray(anchors, dtype=np.int64)[:nnz]
        scores01 = np.ascontiguousarray(np.asarray(scores01, dtype=np.float32)[:nnz])
        keys = np.repeat(np.arange(self.num_keys, dtype=np.int64), np.diff(offsets))
        live = anchors < self.num_docs
        shard_of = np.where(live, np.searchsorted(self.bounds, anchors, side="right") - 1, d)
        order = np.argsort(shard_of, kind="stable")
        cuts = np.searchsorted(shard_of[order], np.arange(d + 1))
        top = dense_max_row_score(scores01)
        self.shards: List[Csr] = []
        for i in range(d):
            rows = order[cuts[i] : cuts[i + 1]]
            host = np.zeros(self.num_keys + 2, dtype=np.int64)
            np.cumsum(np.bincount(keys[rows], minlength=self.num_keys), out=host[1 : self.num_keys + 1])
            host[-1] = host[-2]
            packed = np.stack([(anchors[rows] - self.bounds[i]).astype(np.int32), scores01[rows].view(np.int32)],
                              axis=1)
            dev = mesh.devices[0][i]
            self.shards.append(Csr(torch.from_numpy(host).to(dev), torch.from_numpy(packed).to(dev), host, top))
        self._rows: dict = {}

    def shard_docs(self, i: int) -> int:
        return int(self.bounds[i + 1] - self.bounds[i])

    def csr(self, i: int, row: int = 0) -> Csr:
        """Shard ``i``'s CSR on row ``row``'s device (copied there once when
        that row's cell is another device)."""
        dev = self.mesh.devices[row][i]
        base = self.shards[i]
        if base.packed.device == dev:
            return base
        key = (i, row)
        if key not in self._rows:
            self._rows[key] = Csr(base.offsets.to(dev), base.packed.to(dev), base.host_offsets, base.max_row_score)
        return self._rows[key]

    def resolve(self, gtids: np.ndarray, scores: np.ndarray, row: int = 0) -> List[torch.Tensor]:
        """A leaf's planes, one ``[shard docs]`` f32 plane a shard: its
        terms' runs and each anchor's maximum (kernel B7 on a card); no
        launch on a shard where the runs hold no row."""
        return [csr_resolve(self.csr(i, row), gtids, scores, self.shard_docs(i)) for i in range(self.num_shards)]


def merge_topk(parts, k: int, lead: torch.device):
    """Per-shard top-k lists ``(global ids int64, scores f32)`` -> the exact
    global top ``k`` by (score desc, id desc), gathered on ``lead``."""
    ids = all_gather([p[0] for p in parts], lead)
    scores = all_gather([p[1] for p in parts], lead)
    k = min(int(k), ids.shape[0])
    _key, order = torch.topk(rank_key(scores, ids), k, largest=False, sorted=True)
    return ids[order], scores[order]


def shard_topk(planes, bounds, k: int):
    """Each shard's top ``k`` (:func:`..ops.topk.topk_dense`), ids made global."""
    out = []
    for i, plane in enumerate(planes):
        ids, scores = topk_dense(plane, k)
        out.append((ids + int(bounds[i]), scores))
    return out


def sharded_search_topk(postings: ShardedPostings, term_ids, term_scores, k: int):
    """A batch of leaves on the mesh (``sharded_search_topk``): per query,
    its terms (``term_ids [Q, T]`` global ids, pad -1, with ``term_scores
    [Q, T]`` f32) resolve on every shard (B7), each shard takes its top
    ``k``, and the shards merge exactly by (score desc, id desc). With a
    ``q`` axis the batch splits into ``q`` parts, part ``j`` on row ``j``,
    gathered back in order. Returns ``(ids, scores)``, a list of host arrays
    each, one per query, hits only."""
    term_ids = np.asarray(term_ids, dtype=np.int64)
    term_scores = np.asarray(term_scores, dtype=np.float32)
    rows = np.array_split(np.arange(len(term_ids)), postings.mesh.shape["q"])
    ids_out, scores_out = [None] * len(term_ids), [None] * len(term_ids)
    for row, queries in enumerate(rows):
        lead = postings.mesh.lead(row)
        for qi in queries.tolist():
            live = term_ids[qi] >= 0
            planes = postings.resolve(term_ids[qi][live], term_scores[qi][live], row)
            ids, scores = merge_topk(shard_topk(planes, postings.bounds, k), k, lead)
            ids_out[qi], scores_out[qi] = ids.cpu().numpy(), scores.cpu().numpy()
    return ids_out, scores_out


class ShardedDictionary:
    """Term-axis shards of a field's sweep matrix (``ShardedDictionary``):
    the rows ordered by term id and cut into ``d`` contiguous slices, each
    sorted by length locally (stably) in the port's transposed layout
    (:class:`..persistence.FieldSweep`: ``chars_t [32, n_i] uint16``,
    ``lengths [n_i] int32``, ``sweep_ids [n_i] int32`` the rows' global term
    ids) on its shard's device, with its length boundaries ``cum`` on the
    host (rows of length ``l`` are ``[cum[l], cum[l + 1])``). A local sort
    keeps the shards balanced: a global one would put each query's window
    on one shard."""

    def __init__(self, chars, lengths, mesh: Mesh, term_ids=None) -> None:
        chars = np.asarray(chars, dtype=np.uint16)
        lengths = np.asarray(lengths, dtype=np.int32)
        term_ids = np.arange(len(chars), dtype=np.int64) if term_ids is None else np.asarray(term_ids, np.int64)
        keep = np.flatnonzero(term_ids >= 0)
        keep = keep[np.argsort(term_ids[keep], kind="stable")]
        d = mesh.shape["d"]
        self.mesh = mesh
        self.num_terms = len(keep)
        self.terms_per_shard = max(1, -(-self.num_terms // d))
        self.width = chars.shape[1]
        self.shards: List[FieldSweep] = []
        self.cum: List[np.ndarray] = []
        for i in range(d):
            rows = keep[i * self.terms_per_shard : (i + 1) * self.terms_per_shard]
            rows = rows[np.argsort(lengths[rows], kind="stable")]
            lens = lengths[rows]
            dev = mesh.devices[0][i]
            self.shards.append(FieldSweep(
                torch.from_numpy(np.ascontiguousarray(chars[rows].T)).to(dev),
                torch.from_numpy(np.ascontiguousarray(lens)).to(dev),
                torch.from_numpy(term_ids[rows].astype(np.int32)).to(dev),
            ))
            self.cum.append(np.searchsorted(lens, np.arange(self.width + 2)))

    def window(self, i: int, min_len: Optional[int] = None, max_len: Optional[int] = None,
               row: int = 0) -> FieldSweep:
        """Shard ``i``'s rows of length ``[min_len, max_len]`` (all of them
        when either is None), contiguous, on row ``row``'s device."""
        sweep, cum = self.shards[i], self.cum[i]
        dev = self.mesh.devices[row][i]
        if min_len is not None and max_len is not None:
            top = self.width + 1
            lo, hi = int(cum[min(max(min_len, 0), top)]), int(cum[min(max(max_len + 1, 0), top)])
            if (lo, hi) != (0, sweep.lengths.shape[0]):
                sweep = FieldSweep(sweep.chars_t[:, lo:hi].contiguous(), sweep.lengths[lo:hi],
                                   sweep.sweep_ids[lo:hi])
        return FieldSweep(*(t.to(dev) for t in sweep))


def _item_window(items):
    """The length window ``(min_len, max_len)`` that holds every match of
    ``items`` [(lower_term, distance, starts_with)], or ``(None, None)``
    (all rows) when one of them matches term prefixes."""
    if any(sw for _t, _d, sw in items):
        return None, None
    return min(len(t) - d for t, d, _sw in items), max(len(t) + d for t, d, _sw in items)


def sharded_select(dictionary: ShardedDictionary, items, window=None, row: int = 0):
    """Every match of ``items`` [(lower_term, distance, starts_with)] over
    the sharded dictionary: on each shard, the rows of the items' length
    window (``window`` overrides it; ``(None, None)`` is every row) take ONE
    launch of the kernel the field search picks for the items
    (:func:`..search.field_search._select`: the fused banded select for a
    lone item the band holds, the banded batch for several, the full-width
    sweep for ``starts_with`` or a distance past the band), then the
    matches gather over ``d``. A shard whose window holds no row launches
    nothing. Returns per item ``(global term ids, distances, is_prefix)``,
    shard by shard."""
    from ..search.field_search import _select  # it imports the persistence this module does

    lo, hi = _item_window(items) if window is None else window
    per_shard = []
    for i in range(dictionary.mesh.shape["d"]):
        sweep = dictionary.window(i, lo, hi, row)
        if sweep.lengths.shape[0]:
            per_shard.append(_select(sweep, items))
    out = []
    for k in range(len(items)):
        got = [m[k] for m in per_shard]
        out.append(tuple(np.concatenate([np.asarray(g[j]) for g in got]) if got else
                         np.empty(0, dtype) for j, dtype in enumerate((np.int64, np.int32, bool))))
    return out


def sharded_fuzzy_match(dictionary: ShardedDictionary, lower_term: str, distance: int, starts_with: bool = False,
                        min_len: Optional[int] = None, max_len: Optional[int] = None, row: int = 0):
    """One fuzzy term over the sharded dictionary (``sharded_fuzzy_match``):
    with ``min_len`` / ``max_len`` (and not ``starts_with``) each shard
    sweeps only its rows of that length window, else all its rows
    (:func:`sharded_select`). A ``starts_with`` term matches on its prefix
    distance. Returns ``(term ids ascending, distances, is_prefix, total
    matches)``."""
    window = (None, None) if starts_with or min_len is None or max_len is None else (min_len, max_len)
    ids, dists, prefixes = sharded_select(dictionary, [(lower_term, distance, starts_with)], window, row)[0]
    order = np.argsort(ids, kind="stable")
    return ids[order].astype(np.int64), dists[order].astype(np.int64), prefixes[order].astype(bool), len(ids)


def shard_relation(rel: FacetRelation, bounds: np.ndarray, devices) -> List[FacetRelation]:
    """A facet relation (doc -> value CSR) cut at the shard ``bounds``, each
    slice's documents made local, on its shard's device."""
    out = []
    for i, dev in enumerate(devices):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        offsets = rel.offsets[lo : hi + 1]
        start, end = int(offsets[0]), int(offsets[-1])
        out.append(FacetRelation((offsets - start).to(dev), rel.values[start:end].to(dev), rel.num_targets))
    return out


def sharded_facet_counts(relations: Sequence[FacetRelation], planes, lead: torch.device) -> torch.Tensor:
    """Facet counts of the hit set ``plane > 0`` over the shards
    (``sharded_facet_counts``): each shard counts its hits' value pairs
    (:func:`..search.facet.facet_counts`, exact integers), and the counts
    add over ``d`` (:func:`psum`). Returns ``[num_targets]`` int64 on
    ``lead``."""
    counts = []
    for rel, plane in zip(relations, planes):
        hits = torch.nonzero(plane > 0).squeeze(1)
        counts.append(facet_counts(rel, torch.zeros_like(hits), hits, 1)[0])
    return psum(counts, lead)
