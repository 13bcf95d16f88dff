"""Score explanation: each top hit's provenance, from the planes the
executor kept on the device.

Counterpart of ``veloci_tpu/search/explain.py`` (``ExplainNode``,
``collect_explain``), with the same entries in the same order:

* leaf   -> ``TermToAnchor`` and ``LevenshteinScore`` per matched term with
            a posting at the anchor
* Or     -> the last contributing child's entries, then
            ``OrSumOverDistinctTerms`` (per-term maxima summed in f32 in
            sorted-term order), then every contributing child's entries
            again
* And    -> the children's entries concatenated
* boosts -> one ``Boost`` entry per recorded value (Log10: the factor,
            then the final score)

The reference copies every plane to the host when ``explain`` is set. Here
the planes stay on ``index.device``: each OR node keeps its children's
planes, each boost application its old and new plane, and
:func:`collect_explain` gathers all of them at the hit anchors, with every
leaf's postings at those anchors (a binary search in each matched term's
run of the device CSR), in one device-to-host copy; the entries are built
on the host with numpy f32, as the reference builds them.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .field_search import leaf_field

__all__ = ["BoostRecord", "ExplainNode", "collect_explain"]

_F32 = np.float32


class BoostRecord(NamedTuple):
    """One boost application over the plane: its old and new plane, and
    for Log10 how its factor is read at an anchor (``("ratio", None)`` for
    a 1:n boost, new / old; ``("column", (values, param))`` for a boost
    column, ``log10(value + param)``), else None."""

    old: torch.Tensor
    new: torch.Tensor
    log10: Optional[tuple]


class ExplainNode:
    """The evaluation tree's mirror, kept when a request asks for explain:
    a leaf keeps its field search, an OR its children's planes and
    representative terms."""

    def __init__(self, kind: str, fsr=None, children=None, planes=None, terms=None):
        self.kind = kind  # "leaf" | "or" | "and"
        self.fsr = fsr  # the leaf's FieldSearchResult
        self.children = children or []
        self.planes = planes  # [num_docs] f32 per child (or)
        self.terms = terms  # the children's representative terms (or)

    def collect(self, ctx: "_Gathered", k: int) -> List[dict]:
        if self.kind == "leaf":
            return ctx.leaf_entries(self, k)
        child_entries = [c.collect(ctx, k) if c is not None else [] for c in self.children]
        out: List[dict] = []
        if self.kind == "and":
            for e in child_entries:
                out.extend(e)
            return out
        contributing = [e for e in child_entries if e]
        if contributing:
            out.extend(contributing[-1])
        per_term: Dict[str, float] = {}
        for plane, term in zip(self.planes, self.terms):
            v = float(ctx.plane_at(plane, k))
            per_term[term] = max(per_term.get(term, 0.0), v)
        total = 0.0
        for t in sorted(per_term):
            total = float(_F32(total) + _F32(per_term[t]))
        out.append({"OrSumOverDistinctTerms": total})
        for e in contributing:
            out.extend(e)
        return out


class _Gathered:
    """The planes and postings read at the hit anchors, on the host."""

    def __init__(self, index, anchors: np.ndarray, root: ExplainNode, boost_log: List[BoostRecord]):
        self.index = index
        planes: Dict[int, torch.Tensor] = {}
        for node in _walk(root):
            if node.kind == "or":
                planes.update((id(p), p) for p in node.planes)
        for rec in boost_log:
            planes.update(((id(rec.old), rec.old), (id(rec.new), rec.new)))
        self._row = {pid: i for i, pid in enumerate(planes)}
        dev = index.device
        idx = torch.from_numpy(anchors).to(dev)
        parts = [torch.stack([p.index_select(0, idx) for p in planes.values()]).view(torch.int32).reshape(-1)] \
            if planes else []
        self._by_node = {}  # leaf node id -> ([T] local ids, [T] scores, its first pair)
        gtids, pair_anchors = [], []
        npairs = 0
        for node in _walk(root):
            field = leaf_field(node.fsr.request) if node.kind == "leaf" else None
            if field not in index.key_base:
                continue
            base, num_keys = index.key_base[field]
            ids = np.asarray(node.fsr.term_ids, dtype=np.int64)
            keep = ids < num_keys  # the reference's get_postings: no run past the keys
            ids, scores = ids[keep], np.asarray(node.fsr.term_scores, dtype=_F32)[keep]
            self._by_node[id(node)] = (ids, scores, npairs)
            gtids.append(np.repeat(ids + base, len(anchors)))
            pair_anchors.append(np.tile(anchors, len(ids)))
            npairs += len(ids) * len(anchors)
        if npairs:
            found, bits = _postings_at(index, np.concatenate(gtids), np.concatenate(pair_anchors))
            parts += [found, bits]
        flat = torch.cat(parts).cpu().numpy() if parts else np.empty(0, np.int32)
        n_planes = len(planes) * len(anchors)
        self._planes = flat[:n_planes].view(_F32).reshape(len(planes), len(anchors))
        self._found = flat[n_planes : n_planes + npairs].astype(bool)
        self._scores = flat[n_planes + npairs :].view(_F32)
        self._num_anchors = len(anchors)

    def plane_at(self, plane: torch.Tensor, k: int) -> np.float32:
        return self._planes[self._row[id(plane)], k]

    def leaf_entries(self, node: ExplainNode, k: int) -> List[dict]:
        """``TermToAnchor`` and ``LevenshteinScore`` for each of the leaf's
        terms with a posting at the ``k``-th anchor (``leaf_entries``)."""
        got = self._by_node.get(id(node))
        if got is None:
            return []
        ids, scores, off = got
        dictionary = self.index.get_dictionary(leaf_field(node.fsr.request))
        entries: List[dict] = []
        for t, (tid, tscore) in enumerate(zip(ids.tolist(), scores)):
            pair = off + t * self._num_anchors + k
            if not self._found[pair]:
                continue
            anchor_score = float(self._scores[pair])
            entries.append({"TermToAnchor": {
                "term_id": tid, "term_score": float(tscore), "anchor_score": anchor_score,
                "final_score": float(_F32(tscore) * _F32(anchor_score)),
            }})
            text = dictionary.terms[tid] if tid < len(dictionary) else f"<long text {tid}>"
            entries.append({"LevenshteinScore": {"score": float(tscore), "text_or_token_id": text,
                                                 "term_id": tid}})
        return entries

    def boost_entries(self, rec: BoostRecord, k: int, anchor: int) -> List[dict]:
        """The record's ``Boost`` entries at the ``k``-th anchor: none unless
        the anchor was a hit whose score the boost changed."""
        old = self.plane_at(rec.old, k)
        new = self.plane_at(rec.new, k)
        if not (old > 0 and new != old):
            return []
        values = [new]
        if rec.log10 is not None:
            how, column = rec.log10
            with np.errstate(divide="ignore", invalid="ignore"):
                if how == "ratio":
                    fac = new / np.maximum(old, _F32(1e-30))
                else:
                    vals, param = column
                    bv = _F32(vals[anchor]) if anchor < len(vals) else _F32(0.0)
                    fac = np.log10(np.asarray(bv + param, dtype=_F32), dtype=_F32)
            values.insert(0, fac)
        return [{"Boost": float(v)} for v in values]


def _walk(node: Optional[ExplainNode]):
    if node is None:
        return
    yield node
    for c in node.children:
        yield from _walk(c)


def _postings_at(index, gtids: np.ndarray, anchors: np.ndarray):
    """For each (global term id, anchor) pair, whether the term's posting
    run holds the anchor and, if so, the score bits of its first row there:
    a lower-bound binary search in each run (``np.searchsorted`` on the
    run's ascending anchors, as the reference reads it), every pair at
    once, on the index's device -> ``(found [P] int32, bits [P] int32)``."""
    ho = index.host_offsets
    lo, hi = ho[gtids], ho[gtids + 1]
    steps = int((hi - lo).max(initial=0)).bit_length()
    packed = index.packed
    last = max(packed.shape[0] - 1, 0)
    buf = torch.from_numpy(np.concatenate([lo, hi, anchors]).astype(np.int64)).to(index.device)
    p = len(gtids)
    lo_t, hi_t, a_t = buf[:p].clone(), buf[p : 2 * p].clone(), buf[2 * p :]
    end = buf[p : 2 * p]
    col = packed[:, 0]
    for _ in range(steps):
        active = lo_t < hi_t
        mid = (lo_t + hi_t) >> 1
        below = col[mid.clamp(max=last)].to(torch.int64) < a_t
        lo_t = torch.where(active & below, mid + 1, lo_t)
        hi_t = torch.where(active & ~below, mid, hi_t)
    row = lo_t.clamp(max=last)
    found = (lo_t < end) & (col[row].to(torch.int64) == a_t) if packed.shape[0] else lo_t < 0
    bits = packed[row, 1] if packed.shape[0] else torch.zeros_like(lo_t, dtype=torch.int32)
    return found.to(torch.int32), bits


def collect_explain(index, root: Optional[ExplainNode], anchors: List[int],
                    boost_log: List[BoostRecord]) -> Dict[int, List[dict]]:
    """Explain entries for the hit anchors (``collect_explain``): the tree's
    entries, then each boost record's, in the order they were applied."""
    out: Dict[int, List[dict]] = {}
    if root is None or not anchors:
        return out
    arr = np.asarray(anchors, dtype=np.int64)
    ctx = _Gathered(index, arr, root, boost_log)
    for k, anchor in enumerate(arr.tolist()):
        entries = root.collect(ctx, k)
        for rec in boost_log:
            entries.extend(ctx.boost_entries(rec, k, anchor))
        out[anchor] = entries
    return out
