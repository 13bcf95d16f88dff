"""The reference's answer to a request, from :class:`.index.ReferenceIndex`.

A request is the JSON the benchmark sends (``{"search_req": ..., "top":
10}``). Its tree is read as veloci reads it (upstream
``src/search/search_field.rs`` and ``src/search/set_op.rs``), after nested
nodes of one kind are flattened and one-child nodes collapsed:

* a leaf (one term on one field) matches the field's terms whose
  lowercase equals the lowercased term or, at a Levenshtein distance ``d``
  (capped at the term's length - 1), lies within ``d`` of it. A matched term
  scores ``2 / (d + 0.2)``, or ``2 / (log2(d + 1) + 0.2)`` where it starts
  with the query (a fuzzy leaf only), and a posting's score is its stored
  score times its term's. A document takes the best of its postings;
* an OR of leaves puts the leaves with the same term string in one slot
  (the best of them); a document scores the sum of its slots times the
  square of the number of its slots that reach 1e-5;
* an AND of such groups sums them, where the document scored in every one.

Every document with a score above 0 is a hit; the answer is the hit count
and the ``top`` best (score descending, then document id descending).

Arithmetic is float32, in the order veloci sums (slots and groups in the
reverse of their order). ``precision="bfloat16"`` rounds every value to
bfloat16 instead: the control that a comparison has to reject.
"""

from __future__ import annotations

import json
from typing import Dict, List, NamedTuple

import numpy as np

from . import levenshtein
from .index import ReferenceIndex

F32 = np.float32
HIT_GATE = F32(1e-5)


class Answer(NamedTuple):
    ids: np.ndarray  # [<= top] int64
    scores: np.ndarray  # [<= top] float32
    num_hits: int


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round float32 values to the nearest bfloat16 (ties to even), kept in
    float32."""
    u = np.asarray(x, dtype=F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def _normalize(node):
    """A request tree with one-kind nesting flattened and one-child nodes
    collapsed: ("search", leaf) or (kind, [children])."""
    if "search" in node:
        return ("search", node["search"])
    kind = "or" if "or" in node else "and"
    children = []
    for child in node[kind]["queries"]:
        c = _normalize(child)
        children.extend(c[1] if c[0] == kind else [c])
    return children[0] if len(children) == 1 else (kind, children)


def _groups(tree) -> List[List[dict]]:
    """The tree as groups of leaves under an AND (an OR is one group)."""
    if tree[0] == "search":
        return [[tree[1]]]
    if tree[0] == "or" and all(c[0] == "search" for c in tree[1]):
        return [[c[1] for c in tree[1]]]
    if tree[0] == "and":
        groups = []
        for c in tree[1]:
            if c[0] == "search":
                groups.append([c[1]])
            elif c[0] == "or" and all(g[0] == "search" for g in c[1]):
                groups.append([g[1] for g in c[1]])
            else:
                raise NotImplementedError("the reference answers AND of ORs of leaves")
        return groups
    raise NotImplementedError("the reference answers AND of ORs of leaves")


class Reference:
    """Answers requests on one :class:`ReferenceIndex` in ``precision``
    ("float32", or "bfloat16" for the control)."""

    def __init__(self, index: ReferenceIndex, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(precision)
        self.index = index
        self.round = (lambda x: np.asarray(x, dtype=F32)) if precision == "float32" else _bf16
        self._encoded: Dict[str, tuple] = {}
        self._matches: Dict[tuple, tuple] = {}
        self._answers: Dict[str, Answer] = {}

    # ------------------------------------------------------------ leaves
    def _terms(self, field: str):
        """The field's terms lowercased, sorted by length: (lowercased terms,
        term numbers, lengths, code points ``[T, W]``, character counts
        ``[T, 32]`` by code point mod 32), all in that order."""
        hit = self._encoded.get(field)
        if hit is None:
            lows = [t.lower() for t in self.index.fields[field].terms]
            codes, lengths = levenshtein.encode(lows)
            order = np.argsort(lengths, kind="stable")
            codes, lengths = codes[order], lengths[order]
            rows = np.repeat(np.arange(len(lows), dtype=np.int64), codes.shape[1])
            valid = codes.ravel() >= 0
            bins = rows[valid] * 32 + codes.ravel()[valid] % 32
            counts = np.bincount(bins, minlength=len(lows) * 32).reshape(len(lows), 32)
            hit = self._encoded[field] = (lows, order, lengths, codes, counts.clip(max=127).astype(np.int8))
        return hit

    def _near(self, field: str, query: str, d: int):
        """The field's terms within ``d`` edits of ``query``: (term numbers,
        distances). Only terms that could be are given to the DP: a term
        within ``d`` edits has a length within ``d`` of the query's, and
        neither string has more than ``d`` characters (counted by code
        point mod 32) that the other lacks, since an edit removes at most
        one character and adds at most one."""
        _lows, order, lengths, codes, counts = self._terms(field)
        q = np.zeros(32, np.int8)
        for c in query:
            q[ord(c) % 32] += 1
        lo, hi = np.searchsorted(lengths, [len(query) - d, len(query) + d + 1])
        diff = counts[lo:hi] - q
        cand = lo + np.flatnonzero((np.maximum(diff, 0).sum(1) <= d) & (np.maximum(-diff, 0).sum(1) <= d))
        if not len(cand):
            return cand, cand
        dist = levenshtein.distances(query, codes[cand, : len(query) + d], lengths[cand])
        keep = dist <= d
        return order[cand[keep]], dist[keep]

    def matches(self, leaf: dict):
        """A leaf's matched terms on its field: ``(field, term numbers,
        term scores)``."""
        if leaf.get("starts_with") or leaf.get("is_regex") or leaf.get("ignore_case") is False \
                or len(leaf["terms"]) != 1 or leaf.get("boost") is not None or leaf.get("top") is not None:
            raise NotImplementedError("the reference answers one-term exact and fuzzy leaves")
        field = leaf["path"][: -len(".textindex")] if leaf["path"].endswith(".textindex") else leaf["path"]
        query = leaf["terms"][0].lower()
        d = min(int(leaf.get("levenshtein_distance") or 0), max(len(query) - 1, 0))
        key = (field, query, d)
        hit = self._matches.get(key)
        if hit is not None:
            return hit
        f = self.index.fields.get(field)
        if f is None:
            hit = (field, np.zeros(0, np.int64), np.zeros(0, F32))
        elif d == 0:
            ids = np.array(sorted(f.by_lower.get(query, [])), dtype=np.int64)
            hit = (field, ids, self._term_score(np.zeros(len(ids)), np.zeros(len(ids), bool)))
        else:
            ids, dist = self._near(field, query, d)
            lows = self._terms(field)[0]
            prefix = np.array([lows[i].startswith(query) for i in ids.tolist()], dtype=bool)
            hit = (field, ids, self._term_score(dist, prefix))
        self._matches[key] = hit
        return hit

    def _term_score(self, distance, prefix) -> np.ndarray:
        d = np.asarray(distance, dtype=F32)
        r = self.round
        with_prefix = r(F32(2.0) / r(r(np.log2(d + F32(1.0))) + F32(0.2)))
        without = r(F32(2.0) / r(d + F32(0.2)))
        return np.where(prefix, with_prefix, without).astype(F32)

    # ------------------------------------------------------------ trees
    def answer(self, request: dict) -> Answer:
        """The request's answer; a request asked again is answered from memory."""
        key = json.dumps(request, sort_keys=True)
        hit = self._answers.get(key)
        if hit is None:
            hit = self._answers[key] = self._answer(request)
        return hit

    def _answer(self, request: dict) -> Answer:
        r = self.round
        n = self.index.num_docs
        groups = _groups(_normalize(request["search_req"]))
        total = np.zeros(n, F32)
        scored = np.zeros(n, np.int64)
        present_any = np.zeros(n, bool)
        for leaves in reversed(groups):
            slots: Dict[str, np.ndarray] = {}
            for leaf in leaves:
                field, ids, tscores = self.matches(leaf)
                best = slots.setdefault(leaf["terms"][0], np.full(n, -np.inf, F32))
                f = self.index.fields.get(field)
                for t, ts in zip(ids.tolist(), tscores):
                    docs, scores = f.postings(t)
                    best[docs] = np.maximum(best[docs], r(scores * r(ts)))
            gsum = np.zeros(n, F32)
            count = np.zeros(n, np.int64)
            present = np.zeros(n, bool)
            for term in sorted(slots, reverse=True):
                vals = slots[term]
                here = vals > -np.inf
                gsum = np.where(here, r(gsum + np.where(here, vals, F32(0))), gsum)
                count += here & (vals >= HIT_GATE)
                present |= here
            cnt = count.astype(F32)
            gscore = np.where(count > 0, r(r(gsum * cnt) * cnt), F32(0)).astype(F32)
            total = np.where(present, r(total + gscore), total)
            scored += gscore > 0
            present_any |= present
        final = np.where(present_any & (scored >= len(groups)), total, F32(0))
        hits = np.flatnonzero(final > 0)
        top = int(request.get("top", 10)) + int(request.get("skip") or 0)
        order = np.lexsort((-hits, -final[hits].astype(np.float64)))[:top]
        keep = hits[order][int(request.get("skip") or 0):]
        return Answer(keep.astype(np.int64), final[keep].astype(F32), int(len(hits)))

    def posting_rows(self, request: dict) -> int:
        """The posting rows the request needs, each (term, field) once."""
        seen = set()
        rows = 0
        for leaves in _groups(_normalize(request["search_req"])):
            for leaf in leaves:
                field, ids, _ = self.matches(leaf)
                f = self.index.fields.get(field)
                for t in ids.tolist():
                    if (field, t) not in seen:
                        seen.add((field, t))
                        rows += f.rows(t)
        return rows

