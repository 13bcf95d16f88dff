"""Field-level term matching for exact, fuzzy and ``starts_with`` leaves.

Counterpart of ``veloci_tpu/search/field_search.py`` (``:49-117`` scoring and
match post-processing, ``:120-401`` the batched fuzzy prefetch and the
device match, ``:404-547`` ``get_term_ids_in_field``, ``:605-625`` the
token-value boost), for leaves of one term without regex: exact terms,
prefix ranges (``starts_with`` at distance 0), and fuzzy terms at any
distance, with or without ``starts_with``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..create import BOOST_VALID_TO_VALUE, TEXTINDEX, TOKEN_VALUES
from ..indices import MAX_TERM_CHARS
from ..ops.levenshtein import (
    MAX_QUERY_CHARS,
    encode_query,
    levenshtein_distance_host,
    levenshtein_distances_host,
    levenshtein_rows,
    select_matches,
)
from .boost import apply_boost_scalar
from ..ops.levenshtein_sweep import (
    levenshtein_select_banded,
    levenshtein_sweep_banded_batch,
    levenshtein_sweep_full_batch,
)

__all__ = [
    "get_default_score_for_distance",
    "prefetch_fuzzy_matches",
    "get_term_ids_in_field",
    "match_term_ids",
    "leaf_field",
    "clamped_distance",
]

_F32 = np.float32
MAX_BAND = 4  # the widest band of the banded sweep kernel


def get_default_score_for_distance(distance, prefix_matches):
    """Reference search_field.rs:27-33 (f32 arithmetic)."""
    distance = np.asarray(distance, dtype=_F32)
    with_prefix = _F32(2.0) / (np.log2(distance + _F32(1.0)) + _F32(0.2))
    without = _F32(2.0) / (distance + _F32(0.2))
    return np.where(prefix_matches, with_prefix, without).astype(_F32)


def leaf_field(part) -> str:
    path = part.path
    return path[: -len(TEXTINDEX)] if path.endswith(TEXTINDEX) else path


def clamped_distance(part) -> int:
    """The leaf's edit distance, clamped to term length - 1
    (search_field.rs:285-287); 0 means exact."""
    d = part.levenshtein_distance
    if d is None:
        return 0
    return min(d, max(len(part.terms[0].lower()) - 1, 0))


def _long_matches(long, items):
    """Per item ``(lower_term, distance, starts_with)``, its matches among
    the field's terms longer than the sweep matrix (:69-94): ``(term ids,
    distances, is_prefix)``, matched on the prefix distance for
    ``starts_with`` and on the distance otherwise.

    Candidates first. lev(a, b) >= |len(a) - len(b)|, so an item reaches a
    long term only if the term has at most ``len + distance`` chars, unless
    it matches term prefixes. A prefix within ``distance`` has at most
    ``len + distance`` chars, so a ``starts_with`` item with ``len +
    distance <= 32`` takes the rows whose first 32 chars the full-width
    sweep puts within range, a longer one every row. Then every candidate's
    distances, over its whole length, decide."""
    n = len(long.ids)
    none = (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, bool))
    if n == 0 or not items:
        return [none] * len(items)
    swept = [it for it in items if it[2] and len(it[0]) + it[1] <= MAX_TERM_CHARS]
    swept = dict(zip(swept, (rows for rows, _d, _p in _select(long.prefixes, swept)))) if swept else {}
    cand = []
    for it in items:
        lower_term, distance, starts_with = it
        if it in swept:
            cand.append(swept[it])
        elif starts_with:
            cand.append(np.arange(n, dtype=np.int64))
        elif len(lower_term) + distance > MAX_TERM_CHARS:
            cand.append(np.flatnonzero(long.host_lengths <= len(lower_term) + distance))
        else:
            cand.append(np.empty(0, np.int64))
    counts = np.array([len(c) for c in cand])
    if not counts.sum():
        return [none] * len(items)
    queries = np.full((len(items), MAX_QUERY_CHARS), -1, dtype=np.int32)
    qlens = np.zeros(len(items), dtype=np.int32)
    for k, (lower_term, _d, _sw) in enumerate(items):
        cps = np.frombuffer(lower_term.encode("utf-32-le"), dtype=np.int32)
        queries[k, : len(cps)], qlens[k] = cps, len(cps)
    dev = long.codes.device

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    rows = np.concatenate(cand).astype(np.int64)
    query_of = np.repeat(np.arange(len(items)), counts)
    dist, prefix, is_prefix = levenshtein_rows(
        long.codes, long.lengths, up(queries), up(qlens), up(rows), up(query_of)
    )
    sw = up(np.array([it[2] for it in items]))[up(query_of)]
    limit = up(np.array([it[1] for it in items], dtype=np.int32))[up(query_of)]
    keep = (torch.where(sw, prefix, dist) <= limit).cpu().numpy()
    dist, is_prefix = dist.cpu().numpy().astype(np.int64), is_prefix.cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(counts)])
    return [
        (long.ids[rows[a:b][keep[a:b]]], dist[a:b][keep[a:b]], is_prefix[a:b][keep[a:b]])
        for a, b in zip(bounds[:-1], bounds[1:])
    ]


def _merge_matches(dictionary, swept, extra):
    """The sweep's matches (pad rows dropped) and the long-term matches,
    sorted by term id."""
    ids, dists, prefixes = swept
    keep = (ids >= 0) & (ids < len(dictionary))
    matched = np.concatenate([ids[keep], extra[0]])
    dists = np.concatenate([dists[keep].astype(np.int64), extra[1]])
    prefixes = np.concatenate([prefixes[keep], extra[2]])
    order = np.argsort(matched, kind="stable")
    return matched[order], dists[order], prefixes[order]


def _band(items) -> int:
    return 2 if max(d for _t, d, _sw in items) <= 2 else 4


def _select(sweep, items):
    """One launch over ``sweep`` for ``items`` [(lower_term, distance,
    starts_with)], matched on the prefix distance for ``starts_with`` and
    on the distance otherwise -> per item (sweep ids, distances, is_prefix).
    A lone item the band holds takes the fused select, whose kernel writes
    only the matches; every other set one sweep and ``select_matches``."""
    dev = sweep.chars_t.device
    full = any(sw or d > MAX_BAND for _t, d, sw in items)
    if len(items) == 1 and not full:
        lower_term, distance, _sw = items[0]
        query, qlen = encode_query(lower_term)
        return [levenshtein_select_banded(
            sweep.chars_t, sweep.lengths, sweep.sweep_ids, query, qlen, _band(items), distance)]
    dist, prefix_dist, ispref = _sweep(sweep, items, full)
    distances = torch.tensor([d for _t, d, _sw in items], dtype=torch.int32, device=dev)
    crit = dist
    if any(sw for _t, _d, sw in items):
        sw = torch.tensor([sw for _t, _d, sw in items], dtype=torch.bool, device=dev)
        crit = torch.where(sw[:, None], prefix_dist, dist)
    rows, ids, dists, prefs = (
        t.cpu().numpy()
        for t in select_matches(dist, ispref, crit, distances, remap=sweep.sweep_ids)
    )
    bounds = np.searchsorted(rows, np.arange(len(items) + 1))
    return [
        (ids[bounds[row] : bounds[row + 1]], dists[bounds[row] : bounds[row + 1]],
         prefs[bounds[row] : bounds[row + 1]])
        for row in range(len(items))
    ]


def _sweep(sweep, items, full: bool):
    """One sweep launch over ``items`` [(lower_term, distance, starts_with)]
    -> (dist, prefix_dist, is_prefix), each [len(items), M]."""
    dev = sweep.chars_t.device
    queries = np.zeros((len(items), MAX_QUERY_CHARS), dtype=np.uint16)
    qlens = np.zeros(len(items), dtype=np.int32)
    for row, (lower_term, _d, _sw) in enumerate(items):
        queries[row], qlens[row] = encode_query(lower_term)
    q_t = torch.from_numpy(queries).to(dev)
    ql_t = torch.from_numpy(qlens).to(dev)
    if full:
        return levenshtein_sweep_full_batch(sweep.chars_t, sweep.lengths, q_t, ql_t)
    return levenshtein_sweep_banded_batch(sweep.chars_t, sweep.lengths, q_t, ql_t, band=_band(items))


def prefetch_fuzzy_matches(index, specs) -> Dict[Tuple[str, str, int, bool], tuple]:
    """Every match of every ``(field, lower_term, distance, starts_with)``
    spec. Per field, the specs the band holds (distance <= 4, no
    ``starts_with``) take ONE banded launch (the fused select when there is
    one such spec, else the batched sweep) and the others (their
    matches need the full distance, or the distance over term prefixes)
    ONE full-width launch. The field's terms longer than the sweep matrix
    take one more full-width launch over their first 32 chars for the
    ``starts_with`` specs, and one batched exact distance pass over the
    candidates (:func:`_long_matches`). A ``starts_with`` spec matches on
    its prefix distance, every other spec on its distance. Returns
    ``{spec: (term_ids, distances, is_prefix)}``, term ids ascending.
    Specs longer than 31 chars are left to the host loop of
    :func:`get_term_ids_in_field`, as in the reference."""
    launches: Dict[Tuple[str, bool], list] = {}
    for field, lower_term, distance, starts_with in sorted(set(specs)):
        if len(lower_term) <= MAX_QUERY_CHARS - 1:
            full = starts_with or distance > MAX_BAND
            launches.setdefault((field, full), []).append((lower_term, distance, starts_with))
    out = {}
    for (field, _full), items in launches.items():
        dictionary = index.get_dictionary(field)
        matches = _select(index.fields[field], items)
        extras = _long_matches(index.long_terms[field], items)
        for item, swept, extra in zip(items, matches, extras):
            out[(field, *item)] = _merge_matches(dictionary, swept, extra)
    return out


def _host_matches(dictionary, lower_term, distance, starts_with):
    """A query longer than the sweep's 31 chars: host loop over the whole
    dictionary (:451-464). A ``starts_with`` query also takes every term it
    is a prefix of."""
    lows = [t.lower() for t in dictionary.terms]
    is_p = np.fromiter((lo.startswith(lower_term) for lo in lows), dtype=bool, count=len(lows))
    near = np.fromiter(
        (abs(len(lo) - len(lower_term)) <= distance for lo in lows), dtype=bool, count=len(lows)
    )  # lev(a, b) >= |len(a) - len(b)|
    cand = np.flatnonzero(near | (is_p & starts_with))
    dist = levenshtein_distances_host(lower_term, [lows[i] for i in cand])
    keep = (dist <= distance) | (is_p[cand] & starts_with)
    return cand[keep].astype(np.int64), dist[keep].astype(np.int64), is_p[cand][keep]


def match_term_ids(index, part, fuzzy_matches):
    """The leaf's matched term ids, ascending, with the fuzzy match's
    distances and prefix flags (None unless the leaf is fuzzy):
    ``(matched, distances, is_prefix)``; ``matched`` is the reference's
    ``hits_ids``, the ids a filter or a phrase boost resolves.

    ``fuzzy_matches`` is :func:`prefetch_fuzzy_matches`' result for the
    batch. Exact terms match case-folded unless ``ignore_case`` is false;
    a ``starts_with`` leaf at distance 0 takes the dictionary's prefix
    range; fuzzy matches are re-verified against the original case when
    ``ignore_case`` is false, on the FULL distance even for ``starts_with``
    (:469-481)."""
    dictionary = index.get_dictionary(leaf_field(part))
    term = part.terms[0]
    lower_term = term.lower()
    ignore_case = part.ignore_case if part.ignore_case is not None else True
    distance = clamped_distance(part)
    starts_with = bool(part.starts_with)

    aligned_dists = aligned_prefixes = None
    if distance == 0 and not starts_with:
        if ignore_case:
            ids = dictionary.get_ignore_case(term)
        else:
            tid = dictionary.get(term)
            ids = [tid] if tid is not None else []
        matched = np.array(sorted(ids), dtype=np.int64)
    elif distance == 0:
        matched = dictionary.prefix_range_ids(term, ignore_case=ignore_case)
    else:
        if len(lower_term) > MAX_QUERY_CHARS - 1:
            matched, aligned_dists, aligned_prefixes = _host_matches(
                dictionary, lower_term, distance, starts_with
            )
        else:
            matched, aligned_dists, aligned_prefixes = fuzzy_matches[
                (leaf_field(part), lower_term, distance, starts_with)
            ]
        if not ignore_case:
            keep = np.array(
                [
                    levenshtein_distance_host(term, dictionary.terms[int(tid)]) <= distance
                    for tid in matched
                ],
                dtype=bool,
            )
            matched = matched[keep]
            aligned_dists = aligned_dists[keep]
            aligned_prefixes = aligned_prefixes[keep]
    return matched, aligned_dists, aligned_prefixes


def get_term_ids_in_field(index, part, fuzzy_matches) -> Tuple[np.ndarray, np.ndarray]:
    """The leaf's matched term ids (ascending) and their f32 scores, from
    :func:`match_term_ids`. Leaf ``boost`` multiplies the scores, leaf
    ``top`` (+ ``skip``) keeps the best-scoring terms, and a ``token_value``
    boost then applies per term (search_field.rs:391-395)."""
    matched, aligned_dists, aligned_prefixes = match_term_ids(index, part, fuzzy_matches)
    if not len(matched):
        return np.empty(0, np.int64), np.empty(0, np.float32)
    dictionary = index.get_dictionary(leaf_field(part))
    lower_term = part.terms[0].lower()
    starts_with = bool(part.starts_with)
    if aligned_dists is not None:
        distances = aligned_dists
        prefix_matches = aligned_prefixes  # distance != 0: prefixes count
    elif starts_with:
        # prefix range: every term starts with the query, so its distance is
        # |candidate| - |query| (:491-498)
        distances = dictionary.char_lengths()[matched].astype(np.int64) - len(lower_term)
        prefix_matches = np.ones(len(matched), dtype=bool)
    else:
        # exact path: distance = |candidate| - |query| when the candidate
        # starts with the query, else the true distance; prefixes do not
        # count (:487, :500-510)
        distances = np.empty(len(matched), dtype=np.int64)
        prefix_matches = np.zeros(len(matched), dtype=bool)
        for i, tid in enumerate(matched):
            lo = dictionary.terms[int(tid)].lower()
            if lo.startswith(lower_term):
                distances[i] = len(lo) - len(lower_term)
            else:
                distances[i] = levenshtein_distance_host(lower_term, lo)
    scores = get_default_score_for_distance(distances, prefix_matches)
    if part.boost is not None:
        scores = (scores * _F32(part.boost)).astype(_F32)
    if part.top is not None:
        # top-n pruning (search_field.rs:379-383): score desc, then id order
        top_n = part.top + (part.skip or 0)
        order = np.sort(np.argsort(-scores.astype(np.float64), kind="stable")[:top_n])
        matched, scores = matched[order], scores[order]
    if part.token_value is not None:
        scores = _apply_token_value_boost(index, part.token_value, matched, scores)
    return matched, scores


def _apply_token_value_boost(index, tv, term_ids, scores) -> np.ndarray:
    """Per matched term with a value in the leaf's token-value column, the
    single-hit boost (field_search.py:605-625); no column, no change."""
    boost_path = tv.path
    if not boost_path.endswith(TOKEN_VALUES):
        boost_path = boost_path + TEXTINDEX + TOKEN_VALUES
    store = index.boost_stores.get(boost_path + BOOST_VALID_TO_VALUE)
    if store is None:
        return scores
    vals, present = store
    scores = scores.copy()
    for i, tid in enumerate(term_ids):
        t = int(tid)
        if t < len(vals) and present[t]:
            scores[i] = apply_boost_scalar(scores[i], float(vals[t]), tv)
    return scores
