"""Field-level term matching for exact, fuzzy, ``starts_with`` and regex
leaves, and a field's snippet search.

Counterpart of ``veloci_tpu/search/field_search.py`` (``:49-117`` scoring and
match post-processing, ``:120-401`` the batched fuzzy prefetch and the
device match, ``:404-547`` ``get_term_ids_in_field``, ``:550-602`` the
regex match, ``:605-625`` the token-value boost, ``:629-709``
``resolve_token_hits_to_text_id`` and ``highlight_field``): exact terms,
prefix ranges (``starts_with`` at distance 0), fuzzy terms at any distance,
with or without ``starts_with``, and regex terms.

A regex leaf's answer is the reference's host ``re`` scan (``:600-602``):
the terms that ``re.fullmatch``, or ``re.match`` for ``starts_with``, the
pattern, with ``IGNORECASE`` unless ``ignore_case`` is false. Kernel B8
(:func:`..ops.regex_dfa.regex_match`) prefilters every row of the field's
sweep matrix and long terms with the pattern's case-folded DFA; the rows
the DFA may misjudge join the candidates (:func:`_regex_candidates`), and
every candidate is checked with ``re``.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from ..create import BOOST_VALID_TO_VALUE, TEXTINDEX, TOKEN_VALUES, TOKENS_TO_TEXT_ID
from ..indices import MAX_TERM_CHARS
from ..ops.levenshtein import (
    MAX_QUERY_CHARS,
    encode_query,
    levenshtein_distance_host,
    levenshtein_distances_host,
    levenshtein_rows,
    select_matches,
)
from ..ops.levenshtein_sweep import (
    levenshtein_select_banded,
    levenshtein_sweep_banded_batch,
    levenshtein_sweep_full_batch,
)
from ..ops.regex_dfa import compile_dfa, regex_match
from ..persistence import FOLD_SPECIAL, LONG_WIDTH, NONASCII
from ..query.request import DEFAULT_SNIPPET_INFO
from ..utils import normalize_text
from .boost import apply_boost_scalar
from .highlight import highlight_document
from .result import FieldSearchResult

__all__ = [
    "get_default_score_for_distance",
    "prefetch_fuzzy_matches",
    "get_term_ids_in_field",
    "search_field",
    "fuzzy_spec",
    "leaf_fuzzy",
    "leaf_path",
    "highlight_field",
    "match_term_ids",
    "resolve_token_hits_to_text_id",
    "leaf_field",
    "clamped_distance",
    "regex_dfa",
    "sweep_kernel",
    "sweep_launches",
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


def leaf_path(part) -> str:
    """The leaf's field path with ``.textindex``."""
    return part.path if part.path.endswith(TEXTINDEX) else part.path + TEXTINDEX


def fuzzy_spec(part):
    """The leaf's prefetch spec ``(field, lower_term, distance,
    starts_with)`` (:func:`prefetch_fuzzy_matches`), or None for a leaf
    that is not fuzzy."""
    d = clamped_distance(part)
    if d == 0 or part.is_regex:
        return None
    return leaf_field(part), part.terms[0].lower(), d, bool(part.starts_with)


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


def sweep_launches(specs) -> Dict[Tuple[str, bool], list]:
    """The sweep launches that serve fuzzy ``specs``: per ``(field, full)``
    the items ``(lower_term, distance, starts_with)`` of one launch, where
    ``full`` marks the specs whose matches need the full distance or the
    distance over term prefixes (``starts_with``, or a distance past the
    band). Specs longer than 31 chars take none: :func:`match_term_ids`'
    host loop matches them."""
    launches: Dict[Tuple[str, bool], list] = {}
    for field, lower_term, distance, starts_with in sorted(set(specs)):
        if len(lower_term) <= MAX_QUERY_CHARS - 1:
            full = starts_with or distance > MAX_BAND
            launches.setdefault((field, full), []).append((lower_term, distance, starts_with))
    return launches


def sweep_kernel(items) -> str:
    """The kernel :func:`_select` launches for one launch's ``items``:
    "select" (the fused select, for a lone item the band holds), "banded"
    (the batched banded sweep) or "full" (the full-width sweep)."""
    if any(sw or d > MAX_BAND for _t, d, sw in items):
        return "full"
    return "select" if len(items) == 1 else "banded"


def _select(sweep, items):
    """One launch over ``sweep`` for ``items`` [(lower_term, distance,
    starts_with)], matched on the prefix distance for ``starts_with`` and
    on the distance otherwise -> per item (sweep ids, distances, is_prefix).
    A lone item the band holds takes the fused select, whose kernel writes
    only the matches; every other set one sweep and ``select_matches``."""
    dev = sweep.chars_t.device
    kernel = sweep_kernel(items)
    if kernel == "select":
        lower_term, distance, _sw = items[0]
        query, qlen = encode_query(lower_term)
        return [levenshtein_select_banded(
            sweep.chars_t, sweep.lengths, sweep.sweep_ids, query, qlen, _band(items), distance)]
    dist, prefix_dist, ispref = _sweep(sweep, items, kernel == "full")
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
    :func:`match_term_ids`, as in the reference."""
    out = {}
    for (field, _full), items in sweep_launches(specs).items():
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


def _dfa_escapes(pattern: str) -> Tuple[bool, bool]:
    """``(reads_like_re, shorthand)`` for a pattern that ``re`` compiled.

    ``reads_like_re``: :func:`..ops.regex_dfa.compile_dfa` reads each of
    the pattern's escapes as ``re`` does: ``\\d``, ``\\w``, ``\\s`` anywhere,
    ``\\D``, ``\\W``, ``\\S`` outside a class, and an escaped char that is
    not an ASCII letter or digit. Its parser reads any other escaped letter
    or digit as that char, where ``re`` reads a control char (``\\t``), a code
    point (``\\x41``, ``\\u00e9``), a backreference (``\\1``), an anchor
    (``\\A``, ``\\Z``), or, in a class, a complemented shorthand (``[\\W]``).
    ``shorthand``: the pattern has ``\\d``, ``\\w`` or ``\\s``, which ``re``
    extends past ASCII."""
    i, in_class, first, shorthand = 0, False, False, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\":
            e = pattern[i + 1 : i + 2]
            if e.isascii() and e.isalnum() and e not in ("dws" if in_class else "dwsDWS"):
                return False, shorthand
            shorthand = shorthand or e in ("d", "w", "s")
            i, first = i + 2, False
            continue
        if in_class:
            in_class = not (c == "]" and not first)
            first = False
        elif c == "[":
            in_class = first = True
            if pattern[i + 1 : i + 2] == "^":
                i += 1
        i += 1
    return True, shorthand


def _regex_candidates(index, field: str, dfa, shorthand: bool, prefix: bool) -> np.ndarray:
    """The field's term ids that may match: every row kernel B8 accepts,
    over the sweep matrix (rows mapped through its ``sweep_ids``, never
    taken as term ids) and over the long terms' codes, and the rows the
    DFA may misjudge (:func:`..persistence.regex_flags`): FOLD_SPECIAL
    rows always, NONASCII rows for a pattern with ``\\d``, ``\\w`` or
    ``\\s``, long terms past ``LONG_WIDTH`` chars, and the terms in no row.
    Sorted, unique."""
    rr = index.regex_rows[field]
    force = FOLD_SPECIAL | (NONASCII if shorthand else 0)
    sweep, long = index.fields[field], index.long_terms[field]
    walks = []
    if sweep.lengths.shape[0]:
        walks.append((regex_match(sweep.chars_t, sweep.lengths, dfa, prefix),
                      rr.sweep_flags, np.zeros(len(rr.sweep_flags), bool), rr.sweep_ids))
    if len(long.ids):
        walks.append((regex_match(long.codes.T, long.lengths, dfa, prefix),
                      rr.long_flags, long.host_lengths > LONG_WIDTH, long.ids))
    parts = [rr.unswept]
    for hit, flags, past, ids in walks:
        parts.append(ids[np.flatnonzero(hit.cpu().numpy() | ((flags & force) != 0) | past)])
    return np.unique(np.concatenate(parts).astype(np.int64))


def regex_dfa(part):
    """A regex leaf's matcher and DFA -> (``re`` match function, the DFA or
    None, whether the pattern uses ``\\d``, ``\\w`` or ``\\s``). The pattern is
    the term when ``re`` compiles it, else the escaped term; the DFA is
    compiled from that same pattern, case-folded (a superset), and is None
    for a pattern outside ASCII or one that
    :func:`..ops.regex_dfa.compile_dfa` does not read as ``re`` does or
    refuses."""
    term = part.terms[0]
    flags = re.IGNORECASE if (part.ignore_case if part.ignore_case is not None else True) else 0
    try:
        pattern = re.compile(term, flags)
    except re.error:
        pattern = re.compile(re.escape(term), flags)
    fn = pattern.match if part.starts_with else pattern.fullmatch
    dfa, shorthand = None, False
    if pattern.pattern.isascii():
        reads_like_re, shorthand = _dfa_escapes(pattern.pattern)
        if reads_like_re:
            dfa = compile_dfa(pattern.pattern, ignore_case=True)
    return fn, dfa, shorthand


def _match_regex(index, part) -> np.ndarray:
    """A regex leaf's matched term ids, ascending (``_match_regex``,
    ``:550-602``, with the answer of its host scan): kernel B8 walks the
    leaf's DFA (:func:`regex_dfa`), and a leaf without one scans the
    dictionary with ``re`` on the host. Each outcome is
    counted on ``index.path_counts`` ("regex_dfa", "regex_host_scan")."""
    field = leaf_field(part)
    terms = index.get_dictionary(field).terms
    fn, dfa, shorthand = regex_dfa(part)
    if dfa is None:
        index.count_path("regex_host_scan")
        return np.array([i for i, t in enumerate(terms) if fn(t)], dtype=np.int64)
    index.count_path("regex_dfa")
    cand = _regex_candidates(index, field, dfa, shorthand, bool(part.starts_with))
    return np.array([i for i in cand.tolist() if fn(terms[i])], dtype=np.int64)


def _regex_distances(index, field: str, matched: np.ndarray, lower_term: str):
    """Per matched term of a regex leaf, ``(distance, starts)`` as the
    reference's exact path takes them (``:500-510``): ``starts`` when the
    lowercased term starts with the lowercased pattern, and then the
    distance ``|term| - |pattern|``, else ``levenshtein_distance_host``.

    For a pattern of at most 32 chars, the terms in the sweep matrix take
    one full-width launch (B3) with the pattern as the query, over their
    rows gathered (when no char of the pattern is U+FFFD or beyond: the
    matrix stores code points past 0xFFFF as U+FFFD), and the long terms
    one batched distance pass over their exact codes
    (:func:`..ops.levenshtein.levenshtein_rows`, 255 from 255 chars on, as
    the host distance caps). The rest take the vectorised host distance."""
    dictionary = index.get_dictionary(field)
    lengths = dictionary.char_lengths()[matched].astype(np.int64) - len(lower_term)
    dist = np.empty(len(matched), dtype=np.int64)
    starts = np.zeros(len(matched), dtype=bool)
    done = np.zeros(len(matched), dtype=bool)
    query, qlen = encode_query(lower_term)
    if qlen == len(lower_term):
        sweep, long = index.fields[field], index.long_terms[field]
        dev = sweep.chars_t.device
        rows = index.regex_rows[field].row_of[matched]
        swept = rows >= 0
        if swept.any() and all(ord(c) < 0xFFFD for c in lower_term):
            r = torch.from_numpy(rows[swept]).to(dev)
            # the gather on the int16 view: CUDA has no uint16 index kernel
            chars = sweep.chars_t.view(torch.int16)[:, r].contiguous().view(torch.uint16)
            d, _pd, isp = levenshtein_sweep_full_batch(
                chars, sweep.lengths[r].contiguous(),
                torch.from_numpy(query[None]).to(dev), torch.tensor([qlen], dtype=torch.int32, device=dev))
            isp = isp[0].cpu().numpy()
            starts[swept], done[swept] = isp, True
            dist[swept] = np.where(isp, lengths[swept], d[0].cpu().numpy())
        pos = np.searchsorted(long.ids, matched)
        in_long = pos < len(long.ids)
        in_long[in_long] = long.ids[pos[in_long]] == matched[in_long]
        if in_long.any():
            q32 = np.full((1, MAX_QUERY_CHARS), -1, dtype=np.int32)
            q32[0, :qlen] = np.frombuffer(lower_term.encode("utf-32-le"), dtype=np.int32)
            r = torch.from_numpy(pos[in_long]).to(dev)
            d, _pd, isp = levenshtein_rows(
                long.codes, long.lengths, torch.from_numpy(q32).to(dev),
                torch.tensor([qlen], dtype=torch.int32, device=dev), r, torch.zeros_like(r))
            isp = isp.cpu().numpy()
            starts[in_long], done[in_long] = isp, True
            dist[in_long] = np.where(isp, lengths[in_long], d.cpu().numpy())
    rest = np.flatnonzero(~done)
    if len(rest):
        lows = [dictionary.terms[int(t)].lower() for t in matched[rest]]
        is_p = np.fromiter((lo.startswith(lower_term) for lo in lows), dtype=bool, count=len(lows))
        starts[rest] = is_p
        dist[rest] = np.where(is_p, lengths[rest], levenshtein_distances_host(lower_term, lows))
    return dist, starts


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
    if part.is_regex:
        return _match_regex(index, part), None, None
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


def search_field(
    index, part, fuzzy_matches, *, store_term_id_hits: bool = False, store_term_texts: bool = False,
    return_term: bool = False, return_term_lowercase: bool = False,
) -> FieldSearchResult:
    """The leaf's field search (``get_term_ids_in_field``, ``:404-546``): its
    matched term ids (ascending) and their f32 scores, from
    :func:`match_term_ids`. Leaf ``boost`` multiplies the scores, leaf
    ``top`` (+ ``skip``) keeps the best-scoring terms, and a
    ``token_value`` boost then applies per term (search_field.rs:391-395).

    On request, beside them: the kept terms' texts, as stored or lowercased
    (``return_term``, ``return_term_lowercase``, or ``store_term_texts``),
    in ``terms``; ``{path: {first term: kept ids}}`` in
    ``term_id_hits_in_field`` (``store_term_id_hits``) and ``{path: kept
    texts}`` in ``term_text_in_field`` (``store_term_texts``)."""
    path = leaf_path(part)
    result = FieldSearchResult(path=path, request=part)
    matched, aligned_dists, aligned_prefixes = match_term_ids(index, part, fuzzy_matches)
    if len(matched):
        result.term_ids, result.term_scores = _scored(index, part, matched, aligned_dists, aligned_prefixes)
    if return_term or store_term_texts:
        terms = index.get_dictionary(leaf_field(part)).terms
        for tid in result.term_ids.tolist():
            result.terms[tid] = terms[tid].lower() if return_term_lowercase else terms[tid]
    if store_term_id_hits and len(result.term_ids):
        result.term_id_hits_in_field[path] = {part.terms[0]: result.term_ids.tolist()}
    if store_term_texts and result.terms:
        result.term_text_in_field[path] = list(result.terms.values())
    return result


def get_term_ids_in_field(index, part, fuzzy_matches) -> Tuple[np.ndarray, np.ndarray]:
    """The leaf's matched term ids (ascending) and their f32 scores
    (:func:`search_field` without its metadata)."""
    res = search_field(index, part, fuzzy_matches)
    return res.term_ids, res.term_scores


def _scored(index, part, matched, aligned_dists, aligned_prefixes):
    """The matched ids' scores, then the leaf's boost, ``top`` and
    ``token_value`` boost -> (kept ids, their scores)."""
    dictionary = index.get_dictionary(leaf_field(part))
    lower_term = part.terms[0].lower()
    starts_with = bool(part.starts_with)
    if aligned_dists is not None:
        distances = aligned_dists
        prefix_matches = aligned_prefixes  # distance != 0: prefixes count
    elif part.is_regex:
        # the exact path's distances (:500-510); prefixes count for
        # starts_with or a distance (:487)
        distances, prefix_matches = _regex_distances(index, leaf_field(part), matched, lower_term)
        prefix_matches &= starts_with or clamped_distance(part) != 0
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


def leaf_fuzzy(index, part):
    """:func:`prefetch_fuzzy_matches` for one leaf alone."""
    spec = fuzzy_spec(part)
    return {} if spec is None else prefetch_fuzzy_matches(index, [spec])


def resolve_token_hits_to_text_id(index, request, result, add_snippets: bool = False):
    """Token-level hits -> text-id-level hits, optionally with snippets
    (``:629-688``; reference search_field.rs:519-608): each matched token
    maps to the text ids containing it via ``.tokens_to_text_id``; per
    text id the token score of the largest magnitude wins; with
    ``add_snippets`` the text is rebuilt from its token ids and
    highlighted."""
    path = result.path
    if not index.tokenize_enabled(path):
        return result
    tta = index.key_value_stores.get(path + TOKENS_TO_TEXT_ID)
    if tta is None:
        return result

    token_hits = []  # (text_id, score, token_id)
    for tid, score in zip(result.term_ids, result.term_scores):
        for p in tta.get_values(int(tid)):
            token_hits.append((int(p), float(score), int(tid)))
    token_hits.sort(key=lambda el: el[0])

    if token_hits:
        new_ids = []
        new_scores = []
        i = 0
        while i < len(token_hits):
            j = i
            group_tokens = []
            best = None
            text_id = token_hits[i][0]
            while j < len(token_hits) and token_hits[j][0] == text_id:
                _t, sc, tok = token_hits[j]
                if best is None or abs(sc) > abs(best):
                    best = sc
                group_tokens.append(tok)
                j += 1
            new_ids.append(text_id)
            new_scores.append(best)
            if add_snippets:
                snippet_info = request.snippet_info or DEFAULT_SNIPPET_INFO
                highlighted = highlight_document(index, path, text_id, group_tokens, snippet_info)
                if highlighted is not None:
                    result.highlight[text_id] = highlighted
            i = j
        result.term_ids = np.asarray(new_ids, dtype=np.int64)
        result.term_scores = np.asarray(new_scores, dtype=_F32)
    return result


def highlight_field(index, request):
    """A field's snippet search (``:691-709``, reference
    search_field.rs:233-245 ``highlight``): the leaf's terms normalised,
    matched and resolved to the texts that hold them, each text
    highlighted -> ``[(snippet, score, text id)]`` by score, then ``skip``
    and ``top``."""
    request.terms = [normalize_text(t) for t in request.terms]
    result = search_field(index, request, leaf_fuzzy(index, request))
    resolve_token_hits_to_text_id(index, request, result, add_snippets=True)
    out = []
    for tid, score in zip(result.term_ids, result.term_scores):
        text = result.highlight.get(int(tid))
        if text is not None:
            out.append((text, float(score), int(tid)))
    out.sort(key=lambda el: -el[1])
    out = out[request.skip or 0 :]
    if request.top is not None:
        out = out[: request.top]
    return out


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
