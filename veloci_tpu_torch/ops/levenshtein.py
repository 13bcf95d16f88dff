"""Query encoding, match selection and host distances for the fuzzy sweep.

Counterpart of ``veloci_tpu/ops/levenshtein.py``. The sweep itself is in
:mod:`veloci_tpu_torch.ops.levenshtein_sweep`; this module turns its
``[Q, N]`` outputs into per-query match lists.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "MAX_QUERY_CHARS",
    "BIG",
    "encode_query",
    "select_matches",
    "levenshtein_distance_host",
    "levenshtein_prefix_distance_host",
    "levenshtein_distances_host",
    "levenshtein_rows",
]

MAX_QUERY_CHARS = 32
BIG = 1 << 20  # distance reported for rows of length 0 (and outside a band)


def encode_query(query: str) -> tuple[np.ndarray, int]:
    """Query string -> padded uint16 codepoint vector + length."""
    q = np.zeros(MAX_QUERY_CHARS, dtype=np.uint16)
    n = min(len(query), MAX_QUERY_CHARS)
    for i, ch in enumerate(query[:n]):
        cp = ord(ch)
        q[i] = cp if cp <= 0xFFFF else 0xFFFD
    return q, n


def select_matches(
    dist: torch.Tensor,  # [Q, N] int32
    is_prefix: torch.Tensor,  # [Q, N] bool
    crit: torch.Tensor,  # [Q, N] int32 matching criterion
    distance: torch.Tensor,  # [Q] int32
    remap: torch.Tensor | None = None,  # [N] int32 sweep row -> term id
):
    """Every sweep row with ``crit <= distance``, for each query.

    Returns flat ``(query_rows, term_ids, dists, prefixes)`` ordered by
    (query row, distance asc, sweep row asc): the order in which the
    reference's top-M selection lists a query's matches. Term ids are the
    sweep rows, remapped through ``remap`` when it is given. Nothing is
    truncated: the caller gets every match."""
    match = crit <= distance.to(crit.dtype)[:, None]
    rows, cols = torch.nonzero(match, as_tuple=True)
    d = dist[rows, cols]
    order = torch.argsort(rows * (BIG + 1) + d.to(torch.int64), stable=True)
    rows, cols, d = rows[order], cols[order], d[order]
    ids = remap[cols] if remap is not None else cols
    return rows, ids.to(torch.int64), d, is_prefix[rows, cols]


def levenshtein_distance_host(a: str, b: str) -> int:
    """Plain char-level Levenshtein distance (reference search_field.rs:705-732)."""
    if len(a) >= 255 or len(b) >= 255:
        return 255
    prev = list(range(len(a) + 1))
    for x, cb in enumerate(b):
        cur = [x + 1] + [0] * len(a)
        for y, ca in enumerate(a):
            cur[y + 1] = min(prev[y + 1] + 1, cur[y] + 1, prev[y] + (ca != cb))
        prev = cur
    return prev[len(a)]


def levenshtein_prefix_distance_host(query: str, candidate: str) -> int:
    """min over candidate prefixes P of lev(query, P): the starts_with
    criterion (reference ``veloci_tpu/ops/levenshtein.py:172-184``)."""
    prev = list(range(len(query) + 1))
    best = prev[-1]
    for x, cc in enumerate(candidate):
        cur = [x + 1] + [0] * len(query)
        for y, qc in enumerate(query):
            cur[y + 1] = min(prev[y + 1] + 1, cur[y] + 1, prev[y] + (qc != cc))
        prev = cur
        best = min(best, prev[-1])
    return best


_ROWS_CHUNK_ELEMS = 1 << 22  # DP cells per chunk of levenshtein_rows


def levenshtein_rows(codes, lengths, queries, query_lens, rows, query_of):
    """Exact distances for (row, query) pairs, in plain torch on the rows'
    device: the row recurrence of ``levenshtein_sweep`` (each query char
    relaxes a whole DP row, left-to-right inserts by a running minimum),
    vectorised over the pairs.

    ``codes [R, W]`` int32 code points (-1 past each row's end),
    ``lengths [R]`` int32 char counts (a row of 255 chars or more has
    distance 255, as :func:`levenshtein_distance_host` says),
    ``queries [Q, 32]`` int32 code points of queries of at most 32 chars,
    ``query_lens [Q]``; ``rows``, ``query_of`` [P] int64 name the pairs.
    Returns per pair ``(dist, prefix_dist, is_prefix)``: the distance, its
    minimum over the row's prefixes of at most ``W`` chars, and whether the
    row starts with the query."""
    dev = codes.device
    out = [torch.empty(rows.shape, dtype=dt, device=dev) for dt in (torch.int32, torch.int32, torch.bool)]
    step = max(1, _ROWS_CHUNK_ELEMS // (codes.shape[1] + 1))
    for lo in range(0, rows.numel(), step):
        r, q = rows[lo : lo + step], query_of[lo : lo + step]
        ql = query_lens[q]
        # longest queries first: the pairs a query char relaxes are a prefix
        ql, order = torch.sort(ql, descending=True, stable=True)
        r, q = r[order], q[order]
        neg_ql = -ql.cpu().numpy()
        lens = lengths[r]
        w = min(int(lens.max()), codes.shape[1])
        c, qs = codes[r, :w], queries[q]
        js = torch.arange(w + 1, dtype=torch.int32, device=dev)
        d = js.repeat(r.numel(), 1)
        for i in range(1, int(-neg_ql[0]) + 1):
            k = int(np.searchsorted(neg_ql, -i, side="right"))  # pairs with ql >= i
            cost = (c[:k] != qs[:k, i - 1 : i]).to(torch.int32)
            sub = torch.minimum(d[:k, 1:] + 1, d[:k, :-1] + cost)
            base = torch.cat([torch.full((k, 1), i, dtype=torch.int32, device=dev), sub], 1)
            d[:k] = torch.cummin(base - js, dim=1).values + js
        end = lens.clamp(max=w).to(torch.int64)
        dist = d.gather(1, end[:, None])[:, 0]
        dist = torch.where(lens >= 255, 255, dist)
        prefix = torch.where(js <= end[:, None], d, BIG).amin(1)
        m = min(w, 32)
        pos = torch.arange(m, device=dev)
        same = (c[:, :m] == qs[:, :m]) | (pos >= ql[:, None])
        is_prefix = (lens >= ql) & (lens > 0) & same.all(1)
        sl = slice(lo, lo + r.numel())
        for o, v in zip(out, (dist, prefix, is_prefix)):
            o[sl][order] = v
    return tuple(out)


def levenshtein_distances_host(query: str, terms) -> np.ndarray:
    """``levenshtein_distance_host(query, t)`` for each of ``terms``,
    vectorised over the terms with numpy (the row recurrence of
    ``levenshtein_sweep``: each query character relaxes a whole row,
    left-to-right inserts by a running minimum). Exact: terms are cut at
    255 chars, where the host distance caps."""
    width = 255
    n = len(terms)
    lens = np.fromiter((len(t) for t in terms), dtype=np.int64, count=n)
    m = int(min(lens.max(), width)) if n else 0
    codes = np.full((n, m), -1, dtype=np.int64)
    for row, t in enumerate(terms):
        cps = np.frombuffer(t[:width].encode("utf-32-le"), dtype=np.uint32)
        codes[row, : len(cps)] = cps
    js = np.arange(m + 1, dtype=np.int64)
    rows = np.broadcast_to(js, (n, m + 1)).copy()  # D[0][j] = j
    for i, ch in enumerate(query, start=1):
        base = np.minimum(rows + 1, np.concatenate(
            [np.full((n, 1), 1 << 30), rows[:, :-1] + (codes != ord(ch))], axis=1
        ))
        base[:, 0] = i
        rows = np.minimum.accumulate(base - js, axis=1) + js
    end = np.minimum(lens, m)
    dist = rows[np.arange(n), end]
    return np.where((lens >= 255) | (len(query) >= 255), 255, dist)
