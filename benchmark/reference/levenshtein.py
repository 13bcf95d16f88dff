"""Levenshtein distance as the plain dynamic programme over the table
``D[i][j]`` (the edits that turn the first ``i`` characters of one string
into the first ``j`` of the other), in two forms: one pair at a time in
Python, and one query against many terms at once with NumPy, row by row of
the table. Both give the exact distance."""

from __future__ import annotations

import numpy as np


def distance(a: str, b: str) -> int:
    """The edit distance between ``a`` and ``b`` (insert, delete, substitute,
    each costing 1)."""
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i] + [0] * len(b)
        for j, cb in enumerate(b, 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (ca != cb))
        prev = cur
    return prev[len(b)]


def encode(terms) -> tuple:
    """Terms -> (code points ``[N, W]`` int32, -1 past each end; lengths ``[N]``)."""
    lengths = np.fromiter((len(t) for t in terms), dtype=np.int64, count=len(terms))
    width = int(lengths.max()) if len(terms) else 0
    codes = np.full((len(terms), width), -1, dtype=np.int32)
    for row, t in enumerate(terms):
        codes[row, : len(t)] = np.frombuffer(t.encode("utf-32-le"), dtype=np.int32)
    return codes, lengths


def distances(query: str, codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The edit distance between ``query`` and each encoded term.

    Row ``i`` of the table is computed from row ``i - 1`` for every term at
    once: ``D[i][j]`` is the least of a deletion ``D[i-1][j] + 1``, a
    substitution or match ``D[i-1][j-1] + (q_i != t_j)`` and an insertion
    ``D[i][j-1] + 1``; the insertions chain along the row, which a running
    minimum of ``D[i][j] - j`` resolves."""
    n, w = codes.shape
    js = np.arange(w + 1, dtype=np.int64)
    row = np.broadcast_to(js, (n, w + 1)).copy()
    for i, ch in enumerate(query, 1):
        cur = np.empty_like(row)
        cur[:, 0] = i
        np.minimum(row[:, 1:] + 1, row[:, :-1] + (codes != ord(ch)), out=cur[:, 1:])
        row = np.minimum.accumulate(cur - js, axis=1) + js
    return row[np.arange(n), lengths]
