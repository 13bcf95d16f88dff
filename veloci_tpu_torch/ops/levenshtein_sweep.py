"""Levenshtein dictionary sweeps: CUDA kernel wrappers and plain versions.

Counterpart of the three Pallas kernels in
``veloci_tpu/ops/pallas_levenshtein.py``:

* ``levenshtein_sweep_banded_batch`` and ``levenshtein_sweep_banded``
  (``levenshtein_sweep_pallas_banded_batch`` and
  ``levenshtein_sweep_pallas_banded``) run one hand-written CUDA kernel,
  ``csrc/banded_levenshtein.cu``. For every (query, term) pair it gives the
  Levenshtein distance restricted to the diagonal band ``|i - j| <= band``
  (``BIG`` outside it), the minimum such distance over term prefixes, and
  whether the term starts with the query. A distance ``<= band`` is the
  true distance, so the matches at any ``d <= band`` are exact.
* ``levenshtein_sweep_full_batch`` (``levenshtein_sweep_pallas``, and the
  XLA sweep ``levenshtein.levenshtein_sweep`` that the JAX package runs in
  its place) runs ``csrc/full_levenshtein.cu``, a bit-parallel sweep whose
  distances are true at any size. ``starts_with`` leaves and distances
  above 4 need it. Its plain version is the DP that defines the function;
  ``levenshtein_sweep_full_batch_bitparallel`` is the kernel's algorithm in
  torch, for the tests.

``levenshtein_select_banded`` serves one query at one distance (a lone
request's fuzzy leaf): the same banded DP in a kernel of the same source
that writes only the matching rows, compacted, and reads them back in one
copy, already the per-query match list of ``select_matches``; its plain
twin is ``levenshtein_select_banded_plain``.

Rows of length 0 give ``BIG`` and ``is_prefix`` false. Each kernel's source
note says what bounds it. A tensor on the CPU takes the plain PyTorch
version; a CUDA tensor launches the kernel or raises. Each wrapper counts
its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .levenshtein import BIG, MAX_QUERY_CHARS

__all__ = [
    "levenshtein_sweep_banded_batch",
    "levenshtein_sweep_banded",
    "levenshtein_sweep_banded_batch_plain",
    "levenshtein_select_banded",
    "levenshtein_select_banded_plain",
    "levenshtein_sweep_full_batch",
    "levenshtein_sweep_full_batch_plain",
    "levenshtein_sweep_full_batch_bitparallel",
]

L = MAX_QUERY_CHARS  # term width == query width
# plain versions: bound the [Q, N] intermediates (about 20 live int32 planes
# for the banded DP, 33 for the full one)
_PLAIN_CHUNK_ELEMS = 1 << 24
_PLAIN_CHUNK_ELEMS_FULL = 1 << 23
BANDED = "banded_levenshtein.cu"
FULL = "full_levenshtein.cu"
_TABLE = 256  # code points with a direct match-table entry in the full-width kernel
# C signatures: (chars_t, term_lens, n, queries, query_lens, q, *extra ints,
# dist, prefix_dist, is_prefix, stream)
_IN = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
_OUT = [ctypes.c_void_p] * 4
SIGNATURES = {
    BANDED: {
        "veloci_banded_sweep": [*_IN, ctypes.c_int, *_OUT],
        # (chars_t, term_lens, sweep_ids, n, host query, query_len, band,
        # limit, out, stream)
        "veloci_banded_select": [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    },
    FULL: {"veloci_full_sweep": [*_IN, *_OUT]},
}
# the fused select reads back the count and this many matches in one copy;
# a query with more takes a second copy for the rest
_SELECT_HEAD = 256


def _check(chars_t, term_lens, queries, query_lens, band) -> None:
    """``band`` 2 or 4 for the banded sweep, None for the full one."""
    if band not in (2, 4, None):
        raise ValueError(f"band must be 2 or 4, got {band}")
    _check_tensors(chars_t, term_lens, ("queries", queries, torch.uint16, 2),
                   ("query_lens", query_lens, torch.int32, 1))
    if queries.shape[1] != L or query_lens.shape[0] != queries.shape[0]:
        raise ValueError(f"queries must be [Q, {L}] with query_lens [Q]")


def _check_tensors(chars_t, term_lens, *more) -> None:
    """``chars_t [32, N] uint16`` and ``term_lens [N] int32``, and each of
    ``more`` ``(name, tensor, dtype, ndim)``: on one device, contiguous."""
    dev = chars_t.device
    expect = (("chars_t", chars_t, torch.uint16, 2), ("term_lens", term_lens, torch.int32, 1), *more)
    for name, t, dtype, ndim in expect:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, chars_t on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be a {ndim}-d {dtype} tensor, got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n = chars_t.shape[1]
    if chars_t.shape[0] != L or term_lens.shape[0] != n:
        raise ValueError(f"chars_t must be [{L}, N] with term_lens [N]")


def _u16_to_i32(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16).to(torch.int32) & 0xFFFF


def _plain_chunk(chars, lens, qs, ql_raw, band):
    """Banded DP for a chunk of queries, vectorised over (query, term) with
    the ``2 * band + 1`` band cells as separate planes. chars [L, N] int32,
    lens [N], qs [Qc, L] int32, ql_raw [Qc]."""
    w = 2 * band + 1
    qc_n, n = qs.shape[0], chars.shape[1]
    qlen = ql_raw.clamp(max=L)
    big = torch.full((qc_n, n), BIG, dtype=torch.int32, device=chars.device)
    # B[oi] = D[i][i + oi - band]
    rows = [big if oi < band else torch.full_like(big, oi - band) for oi in range(w)]
    for i in range(1, int(qlen.max()) + 1):
        qc = qs[:, i - 1 : i]
        prev = None
        new = []
        for oi in range(w):
            j = i + oi - band
            if j < 0 or j > L:
                val = big
            elif j == 0:
                val = torch.full_like(big, i)
            else:
                val = rows[oi] + (chars[j - 1][None, :] != qc).to(torch.int32)
                if oi + 1 < w:
                    val = torch.minimum(val, rows[oi + 1] + 1)
                if prev is not None:
                    val = torch.minimum(val, prev + 1)
                val = val.clamp(max=BIG)
            prev = val
            new.append(val)
        active = (qlen >= i)[:, None]
        rows = [torch.where(active, nv, ov) for nv, ov in zip(new, rows)]

    ql = qlen[:, None]
    off = lens[None, :] - ql + band
    dist, prefix = big, big
    for oi in range(w):
        pj = ql + (oi - band)
        dist = torch.where(off == oi, rows[oi], dist)
        ok = (pj >= 0) & (pj <= lens[None, :])
        prefix = torch.minimum(prefix, torch.where(ok, rows[oi], big))
    valid = (lens > 0)[None, :]
    return torch.where(valid, dist, big), torch.where(valid, prefix, big), _is_prefix(chars, lens, qs, ql_raw)


def _plain_full_chunk(chars, lens, qs, ql_raw):
    """Full DP for a chunk of queries, vectorised over (query, term) with the
    33 columns as separate planes, each row updated in place left to right
    as the kernel does. Columns past the longest term are never computed:
    no column feeds one before it."""
    qc_n, n = qs.shape[0], chars.shape[1]
    qlen = ql_raw.clamp(max=L)
    max_len = int(lens.max())
    rows = [torch.full((qc_n, n), j, dtype=torch.int32, device=chars.device) for j in range(max_len + 1)]
    for i in range(1, int(qlen.max()) + 1):
        active = (qlen >= i)[:, None]
        qc = qs[:, i - 1 : i]
        diag = rows[0]
        rows[0] = torch.where(active, torch.full_like(diag, i), diag)
        for j in range(1, max_len + 1):
            up = rows[j]
            cand = torch.minimum(up + 1, diag + (chars[j - 1][None, :] != qc).to(torch.int32))
            rows[j] = torch.where(active, torch.minimum(rows[j - 1] + 1, cand), up)
            diag = up

    lens_b = lens[None, :]
    big = torch.full((qc_n, n), BIG, dtype=torch.int32, device=chars.device)
    dist, prefix = big, big
    for j, row in enumerate(rows):
        dist = torch.where(lens_b == j, row, dist)
        prefix = torch.where(lens_b >= j, torch.minimum(prefix, row), prefix)
    valid = lens_b > 0
    return torch.where(valid, dist, big), torch.where(valid, prefix, big), _is_prefix(chars, lens, qs, ql_raw)


def _is_prefix(chars, lens, qs, ql_raw):
    """[Qc, N]: the term is not empty and starts with the query."""
    is_prefix = (lens[None, :] > 0) & (lens[None, :] >= ql_raw[:, None])
    for j in range(L):
        is_prefix &= (chars[j][None, :] == qs[:, j : j + 1]) | (ql_raw[:, None] <= j)
    return is_prefix


def _plain(chunk, chunk_elems, chars_t, term_lens, queries, query_lens, *args):
    """Run ``chunk`` over slices of the queries of at most ``chunk_elems``
    (query, term) pairs each, and concatenate."""
    q, n = queries.shape[0], chars_t.shape[1]
    if q == 0 or n == 0:
        e = torch.full((q, n), BIG, dtype=torch.int32, device=chars_t.device)
        return e, e.clone(), torch.zeros((q, n), dtype=torch.bool, device=chars_t.device)
    chars = _u16_to_i32(chars_t)
    qs = _u16_to_i32(queries)
    step = max(1, chunk_elems // n)
    outs = [
        chunk(chars, term_lens, qs[lo : lo + step], query_lens[lo : lo + step], *args)
        for lo in range(0, q, step)
    ]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def levenshtein_sweep_banded_batch_plain(chars_t, term_lens, queries, query_lens, band=4):
    """Plain PyTorch version of the batched banded sweep, on any device: a
    loop over query characters, vectorised over (query, term, band cell)."""
    _check(chars_t, term_lens, queries, query_lens, band)
    return _plain(_plain_chunk, _PLAIN_CHUNK_ELEMS, chars_t, term_lens, queries, query_lens, band)


def levenshtein_sweep_full_batch_plain(chars_t, term_lens, queries, query_lens):
    """Plain PyTorch version of the full-width sweep, on any device: a loop
    over query characters and term columns, vectorised over (query, term)."""
    _check(chars_t, term_lens, queries, query_lens, None)
    return _plain(_plain_full_chunk, _PLAIN_CHUNK_ELEMS_FULL, chars_t, term_lens, queries, query_lens)


def levenshtein_sweep_full_batch_bitparallel(chars_t, term_lens, queries, query_lens):
    """The full-width kernel's algorithm on any device, for tests: Myers'
    bit-parallel sweep in Hyyro's edit-distance form, one step per term
    char, vectorised over (query, term) with the 32-bit words held in int64.
    It must equal :func:`levenshtein_sweep_full_batch_plain`, the DP that
    defines the function."""
    _check(chars_t, term_lens, queries, query_lens, None)
    q, n = queries.shape[0], chars_t.shape[1]
    dev = chars_t.device
    word = 0xFFFFFFFF
    chars = _u16_to_i32(chars_t).to(torch.int64)  # [32, N]
    qs = _u16_to_i32(queries).to(torch.int64)  # [Q, 32]
    lens = term_lens.to(torch.int64)[None, :]  # [1, N]
    qlen_raw = query_lens.to(torch.int64)[:, None]  # [Q, 1]
    m = qlen_raw.clamp(max=L)
    bits = torch.where(
        torch.arange(L, device=dev)[None, :] < m, 1 << torch.arange(L, device=dev), 0
    )  # [Q, 32]: the bit of each query char, 0 past the query
    # the kernel's match tables: Peq[q, c] for c < 256, and a compare with
    # the query's chars at or above 256 for the rest
    table = torch.zeros((q, _TABLE), dtype=torch.int64, device=dev)
    rows = torch.arange(q, device=dev)
    for i in range(L):
        low = qs[:, i] < _TABLE
        table[rows[low], qs[low, i]] |= bits[low, i]
    high_bits = torch.where(qs >= _TABLE, bits, 0)
    top = (m - 1).clamp(min=0)
    pv = torch.full((q, n), word, dtype=torch.int64, device=dev)
    mv = torch.zeros_like(pv)
    score = m.expand(q, n).clone()  # lev(query, "")
    pd, d = score.clone(), score.clone()
    pref = (lens > 0) & (lens >= qlen_raw)
    for j in range(int(lens.max()) if n else 0):
        ch = chars[j]
        high_eq = ((qs[:, :, None] == ch[None, None, :]) * high_bits[:, :, None]).sum(1)
        eq = torch.where(ch < _TABLE, table[:, ch.clamp(max=_TABLE - 1)], high_eq)
        xv = eq | mv
        xh = ((((eq & pv) + pv) & word) ^ pv) | eq
        ph = mv | (~(xh | pv) & word)
        mh = pv & xh
        score = score + ((ph >> top) & 1) - ((mh >> top) & 1)
        ph = ((ph << 1) | 1) & word
        pv = ((mh << 1) & word) | (~(xv | ph) & word)
        mv = ph & xv
        pd = torch.where(j < lens, torch.minimum(pd, score), pd)
        d = torch.where(j + 1 == lens, score, d)
        pref &= (j >= m) | (((eq >> j) & 1) == 1)
    empty_query = m == 0
    d = torch.where(empty_query, lens, d)
    pd = torch.where(empty_query, 0, pd)
    valid = lens > 0
    big = torch.tensor(BIG, dtype=torch.int64, device=dev)
    return (
        torch.where(valid, d, big).to(torch.int32), torch.where(valid, pd, big).to(torch.int32),
        pref,
    )


def _launch(source, symbol, chars_t, term_lens, queries, query_lens, *extra):
    """Launch ``symbol`` of ``csrc/<source>`` (its signature in
    ``SIGNATURES``) on the current stream; raise the launch's error."""
    q, n = queries.shape[0], chars_t.shape[1]
    dev = chars_t.device
    dist = torch.empty((q, n), dtype=torch.int32, device=dev)
    prefix = torch.empty((q, n), dtype=torch.int32, device=dev)
    is_prefix = torch.empty((q, n), dtype=torch.bool, device=dev)
    lib = _build.load(source, SIGNATURES[source])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, symbol)(
            chars_t.data_ptr(), term_lens.data_ptr(), n,
            queries.data_ptr(), query_lens.data_ptr(), q, *extra,
            dist.data_ptr(), prefix.data_ptr(), is_prefix.data_ptr(), stream,
        )
    if err != 0:
        msg = lib.veloci_cuda_error_string(err).decode()
        raise RuntimeError(f"{symbol} kernel launch failed: {msg} ({err})")
    return dist, prefix, is_prefix


def levenshtein_sweep_banded_batch(chars_t, term_lens, queries, query_lens, band=4):
    """Batched banded sweep: ``chars_t [32, N] uint16``, ``term_lens [N] int32``,
    ``queries [Q, 32] uint16``, ``query_lens [Q] int32`` ->
    ``(dist [Q, N] int32, prefix_dist [Q, N] int32, is_prefix [Q, N] bool)``.

    Each query's DP runs to ``min(query_len, 32)`` characters. One kernel
    launch covers the whole batch."""
    _check(chars_t, term_lens, queries, query_lens, band)
    if chars_t.device.type == "cpu":
        return levenshtein_sweep_banded_batch_plain(chars_t, term_lens, queries, query_lens, band)
    if chars_t.device.type != "cuda":
        raise ValueError(f"no banded sweep for device {chars_t.device}")
    out = _launch(BANDED, "veloci_banded_sweep", chars_t, term_lens, queries, query_lens, band)
    if queries.shape[0] and chars_t.shape[1]:
        levenshtein_sweep_banded_batch.launches += 1
    return out


levenshtein_sweep_banded_batch.launches = 0


def levenshtein_sweep_banded(chars_t, term_lens, query, query_len, band=4):
    """Single-query sweep: ``query [32] uint16`` and a one-element int32
    ``query_len`` -> ``(dist [N], prefix_dist [N], is_prefix [N])``."""
    queries = query.reshape(1, L)
    query_lens = query_len.reshape(1)
    _check(chars_t, term_lens, queries, query_lens, band)
    if chars_t.device.type == "cpu":
        out = levenshtein_sweep_banded_batch_plain(chars_t, term_lens, queries, query_lens, band)
    elif chars_t.device.type == "cuda":
        out = _launch(BANDED, "veloci_banded_sweep", chars_t, term_lens, queries, query_lens, band)
        if chars_t.shape[1]:
            levenshtein_sweep_banded.launches += 1
    else:
        raise ValueError(f"no banded sweep for device {chars_t.device}")
    return tuple(o[0] for o in out)


levenshtein_sweep_banded.launches = 0


def levenshtein_sweep_full_batch(chars_t, term_lens, queries, query_lens):
    """Full-width sweep: ``chars_t [32, N] uint16``, ``term_lens [N] int32``
    (each in [0, 32]), ``queries [Q, 32] uint16``, ``query_lens [Q] int32`` ->
    ``(dist [Q, N] int32, prefix_dist [Q, N] int32, is_prefix [Q, N] bool)``.

    ``dist`` is the true distance, ``prefix_dist`` its minimum over the
    term's prefixes. One kernel launch covers the whole batch."""
    _check(chars_t, term_lens, queries, query_lens, None)
    if chars_t.device.type == "cpu":
        return levenshtein_sweep_full_batch_plain(chars_t, term_lens, queries, query_lens)
    if chars_t.device.type != "cuda":
        raise ValueError(f"no full-width sweep for device {chars_t.device}")
    out = _launch(FULL, "veloci_full_sweep", chars_t, term_lens, queries, query_lens)
    if queries.shape[0] and chars_t.shape[1]:
        levenshtein_sweep_full_batch.launches += 1
    return out


levenshtein_sweep_full_batch.launches = 0


def _check_select(chars_t, term_lens, sweep_ids, query, band, distance) -> None:
    if band not in (2, 4) or not 0 <= distance <= band:
        raise ValueError(f"band must be 2 or 4 and 0 <= distance <= band, got {band}, {distance}")
    _check_tensors(chars_t, term_lens, ("sweep_ids", sweep_ids, torch.int32, 1))
    if sweep_ids.shape != term_lens.shape:
        raise ValueError("sweep_ids must be shaped like term_lens")
    if query.shape != (L,):
        raise ValueError(f"query must be [{L}], got {query.shape}")


def _ordered(rows, term_ids, dists, prefixes):
    """Host matches -> ``(term ids int64, distances int32, is_prefix
    bool)`` in ``select_matches``' order: distance ascending, then row."""
    order = np.lexsort((rows, dists))
    return term_ids[order].astype(np.int64), dists[order].astype(np.int32), prefixes[order].astype(bool)


def levenshtein_select_banded_plain(chars_t, term_lens, sweep_ids, query, query_len: int, band: int,
                                    distance: int):
    """Plain PyTorch version of :func:`levenshtein_select_banded`, on any
    device: the banded sweep's plain version for the one query, then the
    rows with distance ``<= distance``."""
    query = np.asarray(query, dtype=np.uint16)
    _check_select(chars_t, term_lens, sweep_ids, query, band, distance)
    dev = chars_t.device
    queries = torch.from_numpy(np.ascontiguousarray(query[None])).to(dev)
    qlens = torch.tensor([query_len], dtype=torch.int32, device=dev)
    dist, _prefix, is_prefix = levenshtein_sweep_banded_batch_plain(chars_t, term_lens, queries, qlens, band)
    rows = torch.nonzero(dist[0] <= distance)[:, 0]
    host = (t.cpu().numpy() for t in (rows, sweep_ids[rows], dist[0][rows], is_prefix[0][rows]))
    return _ordered(*host)


def levenshtein_select_banded(chars_t, term_lens, sweep_ids, query, query_len: int, band: int,
                              distance: int):
    """One query's matches in a field's sweep matrix: ``chars_t [32, N]
    uint16``, ``term_lens [N] int32``, ``sweep_ids [N] int32`` (row -> term
    id), ``query`` the host ``[32] uint16`` code points of
    :func:`..levenshtein.encode_query` with ``query_len``, ``band`` 2 or 4
    and ``distance <= band`` -> host ``(term ids int64, distances int32,
    is_prefix bool)`` of every row whose banded distance is at most
    ``distance``, by distance, then row: what ``select_matches`` gives for
    the query from the banded sweep's outputs.

    One kernel launch writes the count and only the matches into an int32
    ``[1 + 3 N]`` buffer of this call's own (PyTorch's caching allocator
    hands the memory back on the stream, so concurrent callers never share
    it); one copy brings the count and the first matches back (a second
    copy the rest, past ``_SELECT_HEAD``), and the host sorts them."""
    query = np.ascontiguousarray(query, dtype=np.uint16)
    _check_select(chars_t, term_lens, sweep_ids, query, band, distance)
    dev = chars_t.device
    if dev.type == "cpu":
        return levenshtein_select_banded_plain(
            chars_t, term_lens, sweep_ids, query, query_len, band, distance)
    if dev.type != "cuda":
        raise ValueError(f"no banded select for device {dev}")
    n = chars_t.shape[1]
    if n == 0:
        return _ordered(*(np.empty(0, np.int32) for _ in range(4)))
    out = torch.empty(1 + 3 * n, dtype=torch.int32, device=dev)
    lib = _build.load(BANDED, SIGNATURES[BANDED])

    def launch():
        return lib.veloci_banded_select(
            chars_t.data_ptr(), term_lens.data_ptr(), sweep_ids.data_ptr(), n, query.ctypes.data,
            int(query_len), band, distance, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )

    if dev.index is None or dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        msg = lib.veloci_cuda_error_string(err).decode()
        raise RuntimeError(f"veloci_banded_select kernel launch failed: {msg} ({err})")
    levenshtein_select_banded.launches += 1
    head = min(n, _SELECT_HEAD)
    host = out[: 1 + 3 * head].cpu().numpy()
    count = int(host[0])
    matches = host[1:]
    if count > head:
        matches = np.concatenate([matches, out[1 + 3 * head : 1 + 3 * count].cpu().numpy()])
    m = matches[: 3 * count].reshape(count, 3)
    return _ordered(m[:, 0], m[:, 1], m[:, 2] >> 1, (m[:, 2] & 1) == 1)


levenshtein_select_banded.launches = 0

