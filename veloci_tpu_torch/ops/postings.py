"""Dense posting resolve: a leaf's matched terms -> a ``[num_docs]`` f32 plane.

Counterpart of ``_resolve_kernel`` and ``resolve_to_anchor_dense``
(``veloci_tpu/ops/postings.py:83-157``), the per-request executor's resolve.
Each matched term has a contiguous run of packed ``(anchor, f32 score
bits)`` int32 rows in the combined CSR; a row scores ``score bits as f32 x
term score`` (one f32 multiply), and each anchor takes the maximum of its
rows; anchors that get no row, or whose maximum is not finite, hold 0.

:func:`dense_resolve` launches the hand-written CUDA kernel
``csrc/dense_resolve.cu`` for CUDA tensors and takes the plain PyTorch
version (:func:`dense_resolve_plain`, a ``scatter_reduce`` "amax") for CPU
tensors; the maximum is order-free, so both give the same bits. Run lengths
are known on the host, so nothing is padded to a capacity bucket. The
wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .search_step import gather_runs

__all__ = ["dense_resolve", "dense_resolve_args", "dense_resolve_plain", "resolve_to_anchor_dense"]

SOURCE = "dense_resolve.cu"
SIGNATURE = {
    "veloci_dense_resolve": [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}


def _check(offsets, packed, term_ids, term_scores, row_starts) -> None:
    dev = packed.device
    expect = (
        ("offsets", offsets, torch.int64, 1),
        ("packed", packed, torch.int32, 2),
        ("term_ids", term_ids, torch.int32, 1),
        ("term_scores", term_scores, torch.float32, 1),
        ("row_starts", row_starts, torch.int64, 1),
    )
    for name, t, dtype, ndim in expect:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, packed on {dev}")
        if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {ndim}-d {dtype} tensor")
    if packed.shape[1] != 2:
        raise ValueError("packed must be [nnz, 2]")
    if term_scores.shape[0] != term_ids.shape[0] or row_starts.shape[0] != term_ids.shape[0] + 1:
        raise ValueError("term_ids [T], term_scores [T] and row_starts [T + 1] disagree")


def dense_resolve_plain(offsets, packed, term_ids, term_scores, row_starts, total_rows: int, num_docs: int):
    """Plain PyTorch version of :func:`dense_resolve`, on any device: the
    runs gathered row by row (:func:`.search_step.gather_runs`), then one
    ``scatter_reduce`` "amax"."""
    _check(offsets, packed, term_ids, term_scores, row_starts)
    counts = (row_starts[1:] - row_starts[:-1]).cpu().numpy()
    _term, anchors, scores = gather_runs(offsets, packed, term_ids.to(torch.int64), term_scores, counts)
    keep = (anchors >= 0) & (anchors < num_docs)
    dense = torch.full((num_docs,), float("-inf"), dtype=torch.float32, device=packed.device)
    dense.scatter_reduce_(0, anchors[keep], scores[keep], "amax")
    return torch.where(torch.isfinite(dense), dense, 0.0)


def dense_resolve(offsets, packed, term_ids, term_scores, row_starts, total_rows: int, num_docs: int):
    """``offsets [num_keys + 2] int64`` and ``packed [nnz, 2] int32`` the
    combined CSR, ``term_ids [T] int32`` global term ids, ``term_scores
    [T] f32``, ``row_starts [T + 1] int64`` the exclusive scan of the terms'
    run lengths, ``total_rows`` its last value (on the host) ->
    ``[num_docs] f32``, each anchor's maximum row score, 0 where none."""
    _check(offsets, packed, term_ids, term_scores, row_starts)
    if packed.device.type == "cpu":
        return dense_resolve_plain(offsets, packed, term_ids, term_scores, row_starts, total_rows, num_docs)
    if packed.device.type != "cuda":
        raise ValueError(f"no dense resolve for device {packed.device}")
    if packed.data_ptr() % 8:
        raise ValueError("packed must be 8-byte aligned (rows are read as int2)")
    dev = packed.device
    out = torch.empty(num_docs, dtype=torch.float32, device=dev)
    lib = _build.load(SOURCE, SIGNATURE)
    with torch.cuda.device(dev):
        err = lib.veloci_dense_resolve(
            offsets.data_ptr(), packed.data_ptr(), term_ids.data_ptr(), term_scores.data_ptr(),
            row_starts.data_ptr(), term_ids.shape[0], int(total_rows), num_docs, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        msg = lib.veloci_cuda_error_string(err).decode()
        raise RuntimeError(f"veloci_dense_resolve kernel launch failed: {msg} ({err})")
    if num_docs:
        dense_resolve.launches += 1
    return out


dense_resolve.launches = 0


def dense_resolve_args(index, field: str, term_ids: np.ndarray, term_scores: np.ndarray):
    """One field's matched term ids and f32 scores -> :func:`dense_resolve`'s
    arguments on ``index.device``, or None when the field has no postings or
    no term matched. Term ids past the field's scored keys are dropped."""
    if field not in index.key_base or not len(term_ids):
        return None
    base, num_keys = index.key_base[field]
    term_ids = np.asarray(term_ids, dtype=np.int64)
    keep = term_ids < num_keys
    gtids = term_ids[keep] + base
    ho = index.host_offsets
    row_starts = np.zeros(len(gtids) + 1, dtype=np.int64)
    np.cumsum(ho[gtids + 1] - ho[gtids], out=row_starts[1:])
    dev = index.device
    return (
        index.offsets, index.packed, torch.from_numpy(gtids.astype(np.int32)).to(dev),
        torch.from_numpy(np.asarray(term_scores, dtype=np.float32)[keep]).to(dev),
        torch.from_numpy(row_starts).to(dev), int(row_starts[-1]), index.num_docs,
    )


def resolve_to_anchor_dense(index, field: str, term_ids: np.ndarray, term_scores: np.ndarray):
    """Host wrapper (``resolve_to_anchor_dense``, ``:126``): one field's
    matched term ids and f32 scores -> the leaf's ``[num_docs]`` plane on
    ``index.device`` (:func:`dense_resolve_args`); zeros for a field without
    postings."""
    args = dense_resolve_args(index, field, term_ids, term_scores)
    if args is None:
        return torch.zeros(index.num_docs, dtype=torch.float32, device=index.device)
    return dense_resolve(*args)
