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
tensors; the maximum is order-free, so both give the same bits. The kernel
has a direct path (one launch after a memset), taken where
:func:`dense_resolve_args` found that :func:`dense_fast_path` holds and
says so in the arguments it builds, and a keys path with a finalise pass
for every other input. Run lengths are known on the host, so nothing
is padded to a capacity bucket. The wrapper counts its launches in
``.launches``, those on the direct path in ``.direct_launches``.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .search_step import gather_runs

__all__ = [
    "Csr",
    "csr_resolve",
    "csr_resolve_args",
    "dense_fast_path",
    "dense_max_row_score",
    "dense_resolve",
    "dense_resolve_args",
    "dense_resolve_plain",
    "resolve_to_anchor_dense",
]

SOURCE = "dense_resolve.cu"
SIGNATURE = {
    "veloci_dense_resolve": [ctypes.c_void_p] * 5
    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
}
_F32_INF_BITS = 0x7F800000  # f32 bit patterns below it: finite, sign bit clear
# the least real number that rounds (to nearest, ties to even) to f32 inf:
# halfway between FLT_MAX = 2^128 - 2^104 and 2^128
_F32_ROUNDS_TO_INF = 2.0**128 - 2.0**103


def dense_max_row_score(scores01: np.ndarray):
    """The largest of the f32 ``scores01`` when every one is a finite float
    with its sign bit clear (0.0 for none), else None: an index's
    ``TorchIndex.max_row_score``, computed once at upload, and what
    :func:`dense_fast_path` asks of a leaf's term scores. Such floats order
    like their bit patterns, and every other pattern lies above them."""
    bits = np.asarray(scores01, dtype=np.float32).view(np.uint32)
    if not len(bits):
        return np.float32(0.0)
    top = bits.max()
    return top.view(np.float32) if top < _F32_INF_BITS else None


def dense_fast_path(max_row_score, term_scores: np.ndarray) -> bool:
    """Whether :func:`dense_resolve` may take its direct path for a leaf:
    the index's row scores qualify (``max_row_score`` not None, from
    :func:`dense_max_row_score`), every f32 term score is a finite float
    with its sign bit clear, and the product of the two largest is finite
    in f32. Rounding is monotone, so then every product is a finite float
    with its sign bit clear, whose int32 bits order like the float, and no
    product is -0.0 (which orders below +0.0 as an integer). The product
    of two f32 values is exact in float64, so comparing it with the least
    real that rounds to inf decides the f32 product's overflow."""
    if max_row_score is None:
        return False
    top = dense_max_row_score(term_scores)
    return top is not None and float(max_row_score) * float(top) < _F32_ROUNDS_TO_INF


def _check_csr(offsets, packed) -> None:
    if offsets.device != packed.device:
        raise ValueError(f"offsets is on {offsets.device}, packed on {packed.device}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 or not offsets.is_contiguous():
        raise ValueError("offsets must be a contiguous 1-d torch.int64 tensor")
    if packed.dtype != torch.int32 or packed.dim() != 2 or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous 2-d torch.int32 tensor")
    if packed.shape[1] != 2:
        raise ValueError("packed must be [nnz, 2]")
    if packed.device.type == "cuda" and packed.data_ptr() % 8:
        raise ValueError("packed must be 8-byte aligned (rows are read as int2)")


_checked_csr: list = []  # weak references to the last (offsets, packed) that passed _check_csr


def _check_csr_once(offsets, packed) -> None:
    """:func:`_check_csr` once per index: an index's CSR tensors are the
    same objects for every leaf."""
    if _checked_csr and _checked_csr[0]() is offsets and _checked_csr[1]() is packed:
        return
    _check_csr(offsets, packed)
    _checked_csr[:] = [weakref.ref(offsets), weakref.ref(packed)]


def _check_leaf(dev, term_ids, term_scores, row_starts) -> None:
    expect = (
        ("term_ids", term_ids, torch.int32),
        ("term_scores", term_scores, torch.float32),
        ("row_starts", row_starts, torch.int64),
    )
    for name, t, dtype in expect:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, packed on {dev}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-d {dtype} tensor")
    if term_scores.shape[0] != term_ids.shape[0] or row_starts.shape[0] != term_ids.shape[0] + 1:
        raise ValueError("term_ids [T], term_scores [T] and row_starts [T + 1] disagree")


def _check(offsets, packed, term_ids, term_scores, row_starts) -> None:
    _check_csr(offsets, packed)
    _check_leaf(packed.device, term_ids, term_scores, row_starts)


def dense_resolve_plain(offsets, packed, term_ids, term_scores, row_starts, total_rows: int, num_docs: int,
                        direct: bool = False):
    """Plain PyTorch version of :func:`dense_resolve`, on any device: the
    runs gathered row by row (:func:`.search_step.gather_runs`), then one
    ``scatter_reduce`` "amax". It has one path and takes ``direct`` only so
    that both accept :func:`dense_resolve_args`' tuple."""
    _check(offsets, packed, term_ids, term_scores, row_starts)
    counts = (row_starts[1:] - row_starts[:-1]).cpu().numpy()
    _term, anchors, scores = gather_runs(offsets, packed, term_ids.to(torch.int64), term_scores, counts)
    keep = (anchors >= 0) & (anchors < num_docs)
    dense = torch.full((num_docs,), float("-inf"), dtype=torch.float32, device=packed.device)
    dense.scatter_reduce_(0, anchors[keep], scores[keep], "amax")
    return torch.where(torch.isfinite(dense), dense, 0.0)


def dense_resolve(offsets, packed, term_ids, term_scores, row_starts, total_rows: int, num_docs: int,
                  direct: bool = False):
    """``offsets [num_keys + 2] int64`` and ``packed [nnz, 2] int32`` the
    combined CSR, ``term_ids [T] int32`` global term ids, ``term_scores
    [T] f32``, ``row_starts [T + 1] int64`` the exclusive scan of the terms'
    run lengths, ``total_rows`` its last value (on the host) ->
    ``[num_docs] f32``, each anchor's maximum row score, 0 where none.

    ``direct``: take the kernel's direct path. It is the last of the
    arguments :func:`dense_resolve_args` builds, its verdict of
    :func:`dense_fast_path` on the leaf's host scores, which this function
    cannot see; the default, the keys path, is right for every input. The
    CSR tensors are checked once per index, the leaf's on every call."""
    dev = packed.device
    if dev.type == "cpu":
        return dense_resolve_plain(offsets, packed, term_ids, term_scores, row_starts, total_rows, num_docs)
    if dev.type != "cuda":
        raise ValueError(f"no dense resolve for device {dev}")
    _check_csr_once(offsets, packed)
    _check_leaf(dev, term_ids, term_scores, row_starts)
    out = torch.empty(num_docs, dtype=torch.float32, device=dev)
    lib = _build.load(SOURCE, SIGNATURE)

    def launch():
        return lib.veloci_dense_resolve(
            offsets.data_ptr(), packed.data_ptr(), term_ids.data_ptr(), term_scores.data_ptr(),
            row_starts.data_ptr(), term_ids.shape[0], int(total_rows), num_docs, 0 if direct else 1,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )

    if dev.index is None or dev.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(dev):
            err = launch()
    if err != 0:
        msg = lib.veloci_cuda_error_string(err).decode()
        raise RuntimeError(f"veloci_dense_resolve kernel launch failed: {msg} ({err})")
    if num_docs:
        dense_resolve.launches += 1
        dense_resolve.direct_launches += bool(direct)
    return out


dense_resolve.launches = 0
dense_resolve.direct_launches = 0  # of them, on the direct path


class Csr(NamedTuple):
    """A posting CSR on one device, as :func:`dense_resolve` reads it: an
    index's combined CSR, or one document shard of it
    (:class:`..parallel.sharding.ShardedPostings`)."""

    offsets: torch.Tensor  # [num_keys + 2] int64, on the device
    packed: torch.Tensor  # [nnz, 2] int32 (anchor, f32 bits of score/100)
    host_offsets: np.ndarray  # the offsets, on the host
    max_row_score: object  # dense_max_row_score of its row scores


def csr_resolve_args(csr: Csr, gtids: np.ndarray, scores: np.ndarray, num_docs: int):
    """Global term ids and their f32 scores -> :func:`dense_resolve`'s
    arguments over ``csr``, the last of them whether its direct path may be
    taken (:func:`dense_fast_path`, asked only on a card).

    The leaf's three small arrays travel as one buffer in one copy:
    ``row_starts [T + 1]`` int64, then the term ids and the scores' bits,
    int32 each. On a card the buffer is pinned and the copy asynchronous;
    PyTorch's pinned-memory cache does not hand the buffer out again
    before the copy has run."""
    t = len(gtids)
    dev = csr.packed.device
    cuda = dev.type == "cuda"
    host = torch.empty(2 * t + 1, dtype=torch.int64, pin_memory=cuda)
    buf = host.numpy()
    ho = csr.host_offsets
    buf[0] = 0
    np.cumsum(ho[gtids + 1] - ho[gtids], out=buf[1 : t + 1])
    words = buf[t + 1 :].view(np.int32)
    words[:t] = gtids
    words[t:] = scores.view(np.int32)
    on_dev = host.to(dev, non_blocking=True)
    words_d = on_dev[t + 1 :].view(torch.int32)
    return (csr.offsets, csr.packed, words_d[:t], words_d[t:].view(torch.float32),
            on_dev[: t + 1], int(buf[t]), num_docs, cuda and dense_fast_path(csr.max_row_score, scores))


def csr_resolve(csr: Csr, gtids: np.ndarray, scores: np.ndarray, num_docs: int) -> torch.Tensor:
    """The ``[num_docs]`` plane of global term ids ``gtids`` with f32
    ``scores`` over ``csr`` (:func:`dense_resolve`); zeros, and no launch,
    when their runs hold no row."""
    gtids = np.asarray(gtids, dtype=np.int64)
    ho = csr.host_offsets
    if not len(gtids) or not num_docs or not int((ho[gtids + 1] - ho[gtids]).sum()):
        return torch.zeros(num_docs, dtype=torch.float32, device=csr.packed.device)
    return dense_resolve(*csr_resolve_args(csr, gtids, np.asarray(scores, dtype=np.float32), num_docs))


def dense_resolve_args(index, field: str, term_ids: np.ndarray, term_scores: np.ndarray):
    """One field's matched term ids and f32 scores -> :func:`dense_resolve`'s
    arguments on the index's device (:func:`csr_resolve_args`), or None
    when the field has no postings or no term matched. Term ids past the
    field's scored keys are dropped."""
    if field not in index.key_base or not len(term_ids):
        return None
    base, num_keys = index.key_base[field]
    term_ids = np.asarray(term_ids, dtype=np.int64)
    keep = term_ids < num_keys
    scores = np.asarray(term_scores, dtype=np.float32)[keep]
    cuda = index.packed.device.type == "cuda"  # the direct path is asked about on a card only
    csr = Csr(index.offsets, index.packed, index.host_offsets, index.max_row_score if cuda else None)
    return csr_resolve_args(csr, term_ids[keep] + base, scores, index.num_docs)


def resolve_to_anchor_dense(index, field: str, term_ids: np.ndarray, term_scores: np.ndarray):
    """Host wrapper (``resolve_to_anchor_dense``, ``:126``): one field's
    matched term ids and f32 scores -> the leaf's ``[num_docs]`` plane on
    the index's device (:func:`dense_resolve_args`); zeros for a field
    without postings."""
    args = dense_resolve_args(index, field, term_ids, term_scores)
    if args is None:
        return torch.zeros(index.num_docs, dtype=torch.float32, device=index.packed.device)
    return dense_resolve(*args)
