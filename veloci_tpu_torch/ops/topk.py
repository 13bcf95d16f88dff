"""Exact top-k by (score desc, id desc), for many queries at once.

Counterpart of ``veloci_tpu/ops/topk.py``. ``torch.topk`` on CUDA leaves the
order of ties undefined, so every ranking here sorts a unique int64 key:
the order-preserving bits of the f32 score in the high bits and the id in
the low bits, which gives the reference's `sort_by_score_and_id` order
(src/search.rs:122-130) for ids below 2**31.
"""

from __future__ import annotations

import torch

from ..trace import trace_time

__all__ = ["score_desc_key", "rank_key", "segmented_topk", "topk_dense"]

_I31 = (1 << 31) - 1


def score_desc_key(scores: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) whose ascending order is f32 ``scores`` descending."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ _I31)  # ascending with the value
    return _I31 - ordered


def rank_key(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 whose ascending order is (score desc, id desc); ids in [0, 2**31)."""
    return (score_desc_key(scores) << 31) | (_I31 - ids.to(torch.int64))


def segmented_topk(seg, scores, ids, num_segments: int, k):
    """Per segment, its first ``k[segment]`` entries by (score desc, id desc).

    ``seg [M]`` int64 segment of each entry, ``scores [M]`` f32, ``ids [M]``
    unique within a segment, ``k [num_segments]`` int64. Returns
    ``(seg, ids, scores)`` of the kept entries, grouped by segment in
    ascending segment order and ranked within each."""
    with trace_time("segmented_topk"):
        order = torch.argsort(rank_key(scores, ids), stable=True)
        order = order[torch.argsort(seg[order], stable=True)]
        seg_s = seg[order]
        counts = torch.bincount(seg_s, minlength=num_segments)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(seg_s.shape[0], device=seg_s.device) - starts[seg_s]
        keep = rank < k[seg_s]
        order = order[keep]
        return seg_s[keep], ids[order], scores[order]


def topk_dense(dense: torch.Tensor, k: int):
    """The first ``k`` hits (score > 0) of a dense ``[num_docs]`` plane by
    (score desc, id desc): ``top_k_scores`` / ``topk_dense_exact``
    (``veloci_tpu/ops/topk.py:91-123``). Returns ``(ids int64, scores f32)``
    on the plane's device."""
    with trace_time("topk_dense"):
        ids = torch.nonzero(dense > 0).squeeze(1)
        scores = dense[ids]
        k = min(int(k), ids.shape[0])
        _key, order = torch.topk(rank_key(scores, ids), k, largest=False, sorted=True)
        return ids[order], scores[order]
