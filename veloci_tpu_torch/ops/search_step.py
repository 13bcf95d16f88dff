"""Posting-run reads: one exact term's run -> top-k documents, and the
ragged gather every tree route reads its rows with.

Counterpart of ``_single_term_impl`` / ``batched_single_term_topk``
(``veloci_tpu/ops/search_step.py:44-118``) and of ``_gather_postings`` /
``_gather_postings_sliced`` (``:121-337``). A term's postings are one contiguous
run of packed ``(anchor, f32 score bits)`` int32 rows in the combined CSR,
sorted by anchor with one row per anchor. Run lengths are known on the
host, so the reads need no capacity buckets and no tail padding.
"""

from __future__ import annotations

import numpy as np
import torch

from .topk import segmented_topk

__all__ = ["gather_runs", "batched_single_term_topk"]


def gather_runs(offsets, packed, term_ids, term_scores, counts: np.ndarray, *per_term):
    """Ragged CSR gather of the runs of ``term_ids`` ([T] int64 on the device),
    concatenated in term order. ``counts`` are the run lengths on the host.

    Returns ``(term_of_row [M], anchors [M] int64, scores [M] f32, *rows)``
    with each row's score = run score x its term's score, in f32, and for
    each extra ``[T]`` tensor in ``per_term`` (a tree's slot keys, a deep
    tree's AND gates) its value at each row's term: the counterpart of
    ``term_slots`` / ``term_ngs`` in ``_gather_postings``."""
    dev = packed.device
    total = int(counts.sum())
    cnt = torch.from_numpy(np.ascontiguousarray(counts, dtype=np.int64)).to(dev)
    term_of_row = torch.repeat_interleave(
        torch.arange(len(counts), device=dev), cnt, output_size=total
    )
    out_start = torch.cumsum(cnt, 0) - cnt
    src = offsets[term_ids][term_of_row] + (
        torch.arange(total, device=dev) - out_start[term_of_row]
    )
    rows = packed[src]
    anchors = rows[:, 0].to(torch.int64)
    scores = rows[:, 1].contiguous().view(torch.float32) * term_scores[term_of_row]
    return (term_of_row, anchors, scores, *(t[term_of_row] for t in per_term))


def batched_single_term_topk(offsets, packed, term_ids, term_scores, counts, k):
    """Q single-term queries, one run each -> top-k by (score desc, anchor desc).

    Returns flat ``(query, anchors, scores)`` of the kept rows (grouped by
    query, ranked) and ``num_hits`` = each run's length, as the reference
    counts it. Scores are not gated here: the emitter keeps ``score > 0``."""
    q, anchors, scores = gather_runs(offsets, packed, term_ids, term_scores, counts)
    return segmented_topk(q, scores, anchors, len(counts), k), counts
