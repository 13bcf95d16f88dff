"""Posting-run reads: the ragged gather every route reads its rows with.

Counterpart of ``_gather_postings`` / ``_gather_postings_sliced``
(``veloci_tpu/ops/search_step.py:121-337``); a single-term query's run
read and top-k (``_single_term_impl`` / ``batched_single_term_topk``,
``:44-118``) is :func:`gather_runs` then :func:`.topk.segmented_topk`
(``search/batch.py``'s singles route). A term's postings are one contiguous
run of packed ``(anchor, f32 score bits)`` int32 rows in the combined CSR,
sorted by anchor with one row per anchor. Run lengths are known on the
host, so the reads need no capacity buckets and no tail padding.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trace import trace_time

__all__ = ["gather_runs"]


def gather_runs(offsets, packed, term_ids, term_scores, counts: np.ndarray, *per_term):
    """Ragged CSR gather of the runs of ``term_ids`` ([T] int64 on the device),
    concatenated in term order. ``counts`` are the run lengths on the host.

    Returns ``(term_of_row [M], anchors [M] int64, scores [M] f32, *rows)``
    with each row's score = run score x its term's score, in f32, and for
    each extra ``[T]`` tensor in ``per_term`` (a tree's slot keys, a deep
    tree's AND gates) its value at each row's term: the counterpart of
    ``term_slots`` / ``term_ngs`` in ``_gather_postings``."""
    with trace_time("gather_runs"):
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
