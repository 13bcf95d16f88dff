"""Facet counts of the batched tree route.

Counterpart of the batched facet path of ``veloci_tpu/search/facet.py``:
the relation choice and gates of ``facet_matrix_host`` (``:81-130``),
``_pairs_of`` (``:178``) and ``format_counts`` (``:161``); reference
src/facet.rs. The reference multiplies the hits ``[Q, num_docs]`` by a
dense bf16 relation matrix ``[num_docs, G]``. Here the relation is uploaded
once as a doc -> value CSR and each query's hit anchors gather their value
runs, counted exactly in integers by one ``bincount`` over
``query * G + value``.

The gates stay the reference's, so that a field routes the same way in
both packages: a relation with more than ``FACET_MAX_TARGETS`` values, a
dense matrix over ``FACET_MAX_BYTES``, or more than 256 pairs in one (doc,
value) cell is not counted here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..create import ANCHOR_TO_TEXT_ID, PARENT_TO_VALUE_ID
from ..indices import EMPTY, Direct
from ..utils import get_steps_to_anchor

__all__ = ["FacetRelation", "facet_relation", "facet_counts", "format_counts"]

FACET_MAX_TARGETS = 512
FACET_MAX_BYTES = 128 * 1024 * 1024
_MAX_CELL_PAIRS = 256  # the reference's bf16 exactness gate


class FacetRelation(NamedTuple):
    """A facet field's doc -> value relation on the device, as a CSR."""

    offsets: torch.Tensor  # [num_docs + 1] int64
    values: torch.Tensor  # [pairs] int64 value ids, grouped by doc
    num_targets: int


def _pairs_of(store) -> Tuple[np.ndarray, np.ndarray]:
    """(sources, targets) pair arrays of a relation column."""
    if isinstance(store, Direct):
        src = np.flatnonzero(store.values != EMPTY)
        return src.astype(np.int64), store.values[src].astype(np.int64)
    counts = np.diff(store.offsets).astype(np.int64)
    src = np.repeat(np.arange(store.num_keys, dtype=np.int64), counts)
    return src, store.values.astype(np.int64)


def _relation_store(index, field: str):
    steps = get_steps_to_anchor(field)
    fast_anchor_path = steps[-1] + ANCHOR_TO_TEXT_ID
    if len(steps) == 1:
        path = steps[0] + PARENT_TO_VALUE_ID
    elif index.has_index(fast_anchor_path):
        path = fast_anchor_path
    else:
        return None
    return index.key_value_stores.get(path)


def facet_relation(index, field: str) -> Optional[FacetRelation]:
    """The field's relation on the device, uploaded once, or None where the
    reference's batched route would not count it (no fast-path relation,
    or a gate fails)."""
    key = ("facet", field)
    if key in index.cache:
        return index.cache[key]
    rel = None
    store = _relation_store(index, field)
    if store is not None:
        sources, targets = _pairs_of(store)
        num_docs = index.num_docs
        keep = sources < num_docs
        sources, targets = sources[keep], targets[keep]
        num_targets = int(targets.max()) + 1 if len(targets) else 1
        cells = np.unique(sources * num_targets + targets, return_counts=True)[1]
        if (
            num_targets <= FACET_MAX_TARGETS
            and num_docs * num_targets * 2 <= FACET_MAX_BYTES
            and int(cells.max(initial=0)) <= _MAX_CELL_PAIRS
        ):
            order = np.argsort(sources, kind="stable")
            offsets = np.zeros(num_docs + 1, dtype=np.int64)
            np.cumsum(np.bincount(sources, minlength=num_docs), out=offsets[1:])
            rel = FacetRelation(
                torch.from_numpy(offsets).to(index.device),
                torch.from_numpy(targets[order]).to(index.device),
                num_targets,
            )
    index.cache[key] = rel
    return rel


def facet_counts(rel: FacetRelation, seg, anchors, num_queries: int) -> torch.Tensor:
    """Per query, the pairs of its hit ``anchors`` (``seg`` the query of
    each) per value: ``[num_queries, num_targets]`` int64, exact."""
    start = rel.offsets[anchors]
    cnt = rel.offsets[anchors + 1] - start
    total = int(cnt.sum()) if cnt.numel() else 0
    hit_of = torch.repeat_interleave(torch.arange(len(cnt), device=cnt.device), cnt, output_size=total)
    pos = start[hit_of] + torch.arange(total, device=cnt.device) - (torch.cumsum(cnt, 0) - cnt)[hit_of]
    cell = seg[hit_of] * rel.num_targets + rel.values[pos]
    return torch.bincount(cell, minlength=num_queries * rel.num_targets).view(
        num_queries, rel.num_targets
    )


def format_counts(index, field: str, counts: np.ndarray, top) -> List[Tuple[str, int]]:
    """Counts per value id -> ``[(value text, count)]``, count descending
    (stable: value ids ascending among equal counts), first ``top``."""
    value_ids = np.flatnonzero(counts)
    if len(value_ids) == 0:
        return []
    vals = counts[value_ids]
    order = np.argsort(-vals, kind="stable")
    if top is not None:
        order = order[:top]
    dictionary = index.get_dictionary(get_steps_to_anchor(field)[-1])
    return [(dictionary.terms[int(value_ids[i])], int(vals[i])) for i in order]
