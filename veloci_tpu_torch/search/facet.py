"""Facet counts of the batched tree route and of the per-request executor.

Counterpart of ``veloci_tpu/search/facet.py``: the relation choice and gates
of ``facet_matrix_host`` (``:81-130``), ``_pairs_of`` (``:178``),
``format_counts`` (``:161``) and ``get_facet`` (``:188-229``); reference
src/facet.rs. The reference multiplies the hits ``[Q, num_docs]`` by a
dense bf16 relation matrix ``[num_docs, G]``. Here the relation is uploaded
once as a doc -> value CSR and each query's hit anchors gather their value
runs, counted exactly in integers by one ``bincount`` over
``query * G + value``.

The gates stay the reference's, so that a field routes the same way in
both packages: a relation with more than ``FACET_MAX_TARGETS`` values, a
dense matrix over ``FACET_MAX_BYTES``, or more than 256 pairs in one (doc,
value) cell is not counted on the batched route. The executor
(:func:`get_facet`) counts any fast relation with the same CSR and no gate,
and joins the other fields on the host, as the reference does.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..create import ANCHOR_TO_TEXT_ID, PARENT_TO_VALUE_ID, TEXTINDEX
from ..indices import EMPTY, Direct
from ..persistence import as_index
from ..utils import get_steps_to_anchor
from .read_document import text_for_id

__all__ = ["FacetRelation", "facet_relation", "facet_counts", "facet_list", "format_counts", "get_facet"]

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


def facet_relation(index, field: str, gated: bool = True) -> Optional[FacetRelation]:
    """The field's relation on the device, uploaded once, or None: with no
    fast-path relation, or, when ``gated``, where the reference's batched
    route would not count it (a gate fails)."""
    key = ("facet", field, gated)
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
        if not gated or (
            num_targets <= FACET_MAX_TARGETS
            and num_docs * num_targets * 2 <= FACET_MAX_BYTES
            and int(np.unique(sources * num_targets + targets, return_counts=True)[1].max(initial=0))
            <= _MAX_CELL_PAIRS
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
    (stable: value ids ascending among equal counts), first ``top``.

    A value id past the field's dictionary is a text longer than the field
    stores (``do_not_store_text_longer_than``, create.py ``get_text_info``):
    it is named by its tokens' texts joined, as a document read rebuilds it
    (:func:`.read_document.text_for_id`), and equal texts count as one value
    at their first id. The reference names every id from the dictionary and
    raises ``IndexError`` on such an id (ROADMAP C10)."""
    value_ids = np.flatnonzero(counts)
    if len(value_ids) == 0:
        return []
    prop = get_steps_to_anchor(field)[-1]
    dictionary = index.get_dictionary(prop)
    stored = value_ids < len(dictionary.terms)
    names = [dictionary.terms[int(v)] for v in value_ids[stored]]
    ids, vals = value_ids[stored], counts[value_ids[stored]]
    if not stored.all():
        merged = {}  # a long text -> [its first id, its count]
        for v in value_ids[~stored].tolist():
            first_count = merged.setdefault(text_for_id(index, prop[: -len(TEXTINDEX)], v), [v, 0])
            first_count[1] += int(counts[v])
        names += list(merged)
        ids = np.concatenate([ids, [v for v, _c in merged.values()]])
        vals = np.concatenate([vals, [c for _v, c in merged.values()]])
    order = np.lexsort((ids, -vals.astype(np.int64)))
    if top is not None:
        order = order[:top]
    return [(names[i], int(vals[i])) for i in order]


def facet_list(index, facet_req, fast_counts, hit_ids) -> List[Tuple[str, int]]:
    """The facet list of a hit set (``get_facet``, ``:188``): the fast
    relation (the root field's ``.parent_to_value_id``, or a 1:n field's
    ``.anchor_to_text_id``, uploaded with no gate) counted by
    ``fast_counts(relation)`` (host int counts per value); other fields
    through the join chain ``anchor -> ... -> value`` on the host, from the
    hit ids ``hit_ids()`` returns (host, ascending)."""
    steps = get_steps_to_anchor(facet_req.field)
    if len(steps) == 1 or index.has_index(steps[-1] + ANCHOR_TO_TEXT_ID):
        rel = facet_relation(index, facet_req.field, gated=False)
        if rel is None:
            return []
        counts = fast_counts(rel)
    else:
        ids = hit_ids()
        for step in steps:
            store = index.key_value_stores.get(step + PARENT_TO_VALUE_ID)
            if store is None:
                return []
            ids = store.get_values_multi(ids).astype(np.int64)
        counts = np.bincount(ids) if len(ids) else np.zeros(0, np.int64)
    return format_counts(index, facet_req.field, counts, facet_req.top)


def get_facet(index, facet_req, hit_mask) -> List[Tuple[str, int]]:
    """The facet list of a hit set (:func:`facet_list`), the fast relation
    counted on the index's device, exactly. ``hit_mask`` is a dense plane
    (a tensor; its hits are the entries > 0) or, as the reference also
    takes, a host bool mask over the documents (``:188-197``); the two give
    the same counts. ``index`` may be a ``Persistence`` (its upload)."""
    index = as_index(index)
    if isinstance(hit_mask, np.ndarray):
        ids = np.flatnonzero(hit_mask[: index.num_docs])
        hits = torch.from_numpy(ids.astype(np.int64)).to(index.device)
    else:
        hits = torch.nonzero(hit_mask > 0).squeeze(1)
    return facet_list(index, facet_req, lambda rel: facet_counts(rel, torch.zeros_like(hits), hits, 1)[0].cpu().numpy(),
                      lambda: hits.cpu().numpy())
