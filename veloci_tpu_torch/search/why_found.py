"""Why-found: per hit, the texts of each field that a search leaf matched,
highlighted.

Counterpart of ``veloci_tpu/search/why_found.py`` (reference
src/search/why_found.rs): each hit anchor is joined down to the value ids of
every field a leaf hit (``get_steps_to_anchor`` through the
``.parent_to_value_id`` relations), and each value is rebuilt from its
token ids and highlighted (:func:`.highlight.highlight_document`).
:func:`merge_field_hits` merges the leaves' field-search metadata per path,
as the reference's executor does before it (``executor.py:867-875``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import numpy as np

from ..create import PARENT_TO_VALUE_ID, TEXTINDEX
from ..utils import get_steps_to_anchor
from .highlight import highlight_document
from .result import FieldSearchResult

__all__ = ["get_why_found", "merge_field_hits"]


def merge_field_hits(
    results: Iterable[FieldSearchResult],
) -> Tuple[Dict[str, Dict[str, List[int]]], Dict[str, List[str]]]:
    """The leaves' field searches, in the tree's leaf order -> (term id hits,
    term texts) per path. Hits are keyed by each leaf's first term, so a
    later leaf with the same first term on the same path replaces an
    earlier one; texts extend, duplicates kept."""
    term_id_hits: Dict[str, Dict[str, List[int]]] = {}
    term_texts: Dict[str, List[str]] = {}
    for fsr in results:
        for path, m in fsr.term_id_hits_in_field.items():
            term_id_hits.setdefault(path, {}).update(m)
        for path, texts in fsr.term_text_in_field.items():
            term_texts.setdefault(path, []).extend(texts)
    return term_id_hits, term_texts


def get_why_found(
    index, anchor_ids: List[int], term_id_hits_in_field: Dict[str, Dict[str, List[int]]]
) -> Dict[int, Dict[str, List[str]]]:
    """``{anchor: {field: [highlighted texts]}}`` for the hits
    ``anchor_ids``, from the matched term ids of each path."""
    anchor_highlights: Dict[int, Dict[str, List[str]]] = {}
    for path, term_with_ids in term_id_hits_in_field.items():
        field_name = path[: -len(TEXTINDEX)] if path.endswith(TEXTINDEX) else path
        steps = get_steps_to_anchor(field_name)
        all_term_ids = [t for hits in term_with_ids.values() for t in hits]
        if not all_term_ids:
            continue
        for anchor_id in anchor_ids:
            ids = np.array([anchor_id], dtype=np.int64)
            for step in steps:
                store = index.key_value_stores.get(step + PARENT_TO_VALUE_ID)
                if store is None:
                    ids = np.empty(0, dtype=np.int64)
                    break
                ids = store.get_values_multi(ids).astype(np.int64)
            for value_id in ids:
                highlighted = highlight_document(index, steps[-1], int(value_id), all_term_ids)
                if highlighted is not None:
                    anchor_highlights.setdefault(int(anchor_id), {}).setdefault(
                        field_name, []
                    ).append(highlighted)
    return anchor_highlights
