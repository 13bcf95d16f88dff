"""Search results, with the field names of ``veloci_tpu/search/result.py``:
``Hit``, ``SearchResult``, ``DocWithHit`` and ``SearchResultWithDoc``
(``:76-108``), and ``FieldSearchResult``, a leaf's field search with the
metadata that why-found, text locality and suggest read
(``field_search.search_field``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["DocWithHit", "FieldSearchResult", "Hit", "SearchResult", "SearchResultWithDoc"]


@dataclass
class Hit:
    """(anchor id, score) — reference src/search.rs:53-62."""

    id: int
    score: float

    def to_dict(self) -> dict:
        return {"id": int(self.id), "score": float(self.score)}


@dataclass
class FieldSearchResult:
    """One leaf's matched term ids and their scores on one field, what was
    asked for beside them, and the snippets of the texts they resolve to
    (reference SearchFieldResult, src/search/result/field_result.rs:6-53)."""

    path: str = ""  # field path incl. .textindex
    request: Any = None  # RequestSearchPart
    term_ids: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    term_scores: np.ndarray = field(default_factory=lambda: np.empty(0, np.float32))
    hits_ids: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))  # every match, before top
    terms: Dict[int, str] = field(default_factory=dict)  # kept term id -> its text
    highlight: Dict[int, str] = field(default_factory=dict)  # text id -> snippet
    # path -> {the leaf's first term: kept term ids} (why_found, text locality)
    term_id_hits_in_field: Dict[str, Dict[str, List[int]]] = field(default_factory=dict)
    term_text_in_field: Dict[str, List[str]] = field(default_factory=dict)  # path -> kept texts


@dataclass
class SearchResult:
    """Reference src/search/result/search_result.rs."""

    execution_time_ns: int = 0
    num_hits: int = 0
    data: List[Hit] = field(default_factory=list)
    ids: List[int] = field(default_factory=list)
    facets: Optional[Dict[str, List[Tuple[str, int]]]] = None
    explain: Dict[int, List[Any]] = field(default_factory=dict)
    why_found_info: Dict[int, Dict[str, List[str]]] = field(default_factory=dict)
    why_found_terms: Dict[str, List[str]] = field(default_factory=dict)

    def to_dict(self) -> dict:
        out: dict = {
            "execution_time_ns": self.execution_time_ns,
            "num_hits": self.num_hits,
            "data": [h.to_dict() for h in self.data],
            "ids": self.ids,
        }
        if self.facets is not None:
            out["facets"] = {k: [[t, c] for t, c in v] for k, v in self.facets.items()}
        return out


@dataclass
class DocWithHit:
    """Reference src/search/result/search_result_with_doc.rs:23-37."""

    doc: Any
    hit: Hit
    explain: Optional[List[Any]] = None
    why_found: Dict[str, List[str]] = field(default_factory=dict)

    def to_dict(self) -> dict:
        out: dict = {"doc": self.doc, "hit": self.hit.to_dict()}
        if self.explain is not None:
            out["explain"] = self.explain
        if self.why_found:
            out["why_found"] = self.why_found
        return out


@dataclass
class SearchResultWithDoc:
    execution_time_ns: int = 0
    num_hits: int = 0
    data: List[DocWithHit] = field(default_factory=list)
    facets: Optional[Dict[str, List[Tuple[str, int]]]] = None

    def to_dict(self) -> dict:
        out: dict = {
            "execution_time_ns": self.execution_time_ns,
            "num_hits": self.num_hits,
            "data": [d.to_dict() for d in self.data],
        }
        if self.facets is not None:
            out["facets"] = {k: [[t, c] for t, c in v] for k, v in self.facets.items()}
        return out
