"""Request model with JSON deserialisation parity: the port's copy of
``veloci_tpu/query/request.py``.

Mirrors the reference's serde types so the reference's test-suite request
JSON ports directly:

* `Request` — src/search/request/mod.rs:14-87
* `SearchRequest::{Or,And,Search}` + `simplify()` —
  src/search/request/search_request.rs:8-120
* `RequestSearchPart` — search_request.rs:126-179
* `RequestBoostPart` / `BoostFunction` — src/search/request/boost_request.rs
* `FacetRequest` — src/search/request/facet_request.rs
* `SnippetInfo` — src/search/request/snippet_info.rs
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import List, Optional

from ..error import InvalidRequestError
from ..trace import info_time

__all__ = [
    "Request",
    "SearchRequest",
    "RequestSearchPart",
    "RequestBoostPart",
    "RequestPhraseBoost",
    "FacetRequest",
    "SnippetInfo",
    "DEFAULT_SNIPPET_INFO",
]


@dataclass
class SnippetInfo:
    num_words_around_snippet: int = 5
    snippet_start_tag: str = "<b>"
    snippet_end_tag: str = "</b>"
    snippet_connector: str = " ... "
    max_snippets: int = 0xFFFFFFFF

    @classmethod
    def from_dict(cls, d: dict) -> "SnippetInfo":
        return cls(
            num_words_around_snippet=d.get("num_words_around_snippet", 5),
            snippet_start_tag=d.get("snippet_start_tag", "<b>"),
            snippet_end_tag=d.get("snippet_end_tag", "</b>"),
            snippet_connector=d.get("snippet_connector", " ... "),
            max_snippets=d.get("max_snippets", 0xFFFFFFFF),
        )


DEFAULT_SNIPPET_INFO = SnippetInfo()


@dataclass
class RequestBoostPart:
    path: str = ""
    boost_fun: Optional[str] = None  # Log10 | Log2 | Multiply | Add | Replace
    param: Optional[float] = None
    skip_when_score: Optional[List[float]] = None
    expression: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "RequestBoostPart":
        return cls(
            path=d.get("path", ""),
            boost_fun=d.get("boost_fun"),
            param=d.get("param"),
            skip_when_score=d.get("skip_when_score"),
            expression=d.get("expression"),
        )

    def key(self) -> tuple:
        return (
            self.path,
            self.boost_fun,
            self.param,
            tuple(self.skip_when_score or ()),
            self.expression,
        )


@dataclass
class RequestSearchPart:
    path: str = ""
    terms: List[str] = dc_field(default_factory=list)
    levenshtein_distance: Optional[int] = None
    starts_with: bool = False
    is_regex: bool = False
    token_value: Optional[RequestBoostPart] = None
    boost: Optional[float] = None
    ignore_case: Optional[bool] = None
    snippet: Optional[bool] = None
    snippet_info: Optional[SnippetInfo] = None
    top: Optional[int] = None
    skip: Optional[int] = None
    explain: bool = False
    options: Optional[dict] = None  # {explain, top, skip, boost: [...]}

    @classmethod
    def from_dict(cls, d: dict) -> "RequestSearchPart":
        return cls(
            path=d.get("path", ""),
            terms=list(d.get("terms", [])),
            levenshtein_distance=d.get("levenshtein_distance"),
            starts_with=d.get("starts_with", False),
            is_regex=d.get("is_regex", False),
            token_value=RequestBoostPart.from_dict(d["token_value"])
            if d.get("token_value")
            else None,
            boost=d.get("boost"),
            ignore_case=d.get("ignore_case"),
            snippet=d.get("snippet"),
            snippet_info=SnippetInfo.from_dict(d["snippet_info"])
            if d.get("snippet_info")
            else None,
            top=d.get("top"),
            skip=d.get("skip"),
            options=d.get("options"),
        )

    def key(self) -> tuple:
        """Dedup key for the field-request cache (reference FieldRequestCache)."""
        return (
            self.path,
            tuple(self.terms),
            self.levenshtein_distance,
            self.starts_with,
            self.is_regex,
            self.boost,
            self.ignore_case,
            self.snippet,
            self.top,
            self.skip,
            self.token_value.key() if self.token_value else None,
        )


@dataclass
class RequestPhraseBoost:
    search1: RequestSearchPart
    search2: RequestSearchPart

    @classmethod
    def from_dict(cls, d: dict) -> "RequestPhraseBoost":
        return cls(
            search1=RequestSearchPart.from_dict(d["search1"]),
            search2=RequestSearchPart.from_dict(d["search2"]),
        )


@dataclass
class FacetRequest:
    field: str
    top: Optional[int] = 10

    @classmethod
    def from_dict(cls, d: dict) -> "FacetRequest":
        return cls(field=d["field"], top=d.get("top", 10))


class SearchRequest:
    """Or / And / Search tree node."""

    __slots__ = ("kind", "queries", "part", "options")

    OR = "or"
    AND = "and"
    SEARCH = "search"

    def __init__(
        self,
        kind: str,
        queries: Optional[List["SearchRequest"]] = None,
        part: Optional[RequestSearchPart] = None,
        options: Optional[dict] = None,
    ):
        self.kind = kind
        self.queries = queries or []
        self.part = part
        self.options = options

    @classmethod
    def or_(cls, queries: List["SearchRequest"], options: Optional[dict] = None):
        return cls(cls.OR, queries=queries, options=options)

    @classmethod
    def and_(cls, queries: List["SearchRequest"], options: Optional[dict] = None):
        return cls(cls.AND, queries=queries, options=options)

    @classmethod
    def search(cls, part: RequestSearchPart):
        return cls(cls.SEARCH, part=part)

    @classmethod
    def from_dict(cls, d: dict) -> "SearchRequest":
        if "search" in d:
            return cls.search(RequestSearchPart.from_dict(d["search"]))
        for kind in (cls.OR, cls.AND):
            if kind in d:
                sub = d[kind]
                return cls(
                    kind,
                    queries=[cls.from_dict(q) for q in sub.get("queries", [])],
                    options=sub.get("options"),
                )
        raise InvalidRequestError(f"invalid search_req node: {d!r}")

    def simplify(self) -> None:
        """Flatten nested same-op nodes (reference search_request.rs:28-72)."""
        for q in self.queries:
            q.simplify()
        if self.kind in (self.OR, self.AND):
            flat: List[SearchRequest] = []
            for q in self.queries:
                if q.kind == self.kind and q.options is None:
                    flat.extend(q.queries)
                else:
                    flat.append(q)
            self.queries = flat

    def walk_parts(self):
        if self.kind == self.SEARCH:
            yield self.part
        else:
            for q in self.queries:
                yield from q.walk_parts()

    def __repr__(self) -> str:  # pragma: no cover
        if self.kind == self.SEARCH:
            return f"Search({self.part.path}:{self.part.terms})"
        return f"{self.kind.upper()}({self.queries!r})"


@dataclass
class Request:
    search_req: Optional[SearchRequest] = None
    suggest: Optional[List[RequestSearchPart]] = None
    boost: Optional[List[RequestBoostPart]] = None
    boost_term: Optional[List[RequestSearchPart]] = None
    facets: Optional[List[FacetRequest]] = None
    phrase_boosts: Optional[List[RequestPhraseBoost]] = None
    select: Optional[List[str]] = None
    filter: Optional[SearchRequest] = None
    top: Optional[int] = 10
    skip: Optional[int] = None
    why_found: bool = False
    text_locality: bool = False
    explain: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        """The request of its JSON ``d``: the root span ``request.parse``
        (:mod:`..trace`)."""
        with info_time("request.parse"):
            search_req = None
            if d.get("search_req") is not None:
                search_req = SearchRequest.from_dict(d["search_req"])
            elif any(k in d for k in ("search", "or", "and")):
                # convenience: a bare SearchRequest JSON is accepted at top level
                search_req = SearchRequest.from_dict(
                    {k: d[k] for k in ("search", "or", "and") if k in d}
                )
            return cls(
                search_req=search_req,
                suggest=[RequestSearchPart.from_dict(s) for s in d["suggest"]]
                if d.get("suggest")
                else None,
                boost=[RequestBoostPart.from_dict(b) for b in d["boost"]]
                if d.get("boost")
                else None,
                boost_term=[RequestSearchPart.from_dict(b) for b in d["boost_term"]]
                if d.get("boost_term")
                else None,
                facets=[FacetRequest.from_dict(f) for f in d["facets"]]
                if d.get("facets")
                else None,
                phrase_boosts=[RequestPhraseBoost.from_dict(p) for p in d["phrase_boosts"]]
                if d.get("phrase_boosts")
                else None,
                select=d.get("select"),
                filter=SearchRequest.from_dict(d["filter"]) if d.get("filter") else None,
                top=d.get("top", 10),
                skip=d.get("skip"),
                why_found=d.get("why_found", False),
                text_locality=d.get("text_locality", False),
                explain=d.get("explain", False),
            )
