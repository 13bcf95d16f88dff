"""Query generator: free-text query + parameters -> full `Request`. The
port's copy of ``veloci_tpu/query/generator.py``.

Reference: src/query_generator.rs (`search_query` :175-246, `suggest_query`
:288-322, auto-levenshtein :85-99, boost_terms :146-168) and
src/query_generator/query_parser_to_veloci_request.rs (field expansion,
wildcard handling, stopword filtering).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from ..create import TEXTINDEX
from ..error import AllFieldsFilteredError, FieldNotFoundError
from ..search import stopwords as stopwords_mod
from .parser import Options, UserAST, parse_with_opt
from .request import (
    FacetRequest,
    Request,
    RequestBoostPart,
    RequestPhraseBoost,
    RequestSearchPart,
    SearchRequest,
)

__all__ = ["SearchQueryGeneratorParameters", "search_query", "suggest_query"]


@dataclass
class SearchQueryGeneratorParameters:
    """Reference query_generator.rs:47-83."""

    search_term: str = ""
    parser_options: Optional[Options] = None
    top: Optional[int] = None
    skip: Optional[int] = None
    ignore_case: Optional[bool] = None
    operator: Optional[str] = None
    levenshtein: Optional[int] = None
    levenshtein_auto_limit: Optional[int] = None
    facetlimit: Optional[int] = None
    why_found: Optional[bool] = None
    text_locality: Optional[bool] = None
    boost_queries: Optional[List[RequestBoostPart]] = None
    facets: Optional[List[str]] = None
    stopword_lists: Optional[List[str]] = None
    stopwords: Optional[Set[str]] = None
    fields: Optional[List[str]] = None
    boost_fields: Optional[Dict[str, float]] = None
    boost_terms: Optional[Dict[str, float]] = None
    phrase_pairs: Optional[bool] = None
    explain: Optional[bool] = None
    filter: Optional[str] = None
    filter_parser_options: Optional[Options] = None
    select: Optional[str] = None

    @classmethod
    def from_dict(cls, d: dict) -> "SearchQueryGeneratorParameters":
        po = d.get("parser_options")
        fpo = d.get("filter_parser_options")
        return cls(
            search_term=d.get("search_term", ""),
            parser_options=Options(**po) if po else None,
            top=d.get("top"),
            skip=d.get("skip"),
            ignore_case=d.get("ignore_case"),
            operator=d.get("operator"),
            levenshtein=d.get("levenshtein"),
            levenshtein_auto_limit=d.get("levenshtein_auto_limit"),
            facetlimit=d.get("facetlimit"),
            why_found=d.get("why_found"),
            text_locality=d.get("text_locality"),
            boost_queries=[RequestBoostPart.from_dict(b) for b in d["boost_queries"]]
            if d.get("boost_queries")
            else None,
            facets=d.get("facets"),
            stopword_lists=d.get("stopword_lists"),
            stopwords=set(d["stopwords"]) if d.get("stopwords") else None,
            fields=d.get("fields"),
            boost_fields=d.get("boost_fields"),
            boost_terms=d.get("boost_terms"),
            phrase_pairs=d.get("phrase_pairs"),
            explain=d.get("explain"),
            filter=d.get("filter"),
            filter_parser_options=Options(**fpo) if fpo else None,
            select=d.get("select"),
        )


def get_default_levenshtein(term: str, levenshtein_auto_limit: int, wildcard: bool) -> int:
    """Reference query_generator.rs:85-99."""
    n = len(term)
    if wildcard:
        if n <= 3:
            return 0
        if n <= 5:
            return min(1, levenshtein_auto_limit)
        return min(2, levenshtein_auto_limit)
    if n <= 2:
        return 0
    if n <= 5:
        return min(1, levenshtein_auto_limit)
    return min(2, levenshtein_auto_limit)


def get_levenshteinn(
    term: str,
    levenshtein: Optional[int],
    levenshtein_auto_limit: Optional[int],
    wildcard: bool,
) -> int:
    d = (
        levenshtein
        if levenshtein is not None
        else get_default_levenshtein(
            term, levenshtein_auto_limit if levenshtein_auto_limit is not None else 1, wildcard
        )
    )
    return min(d, max(len(term) - 1, 0))


def get_all_search_field_names(persistence, fields: Optional[List[str]]) -> List[str]:
    """Reference query_generator.rs:103-131."""
    res = []
    for path in persistence.get_all_fields():
        if fields is not None:
            if path in fields:
                res.append(path)
            continue
        if not persistence.has_token_to_anchor(path + TEXTINDEX + ".to_anchor_id_score"):
            continue
        res.append(path)
    if not res:
        raise AllFieldsFilteredError(persistence.get_all_fields(), fields)
    return res


def check_field(field_name: str, all_fields: List[str]) -> None:
    if field_name not in all_fields:
        raise FieldNotFoundError(field_name, all_fields)


def _filter_stopwords(query_ast: UserAST, opt: SearchQueryGeneratorParameters):
    """Reference query_parser_to_veloci_request.rs:113-130."""

    def should_filter(ast: UserAST, _attr) -> bool:
        if ast.kind != UserAST.LEAF:
            return False
        lower = ast.filter.phrase.lower()
        if opt.stopword_lists:
            return any(stopwords_mod.is_stopword(lang, lower) for lang in opt.stopword_lists)
        if opt.stopwords:
            return lower in opt.stopwords
        return False

    return query_ast.filter_ast(should_filter)


def _expand_fields_in_query_ast(ast: UserAST, all_fields: List[str]) -> UserAST:
    """Reference query_parser_to_veloci_request.rs:82-110: leaves expand into
    an OR over all searchable fields (order: last field first, then OR-chained
    backwards)."""
    if ast.kind == UserAST.BINARY:
        return UserAST.binary(
            _expand_fields_in_query_ast(ast.left, all_fields),
            ast.op,
            _expand_fields_in_query_ast(ast.right, all_fields),
        )
    if ast.kind == UserAST.ATTRIBUTED:
        check_field(ast.attr, all_fields)
        return ast
    it = iter(all_fields)
    curr = UserAST.attributed(next(it), ast)
    for field_name in it:
        curr = UserAST.binary(UserAST.attributed(field_name, ast), "OR", curr)
    return curr


def _query_ast_to_request(
    ast: UserAST, opt: SearchQueryGeneratorParameters, field_name: Optional[str]
) -> SearchRequest:
    """Reference query_parser_to_veloci_request.rs:23-80 (wildcard handling)."""
    if ast.kind == UserAST.BINARY:
        queries = [
            _query_ast_to_request(ast.left, opt, field_name),
            _query_ast_to_request(ast.right, opt, field_name),
        ]
        if ast.op == "AND":
            return SearchRequest.and_(queries)
        return SearchRequest.or_(queries)
    if ast.kind == UserAST.ATTRIBUTED:
        return _query_ast_to_request(ast.left, opt, ast.attr)
    assert field_name is not None
    term = ast.filter.phrase
    levenshtein_distance = None
    starts_with = term.endswith("*") and term.count("*") == 1
    if starts_with:
        term = term[:-1]
    is_regex = "*" in term
    if is_regex:
        term = ".*".join(re.escape(p) for p in term.split("*"))
    else:
        if ast.filter.levenshtein is not None:
            levenshtein_distance = ast.filter.levenshtein
        else:
            levenshtein_distance = get_levenshteinn(
                term, opt.levenshtein, opt.levenshtein_auto_limit, starts_with
            )
    boost = None
    if opt.boost_fields and field_name in opt.boost_fields:
        boost = opt.boost_fields[field_name]
    return SearchRequest.search(
        RequestSearchPart(
            path=field_name,
            terms=[term],
            levenshtein_distance=levenshtein_distance,
            starts_with=starts_with,
            is_regex=is_regex,
            ignore_case=opt.ignore_case,
            boost=boost,
        )
    )


def ast_to_search_request(
    query_ast: UserAST, all_fields: List[str], opt: SearchQueryGeneratorParameters
) -> SearchRequest:
    filtered = _filter_stopwords(query_ast, opt)
    ast = filtered if filtered is not None else query_ast
    ast = _expand_fields_in_query_ast(ast, all_fields)
    return _query_ast_to_request(ast, opt, None)


def handle_boost_term_query(
    persistence, boost_term: str, boost_value: float
) -> List[RequestSearchPart]:
    """`term:field->value` boost terms (query_generator.rs:146-168)."""
    field_filter: Optional[List[str]] = None
    term = boost_term
    if ":" in boost_term:
        parts = boost_term.split(":")
        term = parts[1]
        field_filter = [parts[0]] + parts[2:]
    return [
        RequestSearchPart(path=f, terms=[term], boost=boost_value)
        for f in get_all_search_field_names(persistence, field_filter)
    ]


def generate_phrase_queries_for_searchterm(
    persistence,
    fields: Optional[List[str]],
    terms: Set[tuple],
    levenshtein: Optional[int],
    levenshtein_auto_limit: Optional[int],
    boost_fields: Optional[Dict[str, float]],
) -> List[RequestPhraseBoost]:
    """Reference query_generator.rs:257-286."""
    out = []
    for term_a, term_b in terms:
        for field_name in get_all_search_field_names(persistence, fields):
            bf = boost_fields.get(field_name) if boost_fields else None
            out.append(
                RequestPhraseBoost(
                    search1=RequestSearchPart(
                        path=field_name,
                        terms=[term_a],
                        boost=bf,
                        levenshtein_distance=get_levenshteinn(
                            term_a, levenshtein, levenshtein_auto_limit, False
                        ),
                    ),
                    search2=RequestSearchPart(
                        path=field_name,
                        terms=[term_b],
                        boost=bf,
                        levenshtein_distance=get_levenshteinn(
                            term_b, levenshtein, levenshtein_auto_limit, False
                        ),
                    ),
                )
            )
    return out


def search_query(persistence, opt: SearchQueryGeneratorParameters) -> Request:
    """Reference query_generator.rs:175-246. ``persistence`` is a
    ``TorchIndex`` or a ``Persistence``: only their host stores are read,
    so a ``Persistence`` is not uploaded."""
    facetlimit = opt.facetlimit if opt.facetlimit is not None else 5
    all_fields = persistence.get_all_fields()
    all_search_fields = get_all_search_field_names(persistence, opt.fields)

    parser_options = opt.parser_options or Options()
    query_ast = parse_with_opt(opt.search_term, parser_options)

    request = Request()
    request.search_req = ast_to_search_request(query_ast, all_search_fields, opt)
    request.search_req.simplify()

    if opt.facets is not None:
        facets_req = []
        for field_name in opt.facets:
            check_field(field_name, all_fields)
            facets_req.append(FacetRequest(field=field_name, top=facetlimit))
        request.facets = facets_req

    if opt.boost_terms:
        requests: List[RequestSearchPart] = []
        for boost_term, boost_value in opt.boost_terms.items():
            requests.extend(handle_boost_term_query(persistence, boost_term, boost_value))
        request.boost_term = requests

    pairs = query_ast.get_phrase_pairs()
    if (opt.phrase_pairs or False) and pairs:
        request.phrase_boosts = generate_phrase_queries_for_searchterm(
            persistence,
            opt.fields,
            pairs,
            opt.levenshtein,
            opt.levenshtein_auto_limit,
            opt.boost_fields,
        )

    if opt.filter is not None:
        params = SearchQueryGeneratorParameters(levenshtein=0)
        filter_ast = parse_with_opt(opt.filter, opt.filter_parser_options or Options())
        filter_req = ast_to_search_request(filter_ast, all_fields, params)
        filter_req.simplify()
        request.filter = filter_req

    request.top = opt.top
    request.skip = opt.skip
    request.why_found = opt.why_found or False
    request.text_locality = opt.text_locality or False
    request.boost = opt.boost_queries
    request.explain = opt.explain or False
    if opt.select is not None:
        request.select = [s for s in opt.select.split(",") if s]
    return request


def suggest_query(
    term: str,
    persistence,
    top: Optional[int] = None,
    skip: Optional[int] = None,
    levenshtein: Optional[int] = None,
    fields: Optional[List[str]] = None,
    levenshtein_auto_limit: Optional[int] = None,
) -> Request:
    """Reference query_generator.rs:288-322 (``persistence`` as in
    :func:`search_query`)."""
    if top is None:
        top = 10
    requests = []
    for field_name in get_all_search_field_names(persistence, fields):
        d = (
            levenshtein
            if levenshtein is not None
            else get_default_levenshtein(
                term, levenshtein_auto_limit if levenshtein_auto_limit is not None else 1, True
            )
        )
        requests.append(
            RequestSearchPart(
                path=field_name,
                terms=[term],
                levenshtein_distance=d,
                starts_with=True,
                top=top,
                skip=skip,
            )
        )
    return Request(suggest=requests, top=top, skip=skip)
