"""Snippet generation and document highlighting: the port's copy of
``veloci_tpu/search/highlight.py``, reading a :class:`..persistence.TorchIndex`'s
host stores (its field tokenizers are kept in the index's ``cache``; the
port's tokenizer yields its pieces through ``iter`` alone).

Reference: src/highlight_field.rs — token positions of hits are grouped into
windows of +-num_words_around_snippet tokens, wrapped in start/end tags and
joined with the connector; `highlight_on_original_document` re-tokenizes the
original doc against the why-found term set (the fast path).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

import numpy as np

from ..create import TEXT_ID_TO_TOKEN_IDS, TEXTINDEX
from ..query.request import DEFAULT_SNIPPET_INFO, SnippetInfo

__all__ = [
    "highlight_text",
    "highlight_document",
    "highlight_on_original_document",
    "build_snippet",
]


def group_hit_positions_for_snippet(
    hit_positions: List[int], opt: SnippetInfo
) -> List[List[int]]:
    """Reference highlight_field.rs:19-37."""
    around = opt.num_words_around_snippet * 2
    grouped: List[List[int]] = []
    prev = -around
    for pos in hit_positions:
        if pos - prev >= around:
            grouped.append([])
        prev = pos
        grouped[-1].append(pos)
    return grouped


def _windows(grouped: List[List[int]], token_len: int, around: int):
    for vec in grouped:
        start = max(vec[0] - around, 0)
        end = min(vec[-1] + around + 1, token_len)
        yield (start, end)


def build_snippet(windows, is_hit, get_text, opt: SnippetInfo) -> str:
    """Reference highlight_field.rs:45-69."""
    parts = []
    for wi, (start, end) in enumerate(windows):
        if wi >= opt.max_snippets:
            break
        chunk = []
        for i in range(start, end):
            if is_hit(i):
                chunk.append(opt.snippet_start_tag + get_text(i) + opt.snippet_end_tag)
            else:
                chunk.append(get_text(i))
        parts.append("".join(chunk))
    return opt.snippet_connector.join(parts)


def ellipsis_snippet(
    snippet: str, hit_positions: List[int], token_len: int, opt: SnippetInfo
) -> str:
    """Reference highlight_field.rs:73-88."""
    around = opt.num_words_around_snippet * 2
    if hit_positions:
        if hit_positions[0] > around:
            snippet = opt.snippet_connector + snippet
        if hit_positions[-1] < token_len - around:
            snippet = snippet + opt.snippet_connector
    return snippet


def highlight_text(
    text: str,
    token_set: Set[str],
    opt: SnippetInfo = DEFAULT_SNIPPET_INFO,
    tokenizer=None,
) -> Optional[str]:
    """Reference highlight_field.rs:96-142."""
    if len(token_set) == 1 and text in token_set:
        return opt.snippet_start_tag + text + opt.snippet_end_tag
    if tokenizer is None:
        return None

    tokens = [tok for tok, _sep in tokenizer.iter(text)]
    hit_positions = [i for i, tok in enumerate(tokens) if tok in token_set]

    around = opt.num_words_around_snippet * 2
    grouped = group_hit_positions_for_snippet(hit_positions, opt)

    contains_any = bool(hit_positions)
    # inlined build_snippet: list-slice + positional hit set instead of the
    # per-index callback pair (the callbacks dominated the host highlight
    # profile — ~40% of highlight_on_original_document)
    hit_at = set(hit_positions)
    tag0, tag1 = opt.snippet_start_tag, opt.snippet_end_tag
    parts = []
    for wi, (start, end) in enumerate(_windows(grouped, len(tokens), around)):
        if wi >= opt.max_snippets:
            break
        parts.append(
            "".join(
                tag0 + t + tag1 if (start + j) in hit_at else t
                for j, t in enumerate(tokens[start:end])
            )
        )
    snippet = opt.snippet_connector.join(parts)
    snippet = ellipsis_snippet(snippet, hit_positions, len(tokens), opt)
    return snippet if contains_any else None


def highlight_document(
    persistence,
    path: str,
    value_id: int,
    token_ids: Iterable[int],
    opt: SnippetInfo = DEFAULT_SNIPPET_INFO,
) -> Optional[str]:
    """Reconstruct + highlight one stored text from its token ids.

    Reference highlight_field.rs:187-280 (`highlight_document`).
    """
    dictionary = persistence.get_dictionary(path)
    t2t = persistence.key_value_stores.get(path + TEXT_ID_TO_TOKEN_IDS)
    token_id_set = set(int(t) for t in token_ids)
    doc_token_ids: Optional[np.ndarray] = None
    if t2t is not None and t2t.has_values(int(value_id)):
        doc_token_ids = t2t.get_values(int(value_id))
    if doc_token_ids is None:
        if int(value_id) in token_id_set:
            return (
                opt.snippet_start_tag
                + dictionary.ord_to_term(int(value_id))
                + opt.snippet_end_tag
            )
        return None

    hit_positions = [
        i for i, tid in enumerate(doc_token_ids) if int(tid) in token_id_set
    ]
    if not hit_positions:
        return None

    around = opt.num_words_around_snippet * 2
    grouped = group_hit_positions_for_snippet(hit_positions, opt)
    snippet = build_snippet(
        _windows(grouped, len(doc_token_ids), around),
        lambda i: int(doc_token_ids[i]) in token_id_set,
        lambda i: dictionary.ord_to_term(int(doc_token_ids[i])),
        opt,
    )
    snippet = ellipsis_snippet(snippet, hit_positions, len(doc_token_ids), opt)
    return snippet


def highlight_on_original_document(
    persistence, doc: dict, why_found_terms: Dict[str, Set[str]]
) -> Dict[str, List[str]]:
    """Fast why-found highlighting by re-tokenizing the original document.

    Reference highlight_field.rs:147-185.
    """
    highlighted: Dict[str, List[str]] = {}
    # per-field tokenizer memo: FulltextIndexOptions.from_dict per text
    # value was ~15% of the why-found path
    tok_cache = persistence.cache.setdefault("highlight_tokenizers", {})

    def _field_tokenizer(field_name: str):
        if field_name in tok_cache:
            return tok_cache[field_name]
        col = persistence.columns.get(field_name)
        tokenizer = None
        if col:
            from ..config import FulltextIndexOptions

            opts = FulltextIndexOptions.from_dict(
                col["textindex_metadata"]["options"]
            )
            tokenizer = opts.tokenizer
        tok_cache[field_name] = tokenizer
        return tokenizer

    targets = {
        p[: -len(TEXTINDEX)]
        for p, terms in why_found_terms.items()
        if terms and p.endswith(TEXTINDEX)
    }
    for field_name, value in _leaf_texts(doc, targets):
        res = highlight_text(
            value,
            why_found_terms[field_name + TEXTINDEX],
            DEFAULT_SNIPPET_INFO,
            _field_tokenizer(field_name),
        )
        if res is not None:
            highlighted.setdefault(field_name, []).append(res)
    return highlighted


def _leaf_texts(doc, targets):
    """(field_name, text) leaf pairs under ``targets`` field paths only — a
    pruned, id-free rewalk of json_flatten._walk (same path grammar:
    ``a.b[].c``). Skips whole subtrees no why_found field lives under, and
    does none of the flattener's value-id accounting — the highlight path
    only ever needs the leaf strings."""
    from ..json_flatten import convert_to_string

    out: list = []

    def walk(data, path, el):
        if isinstance(data, list):
            p = path + el + "[]"
            if not any(t.startswith(p) for t in targets):
                return
            for x in data:
                walk(x, p, "")
        elif isinstance(data, dict):
            p = path + el
            if p:
                p += "."
            for k, v in data.items():
                cand = p + k
                if any(t.startswith(cand) for t in targets):
                    walk(v, p, k)
        elif data is not None:
            fp = path + el
            if fp in targets:
                out.append((fp, convert_to_string(data)))

    walk(doc, "", "")
    return out
