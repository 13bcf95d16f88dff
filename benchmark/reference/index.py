"""The reference's inverted index, built from the corpus text alone.

For every field of flat JSON documents (a document id is its line number),
veloci's index holds a dictionary of terms and, per term, the documents it
occurs in with an index-time score (upstream ``src/create.rs`` and
``src/create/calculate_score.rs``):

* every value of at most ``do_not_store_text_longer_than`` bytes (64) is a
  term, scored as an exact hit (400) of a one-token text;
* a value that splits into more than one token adds each token (separator
  runs included) as a term, scored by the position of its first occurrence
  in the value and by the value's number of tokens;
* both scores are divided by a damping of the term's occurrences in the
  whole field, computed in float32 and truncated to an integer, and a
  posting carries that integer divided by 100 as its float32 score.

Numbers are indexed as their text. Nested objects and arrays are not
supported here (no configuration of the benchmark has them).
"""

from __future__ import annotations

import json
from collections import Counter, defaultdict
from itertools import chain
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from . import tokenizer

F32 = np.float32
DEFAULT_MAX_STORED_BYTES = 64


def token_score(best_pos, occurrences, num_tokens, exact: bool) -> np.ndarray:
    """The index-time score of a term in a text, as an integer (float32
    arithmetic, truncated): a base of 400 for an exact text hit, else
    ``2000 / (log2(pos + 10) + 10)``, divided by the damped occurrence count
    and by the damped text length."""
    pos = np.asarray(best_pos, dtype=F32)
    occ = np.asarray(occurrences, dtype=F32)
    ntok = np.asarray(num_tokens, dtype=F32)
    if exact:
        score = np.full(pos.shape, F32(400.0), dtype=F32)
    else:
        score = F32(2000.0) / (np.log2(pos + F32(10.0)) + F32(10.0))
    occ_damp = (np.log10(occ + F32(1000.0)) - F32(2.0)).astype(F32)
    occ_damp = occ_damp - (occ_damp - F32(1.0)) * F32(0.7)
    len_damp = np.log10(ntok + F32(10.0)).astype(F32)
    len_damp = len_damp - (len_damp - F32(1.0)) * F32(0.7)
    return ((score / occ_damp) / len_damp).astype(np.uint32)


def _text_of(value):
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return repr(value)
    if value is None:
        return None
    raise NotImplementedError("the reference indexes flat documents only")


@dataclass
class Field:
    """One field: its terms and each term's postings (documents ascending,
    float32 scores)."""

    terms: List[str]
    offsets: np.ndarray  # [T + 1] int64
    docs: np.ndarray  # [P] int64, ascending within a term
    scores: np.ndarray  # [P] float32: the integer score / 100
    by_lower: Dict[str, List[int]]  # lowercased term -> term numbers

    def postings(self, term: int):
        a, b = self.offsets[term], self.offsets[term + 1]
        return self.docs[a:b], self.scores[a:b]

    def rows(self, term: int) -> int:
        return int(self.offsets[term + 1] - self.offsets[term])


class ReferenceIndex:
    """Every field of the corpus, built from its ndjson text and the index
    configuration's fulltext options."""

    def __init__(self, ndjson: str, config: dict, fields=None):
        """``fields``: the fields to index (all of them when None)."""
        lines = [ln for ln in ndjson.split("\n") if ln.strip()]
        self.num_docs = len(lines)
        docs_of_line: Dict[str, list] = defaultdict(list)
        for doc, line in enumerate(lines):
            docs_of_line[line].append(doc)
        del lines
        # field -> value -> doc ids holding it
        values: Dict[str, Dict[str, list]] = defaultdict(lambda: defaultdict(list))
        for line, docs in docs_of_line.items():
            obj = json.loads(line)
            if not isinstance(obj, dict):
                raise NotImplementedError("the reference indexes flat documents only")
            for key, value in obj.items():
                text = _text_of(value)
                if text is not None and (fields is None or key in fields):
                    values[key][text].extend(docs)
        del docs_of_line
        self.fields = {name: self._build_field(name, texts, config) for name, texts in values.items()}

    @staticmethod
    def _options(name: str, config: dict):
        opts = dict((config.get("*GLOBAL*") or {}).get("fulltext") or {})
        opts.update((config.get(name) or {}).get("fulltext") or {})
        unknown = set(opts) - {"tokenize", "tokenize_on_chars", "do_not_store_text_longer_than"}
        if unknown:
            raise NotImplementedError(f"fulltext options the reference does not model: {sorted(unknown)}")
        seps = opts.get("tokenize_on_chars")
        return (bool(opts.get("tokenize", True)),
                tokenizer.DEFAULT_SEPARATORS if seps is None else "".join(seps),
                int(opts.get("do_not_store_text_longer_than", DEFAULT_MAX_STORED_BYTES)))

    def _build_field(self, name: str, texts: Dict[str, list], config: dict) -> Field:
        tokenize, separators, max_bytes = self._options(name, config)
        occurrences: Counter = Counter()  # term -> occurrences over all documents
        # one entry per (text, term in it): the term, its first position,
        # the text's token count, whether it is the exact text, its documents
        e_term, e_pos, e_ntok, e_exact, e_docs = [], [], [], [], []
        for text, docs in texts.items():
            if len(text.encode("utf-8")) <= max_bytes:
                occurrences[text] += len(docs)
                e_term.append(text)
                e_pos.append(0)
                e_ntok.append(1)
                e_exact.append(True)
                e_docs.append(docs)
            toks = tokenizer.pieces(text, separators) if tokenize else []
            if len(toks) > 1:
                if len(docs) == 1:
                    occurrences.update(toks)
                else:
                    for tok, n in Counter(toks).items():
                        occurrences[tok] += n * len(docs)
                # each token's first position: later (smaller) positions overwrite
                first = dict(zip(reversed(toks), range(len(toks) - 1, -1, -1)))
                e_term.extend(first)
                e_pos.extend(first.values())
                e_ntok.extend([len(toks)] * len(first))
                e_exact.extend([False] * len(first))
                e_docs.extend([docs] * len(first))
        terms = sorted(occurrences)
        number = {t: i for i, t in enumerate(terms)}
        tid = np.fromiter((number[t] for t in e_term), dtype=np.int64, count=len(e_term))
        occ = np.fromiter((occurrences[t] for t in e_term), dtype=np.int64, count=len(e_term))
        exact = np.asarray(e_exact, dtype=bool)
        score = np.zeros(len(e_term), np.uint32)
        score[exact] = token_score(np.zeros(int(exact.sum())), occ[exact], np.ones(int(exact.sum())), exact=True)
        score[~exact] = token_score(np.asarray(e_pos)[~exact], occ[~exact], np.asarray(e_ntok)[~exact],
                                    exact=False)
        counts = np.fromiter((len(d) for d in e_docs), dtype=np.int64, count=len(e_docs))
        flat_term = np.repeat(tid, counts)
        flat_docs = np.fromiter(chain.from_iterable(e_docs), dtype=np.int64, count=int(counts.sum()))
        flat_score = np.repeat(score, counts)
        order = np.lexsort((flat_docs, flat_term))
        flat_term, flat_docs, flat_score = flat_term[order], flat_docs[order], flat_score[order]
        if np.any((flat_term[1:] == flat_term[:-1]) & (flat_docs[1:] == flat_docs[:-1])):
            # one flat document holds one value per field, and a text is
            # never one of its own tokens, so no document repeats a term
            raise NotImplementedError("a term twice in one document")
        offsets = np.zeros(len(terms) + 1, np.int64)
        np.cumsum(np.bincount(flat_term, minlength=len(terms)), out=offsets[1:])
        by_lower: Dict[str, List[int]] = defaultdict(list)
        for t, term in enumerate(terms):
            by_lower[term.lower()].append(t)
        return Field(terms, offsets, flat_docs, flat_score.astype(F32) / F32(100.0), dict(by_lower))
