"""Char-class tokenizers.

Reproduces the reference tokenizer semantics (reference: src/tokenizer/mod.rs,
simple_tokenizer.rs, simple_tokenizer_group.rs):

* ``SimpleTokenizerCharsIterateGroupTokens`` — splits a text on a configurable
  separator character set, *grouping consecutive separators into one token*:
  ``"das \n ist"`` -> ``["das", " \n ", "ist"]``. Each emitted item is
  ``(token, is_separator)``.
* ``SimpleTokenizer`` — same, but separators are emitted one-by-one.

The default separator set is the reference's 26-char DEFAULT_SEPERATORS
(src/tokenizer/mod.rs:21-27).

The port's copy of ``veloci_tpu/tokenizer.py``. The tokenizer runs on the
host in the index build and in highlighting; no device code tokenizes.
"""

from __future__ import annotations

import re
from typing import Iterator, List, Sequence, Tuple

# Reference: src/tokenizer/mod.rs:21-27 (DEFAULT_SEPERATORS, 26 chars).
DEFAULT_SEPARATORS: str = " \t\n\r:(),.…;・’—-\\[]{}<>'\"“™"

__all__ = [
    "DEFAULT_SEPARATORS",
    "SimpleTokenizer",
    "GroupTokenizer",
    "Tokenizer",
]


class Tokenizer:
    """Interface: reference src/tokenizer/mod.rs:8-13 (`trait Tokenizer`)."""

    def iter(self, text: str) -> Iterator[Tuple[str, bool]]:
        raise NotImplementedError

    def has_tokens(self, text: str) -> bool:
        """True when tokenizing yields more than one token."""
        it = self.iter(text)
        try:
            next(it)
            next(it)
            return True
        except StopIteration:
            return False

    def tokens(self, text: str) -> List[Tuple[str, bool]]:
        return list(self.iter(text))


class GroupTokenizer(Tokenizer):
    """Groups consecutive separator chars into one token.

    Reference: src/tokenizer/simple_tokenizer_group.rs
    (`SimpleTokenizerCharsIterateGroupTokens` + `SimpleTokenizerGroupTokenIter`).
    """

    __slots__ = ("separators", "_sep_set", "_split_re")

    def __init__(self, separators: Sequence[str] | None = None) -> None:
        self.separators = (
            "".join(separators) if separators is not None else DEFAULT_SEPARATORS
        )
        self._sep_set = frozenset(self.separators)
        # C-speed equivalent of iter(): split on separator RUNS; pieces
        # alternate (non-sep, sep-run, non-sep, ...) with empty strings at
        # run boundaries, which pieces() skips — parity-tested against
        # iter() in tests/test_torch_host.py
        cls = "".join(re.escape(c) for c in sorted(self._sep_set))
        self._split_re = re.compile(f"([{cls}]+)") if cls else None

    def pieces(self, text: str) -> List[Tuple[str, bool]]:
        """`list(iter(text))` through one ``re.split``; the reference's
        API counterpart, with no caller in the port."""
        if self._split_re is None:
            return [(text, False)] if text else []
        parts = self._split_re.split(text)
        out = []
        for i, piece in enumerate(parts):
            if piece:
                out.append((piece, bool(i & 1)))
        return out

    def token_list(self, text: str) -> List[str]:
        """Just the token/separator-run strings of :meth:`pieces`; the
        reference's API counterpart, with no caller in the port."""
        if self._split_re is None:
            return [text] if text else []
        return [p for p in self._split_re.split(text) if p]

    def iter(self, text: str) -> Iterator[Tuple[str, bool]]:
        sep = self._sep_set
        last_returned = 0
        last_was_token = False  # True while scanning a separator run
        for pos, ch in enumerate(text):
            if ch in sep:
                if pos == 0:
                    last_was_token = True
                elif not last_was_token:
                    yield text[last_returned:pos], False
                    last_was_token = True
                    last_returned = pos
            else:
                if last_was_token:
                    yield text[last_returned:pos], True
                    last_was_token = False
                    last_returned = pos
        if last_returned != len(text):
            yield text[last_returned:], last_was_token

    def __repr__(self) -> str:  # pragma: no cover
        return f"GroupTokenizer(separators={self.separators!r})"


class SimpleTokenizer(Tokenizer):
    """Emits each separator char as its own token.

    Reference: src/tokenizer/simple_tokenizer.rs (`SimpleTokenizer`).
    """

    __slots__ = ("_sep_set",)

    def __init__(self) -> None:
        self._sep_set = frozenset(DEFAULT_SEPARATORS)

    def iter(self, text: str) -> Iterator[Tuple[str, bool]]:
        sep = self._sep_set
        last_returned = 0
        last_was_token = False
        for pos, ch in enumerate(text):
            if ch in sep:
                if pos == 0:
                    last_was_token = True
                else:
                    yield text[last_returned:pos], False
                    last_was_token = True
                    last_returned = pos
            else:
                if last_was_token:
                    yield text[last_returned:pos], True
                    last_was_token = False
                    last_returned = pos
        if last_returned != len(text):
            yield text[last_returned:], last_was_token
