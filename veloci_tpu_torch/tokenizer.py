"""Char-class tokenizer: the port's copy of the grouping tokenizer of
``veloci_tpu/tokenizer.py``, the one the index builder runs.

``GroupTokenizer`` (reference src/tokenizer/simple_tokenizer_group.rs,
``SimpleTokenizerCharsIterateGroupTokens``) splits a text on a configurable
separator character set, *grouping consecutive separators into one token*:
``"das \n ist"`` -> ``["das", " \n ", "ist"]``. Each emitted item is
``(token, is_separator)``. The default separator set is the reference's
26-char DEFAULT_SEPERATORS (src/tokenizer/mod.rs:21-27).
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

# Reference: src/tokenizer/mod.rs:21-27 (DEFAULT_SEPERATORS, 26 chars).
DEFAULT_SEPARATORS: str = " \t\n\r:(),.…;・’—-\\[]{}<>'\"“™"

__all__ = [
    "DEFAULT_SEPARATORS",
    "GroupTokenizer",
    "Tokenizer",
]


class Tokenizer:
    """Interface: reference src/tokenizer/mod.rs:8-13 (`trait Tokenizer`)."""

    def iter(self, text: str) -> Iterator[Tuple[str, bool]]:
        raise NotImplementedError

    def tokens(self, text: str) -> List[Tuple[str, bool]]:
        return list(self.iter(text))


class GroupTokenizer(Tokenizer):
    """Groups consecutive separator chars into one token.

    Reference: src/tokenizer/simple_tokenizer_group.rs
    (`SimpleTokenizerCharsIterateGroupTokens` + `SimpleTokenizerGroupTokenIter`).
    """

    __slots__ = ("separators", "_sep_set")

    def __init__(self, separators: Sequence[str] | None = None) -> None:
        self.separators = (
            "".join(separators) if separators is not None else DEFAULT_SEPARATORS
        )
        self._sep_set = frozenset(self.separators)

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
