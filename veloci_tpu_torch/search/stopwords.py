"""Bundled EN/DE stopword sets: the port's copy of
``veloci_tpu/search/stopwords.py``, reading its own ``stopword_lists/``
(reference: src/search/stopwords.rs; the lists are standard wordlist data)."""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import FrozenSet

__all__ = ["is_stopword", "get_stopwords"]

_DIR = Path(__file__).resolve().parent.parent / "stopword_lists"


@lru_cache(maxsize=None)
def get_stopwords(language: str) -> FrozenSet[str]:
    path = _DIR / language.lower()
    if not path.exists():
        raise KeyError(f"no stopword list for language {language!r}")
    return frozenset(
        line.strip().lower() for line in path.read_text().splitlines() if line.strip()
    )


def is_stopword(language: str, text: str) -> bool:
    return text in get_stopwords(language)
