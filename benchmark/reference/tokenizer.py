"""veloci's text split, frozen for the reference: a text is cut at runs of
separator characters, and the pieces alternate between words and the runs
between them, which are tokens too (upstream
``src/tokenizer/simple_tokenizer_group.rs``). ``"das  ist"`` gives
``["das", "  ", "ist"]``."""

from __future__ import annotations

import re
from functools import lru_cache
from typing import List

# upstream src/tokenizer/mod.rs DEFAULT_SEPERATORS
DEFAULT_SEPARATORS = " \t\n\r:(),.…;・’—-\\[]{}<>'\"“™"


@lru_cache(maxsize=8)
def _splitter(separators: str):
    return re.compile("([" + "".join(re.escape(c) for c in sorted(set(separators))) + "]+)")


def pieces(text: str, separators: str = DEFAULT_SEPARATORS) -> List[str]:
    """The pieces of ``text``, words and separator runs alike."""
    return [piece for piece in _splitter(separators).split(text) if piece]
