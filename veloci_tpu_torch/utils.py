"""Path helpers: the port's copy of ``get_steps_to_anchor``
(``veloci_tpu/utils.py:64``)."""

from __future__ import annotations

from typing import List

from .create import TEXTINDEX

__all__ = ["get_steps_to_anchor"]


def get_steps_to_anchor(path: str) -> List[str]:
    """Join steps from anchor to a field (util.rs:146-162): every `[]` level
    plus the final `<path>.textindex`."""
    paths = []
    current: List[str] = []
    for part in path.split("."):
        current.append(part)
        if part.endswith("[]"):
            paths.append(".".join(current))
    paths.append(path + TEXTINDEX)
    return paths
