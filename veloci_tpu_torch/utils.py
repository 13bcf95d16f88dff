"""Field-path helpers: the port's copies of ``veloci_tpu/utils.py``'s
``normalize_text``, ``extract_prop_name``, ``get_steps_to_anchor``,
``get_all_steps_to_anchor`` and ``to_node_tree`` with its ``LEAF`` and
``NodeTree`` (``:27-135``).

Reference: src/util.rs (get_steps_to_anchor :146-162, get_all_steps_to_anchor
:175-187, extract_prop_name :139-144, NodeTree / to_node_tree :189-229,
normalize_text :11-29).
"""

from __future__ import annotations

import re
from itertools import groupby
from typing import Dict, List, Union

from .create import TEXTINDEX

__all__ = [
    "LEAF",
    "NodeTree",
    "extract_prop_name",
    "get_all_steps_to_anchor",
    "get_steps_to_anchor",
    "normalize_text",
    "to_node_tree",
]

# NodeTree: dict prop -> subtree, or the LEAF sentinel
LEAF = "__leaf__"
NodeTree = Dict[str, Union[dict, str]]

_NORMALIZE_RULES = [
    (re.compile(r"\([fmn\d]\)"), " "),
    (re.compile(r"[\(\)]"), " "),
    (re.compile(r"[{}'\"“]"), ""),
    (re.compile(r"\s\s+"), " "),
    (re.compile(r"[,.…;・’-]"), ""),
]


def normalize_text(text: str) -> str:
    """Reference util.rs:11-29."""
    out = text
    for rx, repl in _NORMALIZE_RULES:
        out = rx.sub(repl, out)
    return out.lower().strip()


def extract_prop_name(path: str) -> str:
    """Last path component, `[]` and textindex stripped (util.rs:139-144)."""
    parts = [
        p[:-2] if p.endswith("[]") else p
        for p in path.split(".")
        if p != "textindex"
    ]
    return parts[-1]


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


def get_all_steps_to_anchor(path: str) -> List[str]:
    """All intermediate steps (util.rs:175-187)."""
    paths = []
    current: List[str] = []
    for part in path.split("."):
        current.append(part)
        paths.append(".".join(current))
    return paths


def to_node_tree(paths: List[List[str]]) -> NodeTree:
    """Build the select-reconstruction tree (util.rs:199-229)."""
    paths = sorted(paths, key=lambda el: el[0])
    next_map: NodeTree = {}
    for key, group in groupby(paths, key=lambda el: el[0]):
        next_paths = [el[1:] for el in group]
        is_leaf = any(len(el) == 0 for el in next_paths)
        next_paths = [el for el in next_paths if el]
        if not next_paths:
            next_map[key] = LEAF
        elif is_leaf:
            next_map[key] = LEAF
        else:
            next_map[key] = to_node_tree(next_paths)
    return next_map
