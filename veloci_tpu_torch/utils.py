"""Field-path algebra and misc utilities: the port's copy of
``veloci_tpu/utils.py``.

Reference: src/util.rs (get_steps_to_anchor :146-162, get_all_steps_to_anchor
:175-187, extract_field_name :131-137, extract_prop_name :139-144, NodeTree /
to_node_tree :189-229, normalize_text :11-29) and src/steps.rs.
"""

from __future__ import annotations

import re
from itertools import groupby
from typing import Dict, List, Union

from .create import TEXTINDEX

__all__ = [
    "get_steps_to_anchor",
    "get_all_steps_to_anchor",
    "extract_field_name",
    "extract_prop_name",
    "normalize_text",
    "to_node_tree",
    "steps_between_field_paths",
    "LEAF",
    "NodeTree",
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


def extract_field_name(path: str) -> str:
    """Strip the trailing `.textindex` (reference util.rs:131-137)."""
    if path.endswith(TEXTINDEX):
        return path[: -len(TEXTINDEX)]
    return path


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


def steps_between_field_paths(start: str, end: str) -> List[str]:
    """Index-file chain between two field paths (reference
    src/steps.rs:126-150 `steps_between_field_paths`): walk up from `start`
    with `.value_id_to_parent` until reaching a shared stem, then down to
    `end` with `.parent_to_value_id`."""
    VALUE_ID_TO_PARENT = ".value_id_to_parent"
    PARENT_TO_VALUE_ID = ".parent_to_value_id"

    def components(path: str) -> List[str]:
        return path.split(".")

    start_c = components(start)
    end_c = components(end)

    def contained(prefix: List[str], full: List[str]) -> bool:
        return all(
            prefix[i] == full[i] for i in range(min(len(prefix), len(full)))
        )

    out: List[str] = []
    cur = list(start_c)
    while not contained(cur, end_c):
        cur.pop()
        out.append(".".join(cur) + VALUE_ID_TO_PARENT)
    out.append(".".join(cur) + PARENT_TO_VALUE_ID)
    remaining = [c for c in end_c if c not in cur]
    for comp in remaining:
        cur.append(comp)
        out.append(".".join(cur) + PARENT_TO_VALUE_ID)
    return out


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
