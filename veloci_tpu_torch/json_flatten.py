"""Streaming JSON document flattener: the port's copy of
``veloci_tpu/json_flatten.py``.

Walks each (already parsed) JSON document and emits:

* text leaves:   ``cb_text(anchor_id, text, path, parent_val_id)``
* array-element / root relations: ``cb_ids(anchor_id, path, value_id, parent_val_id)``

Path syntax: object keys joined with ``.``; arrays append ``[]`` —
``{"meanings": {"ger": ["x"]}}`` emits the text leaf at path
``meanings.ger[]``. Numbers/bools are stringified; ``null`` is skipped.

Per-path sequential ids are assigned by :class:`IDProvider`; the root path
``""`` id-space provides the **anchor ids** (document ids).

Reference: json_converter/src/lib.rs:69-166 (`for_each_element`,
`for_each_elemento`, `IDHolder`) and `convert_to_string` (lib.rs:6-14).
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Iterable

__all__ = ["IDProvider", "for_each_element", "convert_to_string", "to_line_delimited"]


def convert_to_string(value: Any) -> str:
    """JSON scalar -> text, matching serde semantics.

    Reference: json_converter/src/lib.rs:6-14. Bools render ``true/false``;
    integers plain; floats via repr (serde prints shortest round-trip, which
    Python's repr matches for the values in play).
    """
    if isinstance(value, str):
        return value
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        # serde_json prints shortest round-trip (20.0 -> "20.0"), as does repr.
        return repr(value)
    return ""


class IDProvider:
    """Per-path sequential id assignment (reference lib.rs:140-166 `IDHolder`)."""

    __slots__ = ("_counters",)

    def __init__(self) -> None:
        self._counters: Dict[str, int] = {}

    def get_id(self, path: str) -> int:
        nxt = self._counters.get(path)
        if nxt is None:
            self._counters[path] = 0
            return 0
        nxt += 1
        self._counters[path] = nxt
        return nxt


CbText = Callable[[int, str, str, int], None]
CbIds = Callable[[int, str, int, int], None]


def for_each_element(
    docs: Iterable[Any],
    id_provider: IDProvider,
    cb_text: CbText,
    cb_ids: CbIds,
) -> None:
    """Flatten a stream of parsed JSON docs (reference lib.rs:69-138)."""
    for doc in docs:
        root_id = id_provider.get_id("")
        _walk(doc, root_id, id_provider, root_id, "", "", cb_text, cb_ids)


def _walk(
    data: Any,
    anchor_id: int,
    id_provider: IDProvider,
    parent_id: int,
    current_path: str,
    el_name: str,
    cb_text: CbText,
    cb_ids: CbIds,
) -> None:
    if isinstance(data, list):
        path = current_path + el_name + "[]"
        for el in data:
            vid = id_provider.get_id(path)
            cb_ids(anchor_id, path, vid, parent_id)
            _walk(el, anchor_id, id_provider, vid, path, "", cb_text, cb_ids)
    elif isinstance(data, dict):
        path = current_path + el_name
        if path:
            path += "."
        for key, value in data.items():
            _walk(value, anchor_id, id_provider, parent_id, path, key, cb_text, cb_ids)
    elif data is not None:
        cb_text(anchor_id, convert_to_string(data), current_path + el_name, parent_id)


def to_line_delimited(data: bytes | str) -> str:
    """Convert arbitrary JSON (array / concatenated docs) into ndjson.

    Reference: src/create.rs:723-739 (`convert_any_json_data_to_line_delimited`).
    """
    if isinstance(data, bytes):
        data = data.decode("utf-8")
    out = []
    decoder = json.JSONDecoder()
    idx = 0
    n = len(data)
    while idx < n:
        while idx < n and data[idx].isspace():
            idx += 1
        if idx >= n:
            break
        value, idx = decoder.raw_decode(data, idx)
        if isinstance(value, list):
            for el in value:
                out.append(json.dumps(el, ensure_ascii=False, separators=(",", ":")))
        else:
            out.append(json.dumps(value, ensure_ascii=False, separators=(",", ":")))
    return "\n".join(out) + ("\n" if out else "")
