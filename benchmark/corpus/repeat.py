"""One document repeated: upstream veloci's large-corpus test
(``veloci_bins/src/bin/test_large_search.rs``), the same for every seed.

Parameters: ``document`` (a JSON object), ``docs`` (how many copies).
"""

from __future__ import annotations

import json


def words(params: dict, seed: int) -> dict:
    """Per field the words of its value, equally weighted: the words a
    request can find."""
    out = {}
    for field, value in params["document"].items():
        ws = [w for w in str(value).split(" ") if w]
        out[field] = (ws, [1.0 / len(ws)] * len(ws))
    return out


def ndjson(params: dict, seed: int) -> str:
    doc = json.dumps(params["document"], separators=(",", ":"), ensure_ascii=False)
    return "\n".join([doc] * int(params["docs"]))
