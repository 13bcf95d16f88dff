"""The comparison that decides ``correct``.

The requests the window answered and the seed picked (all of them in a
lone cell) are answered again by the plain reference
(:mod:`benchmark.reference`), on its own index of the same corpus, and
compared:

* ``failed``: requests that raised, at most 0;
* ``checked``: requests compared, at least 1;
* ``ids_wrong``: requests whose hit ids (in order) differ, at most 0;
* ``hits_wrong``: requests whose ``num_hits`` differs, at most 0;
* ``score_gap``: the largest relative gap between a hit's score and the
  reference's, over the hits whose ids agree, at most the configuration's
  ``score_rel_gap`` (set from the readings in PERF.md).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def compare(answers: Iterable[Tuple[dict, list, list, int]], reference, failed: int,
            score_limit: float) -> Dict[str, dict]:
    """The compared numbers, each with its limit (``max`` or ``min``)."""
    checked = ids_wrong = hits_wrong = 0
    gap = 0.0
    for request, ids, scores, num_hits in answers:
        want = reference.answer(request)
        checked += 1
        if list(ids) != want.ids.tolist():
            ids_wrong += 1
        if int(num_hits) != want.num_hits:
            hits_wrong += 1
        n = min(len(ids), len(want.ids))
        same = np.asarray(ids[:n]) == want.ids[:n]
        if same.any():
            got = np.asarray(scores[:n], dtype=np.float64)[same]
            ref = want.scores[:n].astype(np.float64)[same]
            gap = max(gap, float(np.max(np.abs(got - ref) / np.abs(ref))))
    return {
        "failed": {"value": int(failed), "max": 0},
        "checked": {"value": checked, "min": 1},
        "ids_wrong": {"value": ids_wrong, "max": 0},
        "hits_wrong": {"value": hits_wrong, "max": 0},
        "score_gap": {"value": gap, "max": float(score_limit)},
    }


def holds(checks: Dict[str, dict]) -> bool:
    return all(("max" not in c or c["value"] <= c["max"]) and ("min" not in c or c["value"] >= c["min"])
               for c in checks.values())


def lines(checks: Dict[str, dict]) -> list:
    """One line a number: its name, value, limit and whether it holds."""
    out = []
    for name, c in checks.items():
        limit = f"<= {c['max']!r}" if "max" in c else f">= {c['min']!r}"
        ok = holds({name: c})
        out.append(f"check {name} {c['value']!r} {limit} {'ok' if ok else 'FAILS'}")
    return out
