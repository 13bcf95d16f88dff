"""Serving observability: process-wide counters of the routes that answered.

Counterpart of ``veloci_tpu/search/stats.py``, with the same functions and
the same :func:`snapshot` keys, served as ``GET /stats`` (``server.py``),
but for the reference's ``record_latency`` and ``latency_ms_total``, which
nothing writes there. A request's time is read from the program's spans
(:mod:`..trace`).
The routes are the port's own: :func:`.batch.search_batch` counts each
request under its tree route (``batched_single_term``, ``batched_tree``,
``batched_tree_deep``, ``batched_generic``, the keys of
``TorchIndex.path_counts``), and a request the dense executor answers
counts as a fallback whose reason is the key of the admission row that sent
it there (:data:`.batch._ADMISSION`), ``tree_shape`` for a tree beyond
OR(AND(OR)) once flattened, or ``dense_only`` when the caller asked for
the executor. The server's fold loop counts its dispatches.
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from typing import Dict

__all__ = ["count_path", "count_fallback", "snapshot", "reset"]

_LOCK = threading.Lock()
_PATHS: Counter = Counter()
_FALLBACKS: Counter = Counter()
_START = time.time()


def count_path(path: str, n: int = 1) -> None:
    with _LOCK:
        _PATHS[path] += n


def count_fallback(reason: str, n: int = 1) -> None:
    with _LOCK:
        _PATHS["per_request_fallback"] += n
        _FALLBACKS[reason] += n


def snapshot() -> Dict:
    with _LOCK:
        total = sum(_PATHS.values())
        fast = total - _PATHS.get("per_request_fallback", 0)
        return {
            "uptime_s": round(time.time() - _START, 1),
            "total_requests": total,
            "fast_path_requests": fast,
            "fast_path_pct": round(100.0 * fast / total, 2) if total else None,
            "paths": dict(_PATHS),
            "fallback_reasons": dict(_FALLBACKS),
        }


def reset() -> None:
    with _LOCK:
        _PATHS.clear()
        _FALLBACKS.clear()
