"""The measured window: one closed-loop client for ``seconds`` seconds.

Each unit (a batch, or one request) goes to the program as the request
JSON the traffic made; the program parses it (``Request.from_dict``) and
answers (``search_batch`` or ``search``), and the unit's latency runs from
that call to its last result on the host. A unit that raises counts its
requests as attempted and failed. The window ends with the first unit that
returns after ``seconds``; its length is the time to that return.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Callable, List

import numpy as np


class GcClock:
    """Milliseconds spent in the collector's generation-2 (full)
    collections while ``active``, and each one's interval on the wall
    clock (ns, the profiler's time base)."""

    def __init__(self):
        self.active = False
        self.ms = 0.0
        self.count = 0
        self.intervals = []
        self._t = None

    def __call__(self, phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            self._t = (time.perf_counter(), time.time_ns())
        elif self._t is not None:
            if self.active:
                self.ms += (time.perf_counter() - self._t[0]) * 1e3
                self.count += 1
                self.intervals.append((self._t[1], time.time_ns()))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self)


@dataclass
class Window:
    seconds: float = 0.0
    attempted: int = 0
    answered: int = 0
    failed: int = 0
    latencies: List[float] = field(default_factory=list)  # per unit, s
    unit_sizes: List[int] = field(default_factory=list)
    checked: List[tuple] = field(default_factory=list)  # (request, ids, scores, num_hits)
    errors: List[str] = field(default_factory=list)
    gc_ms: float = 0.0
    gc_count: int = 0
    gc_intervals: List[tuple] = field(default_factory=list)  # (start, end) ns, wall clock

    def request_latencies_ms(self) -> np.ndarray:
        return np.repeat(np.asarray(self.latencies) * 1e3, self.unit_sizes)


def answerer(vt, index, loop: str) -> Callable:
    """The call the window makes for a unit of request JSON."""

    def call(unit):
        requests = [vt.Request.from_dict(d) for d in unit]
        if loop == "batch":
            return vt.search_batch(requests, index)
        return [vt.search(requests[0], index)]

    return call


def summary(result) -> tuple:
    return ([int(h.id) for h in result.data], [float(h.score) for h in result.data], int(result.num_hits))


def run(answer: Callable, stream, seconds: float, check: np.ndarray, gc_clock: GcClock) -> Window:
    """Drive ``answer`` with ``stream``'s units for ``seconds``; keep the
    answers of the requests ``check`` marks."""
    w = Window()
    position = 0
    gc_clock.ms, gc_clock.count, gc_clock.intervals = 0.0, 0, []
    gc_clock.active = True
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        unit = stream.next_unit()
        t = time.perf_counter()
        try:
            results = answer(unit)
        except Exception as exc:  # a unit that raises fails its requests; the window goes on
            results = None
            if len(w.errors) < 5:
                w.errors.append(f"{type(exc).__name__}: {exc}")
        now = time.perf_counter()
        n = len(unit)
        w.attempted += n
        if results is None or len(results) != n:
            w.failed += n
        else:
            w.answered += n
            w.latencies.append(now - t)
            w.unit_sizes.append(n)
            for k in range(n):
                if position + k < len(check) and check[position + k]:
                    w.checked.append((unit[k], *summary(results[k])))
        position += n
        if now >= deadline:
            break
    w.seconds = time.perf_counter() - start
    gc_clock.active = False
    w.gc_ms, w.gc_count, w.gc_intervals = gc_clock.ms, gc_clock.count, list(gc_clock.intervals)
    return w
