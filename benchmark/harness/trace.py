"""The traced run: the reduction of a ``torch.profiler`` trace to what the
per-layer metrics read.

The device's idle gaps are labelled by what the host was doing across
them: the innermost span (a full collection of the interpreter's
collector, or a ``record_function`` span of the program's own) and the
innermost operation the profiler recorded on the host.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np

WINDOW_SPAN = "bench.window"
GC_SPAN = "gc_full"


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted, merged ``[start, end]`` rows of ``intervals``."""
    if not len(intervals):
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), dtype=bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.flatnonzero(new)
    stops = ends[np.append(last[1:] - 1, len(iv) - 1)]
    return np.stack([starts, stops], axis=1)


def _timeline(rows):
    """Nested ``(start, end, name)`` intervals -> the innermost name over
    time: ``(cuts, ids, names)``, where ``ids[k]`` (an index into ``names``,
    0 for none) holds from ``cuts[k]`` to ``cuts[k + 1]``. An interval that
    outlasts its parent is cut at the parent's end."""
    names = [None]
    number = {}
    cuts, ids = [], []
    stack = []  # (end, id)
    last = None

    def emit(upto):
        nonlocal last
        if last is not None and upto > last:
            cuts.append(last)
            ids.append(stack[-1][1] if stack else 0)
        last = upto if last is None else max(last, upto)

    for start, end, name in sorted(rows, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= start:
            emit(stack[-1][0])
            stack.pop()
        emit(start)
        if name not in number:
            number[name] = len(names)
            names.append(name)
        stack.append((min(end, stack[-1][0]) if stack else end, number[name]))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    if last is not None:
        cuts.append(last)
    return np.asarray(cuts, dtype=np.float64), np.asarray(ids, dtype=np.int64), names


def _idle_by_label(gaps: np.ndarray, spans, ops) -> Dict[str, float]:
    """Idle seconds by ``span > op``: each gap is cut wherever the innermost
    span or operation changes, and each piece goes to what runs across it
    (``span``, ``op`` or ``span > op``; "python" where neither does)."""
    (sc, si, sn), (oc, oi, on) = _timeline(spans), _timeline(ops)
    points = np.unique(np.concatenate([gaps.ravel(), sc, oc]))
    lo, hi = points[:-1], points[1:]
    mid = (lo + hi) / 2
    g = np.searchsorted(gaps[:, 0], mid, side="right") - 1
    idle = (g >= 0) & (mid < gaps[np.clip(g, 0, None), 1]) if len(gaps) else np.zeros(len(mid), bool)

    def label(cuts, ids):
        k = np.searchsorted(cuts, mid, side="right") - 1
        inside = (k >= 0) & (k < len(ids))
        return np.where(inside, ids[np.clip(k, 0, max(len(ids) - 1, 0))] if len(ids) else 0, 0)

    key = label(sc, si) * len(on) + label(oc, oi)
    seconds = np.bincount(key[idle], weights=(hi - lo)[idle] / 1e9, minlength=len(sn) * len(on))
    out: Dict[str, float] = {}
    for k in np.flatnonzero(seconds):
        name = " > ".join(n for n in (sn[k // len(on)], on[k % len(on)]) if n is not None)
        out[name or "python"] = float(seconds[k])
    return out


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    if e.device_type() != DeviceType.CUDA:
        return False
    annotation = getattr(e, "is_user_annotation", None)
    return not (annotation is not None and annotation())


def reduce(prof, gc_intervals=(), top: int = 10) -> dict:
    """The traced window of ``prof``: its length, the union of the device's
    busy intervals inside it (kernels, copies, memsets), the count of device
    events, the device operations that took most time, and the idle time
    by what the host was running across each gap (:func:`_idle_by_label`):
    a full collection (``gc_intervals``, ``(start_ns, end_ns)`` on the wall
    clock) or a span of the program, and a profiled operation."""
    events = prof.profiler.kineto_results.events()
    window = None
    dev, ops, spans = [], [], [(s, t, GC_SPAN) for s, t in gc_intervals]
    for e in events:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if _is_device(e):
            dev.append((start, end, e.name()))
        elif e.name() == WINDOW_SPAN:
            window = (start, end)
        elif getattr(e, "is_user_annotation", lambda: False)():
            spans.append((start, end, e.name()))
        else:
            ops.append((start, end, e.name()))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    # timestamps from the window's start, exact integers before any float
    w0, w1 = 0, window[1] - window[0]
    dev = [(max(s - window[0], w0), min(t - window[0], w1), n) for s, t, n in dev
           if t > window[0] and s < window[1]]
    spans = [(s - window[0], t - window[0], n) for s, t, n in spans]
    ops = [(s - window[0], t - window[0], n) for s, t, n in ops]
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, n in dev:
        by_name[n] += (t - s) / 1e9
    busy = _union(np.array([(s, t) for s, t, _n in dev], dtype=np.float64).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)  # idle [start, end] rows
    gaps = edges[edges[:, 1] > edges[:, 0]]

    idle = _idle_by_label(gaps, spans, ops)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "device_events": len(dev),
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda r: -r[1])[:top],
        "idle_gaps": sorted(([n, s] for n, s in idle.items()), key=lambda r: -r[1])[:top],
    }
