"""The program's spans in the traced window, and its work counters.

The port opens a span (``torch.profiler.record_function``, through its
``trace`` timers) at each layer boundary of a request while a profiler
runs. :func:`reduce` reads them from the same ``torch.profiler`` profile
that :func:`.trace.reduce` reads and gives, for each span name, its calls,
its time, its self time (its time less the part its child spans cover)
and the host's blocking waits on the device inside it. A blocking wait is
the host's time in a ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``
or ``cudaEventSynchronize`` call, or in a ``cudaMemcpy*`` call whose copy
on the device (the event of the same correlation id) runs device to host.
A span with no span of the program around it is a root: one call into the
program. The window has one client thread, so a span's children and
waits are what lies inside it in time.

:func:`install` makes every traced run of the process read the spans and
the index's counters (``TorchIndex.gathered_rows``, ``sorted_keys``): the
window's deltas of the counters, and ``spans`` and ``work`` in the dict
that :func:`.trace.reduce` returns, which the metrics read as
``record["trace"]``. A program without spans or counters gives an empty
``spans`` and a ``work`` without them; a traced record without ``spans``
or ``work`` makes the metrics raise (:func:`per_request`). The hooks reach
the runner only while it calls these three through their modules; a
``benchmark`` change would put the two reads in ``runner.py`` instead.
"""

from __future__ import annotations

import sys
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COUNTERS = ("gathered_rows", "sorted_keys")


def _tree(spans: Iterable[Tuple[int, int, str]], waits: Iterable[Tuple[int, int]]) -> Dict[str, dict]:
    """Per span name: ``calls``, ``total_s``, ``self_s``, ``wait_s`` (the
    waits inside its spans) and ``self_wait_s`` (those inside no child),
    and under ``None`` the roots' sums. ``spans`` are ``(start_ns, end_ns,
    name)``, ``waits`` ``(start_ns, end_ns)``; a child that outlasts its
    parent is cut at the parent's end."""
    items = [(s, t, 0, n) for s, t, n in spans] + [(s, t, 1, None) for s, t in waits]
    items.sort(key=lambda r: (r[0], -r[1], r[2]))
    out: Dict[Optional[str], dict] = defaultdict(
        lambda: {"calls": 0, "total_s": 0.0, "self_s": 0.0, "wait_s": 0.0, "self_wait_s": 0.0})
    stack: List[list] = []  # [end, name, total, covered by children, waits inside, waits in no child]

    def close(frame):
        _end, name, total, covered, wait, self_wait = frame
        for row in (out[name], out[None]) if not stack else (out[name],):
            row["calls"] += 1
            row["total_s"] += total / 1e9
            row["self_s"] += (total - covered) / 1e9
            row["wait_s"] += wait / 1e9
            row["self_wait_s"] += self_wait / 1e9

    for start, end, kind, name in items:
        while stack and stack[-1][0] <= start:
            close(stack.pop())
        if stack:
            end = min(end, stack[-1][0])
        length = max(0, end - start)
        if kind == 1:
            for frame in stack:
                frame[4] += length
            if stack:
                stack[-1][5] += length
            continue
        if stack:
            stack[-1][3] += length
        stack.append([end, name, length, 0, 0, 0])
    while stack:
        close(stack.pop())
    return dict(out)


def from_events(events, window_span: str) -> Tuple[list, list, dict]:
    """``(spans, waits, found)`` of the profiler's ``events``: the program's
    host spans and the blocking waits inside the window span, and how many
    waits of each kind were found."""
    from torch.autograd import DeviceType

    window, spans, calls, dtoh = None, [], [], set()
    for e in events:
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if "DtoH" in name:
                dtoh.add(e.correlation_id())
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.is_user_annotation():
            if name == window_span:
                window = (start, end)
            else:
                spans.append((start, end, name))
        elif name in SYNCS or name.startswith("cudaMemcpy"):
            calls.append((start, end, name, e.correlation_id()))
    if window is None:
        return [], [], {}
    w0, w1 = window
    inside = [(s, t, n) for s, t, n in spans if w0 <= s < w1]
    waits, found = [], {"sync": 0, "dtoh_copy": 0}
    for s, t, name, corr in calls:
        if not w0 <= s < w1:
            continue
        if name in SYNCS:
            found["sync"] += 1
        elif corr in dtoh:
            found["dtoh_copy"] += 1
        else:
            continue
        waits.append((s, t))
    return inside, waits, found


def reduce(prof, window_span: str) -> dict:
    """The program's spans in ``prof``'s window (see the module note):
    ``{"by_name": {name: row}, "roots": row, "waits_found": {...}}``."""
    spans, waits, found = from_events(prof.profiler.kineto_results.events(), window_span)
    rows = _tree(spans, waits)
    roots = rows.pop(None, None)
    return {"by_name": rows, "roots": roots, "waits_found": found}


def idle_by_span(spans: dict, idle_gaps) -> Dict[str, float]:
    """The device's idle seconds by the innermost program span across them
    (``None``: no program span), from every label of ``idle_gaps``."""
    out: Dict[Optional[str], float] = defaultdict(float)
    for label, seconds in idle_gaps:
        first = label.split(" > ")[0]
        out[first if first in spans["by_name"] else None] += seconds
    return dict(out)


def table(spans: dict, answered: int) -> List[str]:
    """The spans as lines of text, by self time, ms a request; the last
    column the device's idle time under the span (innermost)."""
    rows = sorted(spans["by_name"].items(), key=lambda kv: -kv[1]["self_s"])
    per = 1e3 / max(answered, 1)
    idle = spans.get("idle_by_span", {})
    lines = [f"{'span':<28}{'calls/req':>10}{'total':>10}{'self':>10}{'wait':>10}{'self wait':>10}{'idle':>10}"
             "  ms a request"]
    for name, r in rows:
        lines.append(f"{name:<28}{r['calls'] / max(answered, 1):>10.3f}{r['total_s'] * per:>10.4f}"
                     f"{r['self_s'] * per:>10.4f}{r['wait_s'] * per:>10.4f}{r['self_wait_s'] * per:>10.4f}"
                     f"{idle.get(name, 0.0) * per:>10.4f}")
    calls = sum(r["calls"] for r in spans["by_name"].values())
    lines.append(f"program spans {calls / max(answered, 1):.3f} a request, each with its profiler cost "
                 f"in host_ms_per_request")
    total = sum(idle.values())
    lines.append(f"device idle {total:.4f} s, {total - idle.get(None, 0.0):.4f} s of it under a program span; "
                 f"waits found: {spans['waits_found']}")
    return lines


def counters(index) -> dict:
    """The index's work counters, route by route, that it has."""
    return {name: dict(getattr(index, name)) for name in COUNTERS if hasattr(index, name)}


def delta(before: dict, after: dict) -> dict:
    return {name: {route: n - before.get(name, {}).get(route, 0) for route, n in routes.items()}
            for name, routes in after.items()}


def roots(trace: dict) -> Optional[dict]:
    """The root spans' sums in a reduced trace, or None without spans."""
    return (trace.get("spans") or {}).get("roots")


def root_host_s(trace: dict) -> Optional[float]:
    """The root spans' time less the blocking waits inside them, s."""
    r = roots(trace)
    return None if r is None else r["total_s"] - r["wait_s"]


def root_wait_s(trace: dict) -> Optional[float]:
    """The blocking waits inside the root spans, s."""
    r = roots(trace)
    return None if r is None else r["wait_s"]


def work(trace: dict, name: str) -> Optional[int]:
    """The window's delta of counter ``name`` over every route, or None
    where the program has no such counter."""
    routes = (trace.get("work") or {}).get(name)
    return None if routes is None else sum(routes.values())


def per_request(record: dict, value) -> Optional[float]:
    """``value(trace)`` over the traced window's answered requests, or None
    where it reads nothing. A traced record without ``spans`` or ``work``
    raises: the hooks of :func:`install` did not reach the runner."""
    t, w = record.get("trace"), record["window"]
    if t is None:
        return None
    missing = [key for key in ("spans", "work") if key not in t]
    if missing:
        raise KeyError(f"the traced record has no {' or '.join(missing)}: spans.install() did not hook the runner")
    if not w.answered:
        return None
    v = value(t)
    return None if v is None else v / w.answered


class _Run:
    """The index the window's answerer searches, and the counters' deltas
    over the window."""

    index = None
    work: Optional[dict] = None
    answered = 0


def install() -> None:
    """Wrap :func:`.window.answerer`, :func:`.window.run` and
    :func:`.trace.reduce` once, so that a traced run's ``record["trace"]``
    also holds ``spans`` (:func:`reduce`) and ``work`` (the counters'
    deltas over the window). The wrapped functions return what they
    returned."""
    from . import trace as tracing
    from . import window

    if getattr(tracing.reduce, "reads_spans", False):
        return
    answerer, run, trace_reduce = window.answerer, window.run, tracing.reduce

    def answerer_keeping_index(vt, index, loop):
        _Run.index = index
        return answerer(vt, index, loop)

    def run_counting(*args, **kwargs):
        index, _Run.index = _Run.index, None
        before = None if index is None else counters(index)
        w = run(*args, **kwargs)
        # no index: the runner did not build its answerer through the hook
        _Run.work = None if index is None else delta(before, counters(index))
        _Run.answered = w.answered
        return w

    def reduce_with_spans(prof, gc_intervals=(), top: int = 10):
        # every idle label, then the lists cut to ``top`` as trace.reduce cuts them
        out = trace_reduce(prof, gc_intervals, top=None)
        out["spans"] = reduce(prof, tracing.WINDOW_SPAN)
        out["spans"]["idle_by_span"] = idle_by_span(out["spans"], out["idle_gaps"])
        out["device_ops"], out["idle_gaps"] = out["device_ops"][:top], out["idle_gaps"][:top]
        if _Run.work is not None:
            out["work"], _Run.work = _Run.work, None
        if out["spans"]["by_name"]:
            for line in table(out["spans"], _Run.answered):
                print(f"spans: {line}", file=sys.stderr, flush=True)
        return out

    reduce_with_spans.reads_spans = True
    reduce_with_spans.original = trace_reduce
    window.answerer, window.run, tracing.reduce = answerer_keeping_index, run_counting, reduce_with_spans

