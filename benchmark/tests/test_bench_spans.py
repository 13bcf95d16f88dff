"""The reduction of the program's spans (``harness/spans.py``) on hand-built
profiler events, ``trace.reduce`` with and without program spans, and the
clock the profiler's spans and the harness's collection intervals share."""

import json
import time

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark.harness import spans, trace

MS = 1_000_000  # ns


class Event:
    """A stand-in for a profiler event (``torch.profiler``'s kineto event)."""

    def __init__(self, name, start, end, device=DeviceType.CPU, annotation=False, corr=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._annotation, self._corr = device, annotation, corr

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return self._annotation

    def correlation_id(self):
        return self._corr


def span(name, start, end):
    return Event(name, start * MS, end * MS, annotation=True)


def program_events():
    """Two requests in a window of 0-100 ms: each a ``request.parse`` root
    and a ``search`` root holding ``search.plan`` and ``search_batch.answer``,
    which holds ``answer.readback``; the waits are a stream sync (by name),
    a device-to-host copy (by its copy's correlation id), a host-to-device
    copy and a sync outside every span (neither counted)."""
    ev = [span(trace.WINDOW_SPAN, 0, 100)]
    for base in (0, 50):
        ev += [span("request.parse", base + 1, base + 2), span("search", base + 3, base + 40),
               span("search.plan", base + 4, base + 6), span("search_batch.answer", base + 10, base + 38),
               span("answer.readback", base + 30, base + 36)]
        ev += [Event("cudaStreamSynchronize", (base + 31) * MS, (base + 33) * MS, corr=base + 1),
               Event("cudaMemcpyAsync", (base + 33) * MS, (base + 35) * MS, corr=base + 2),
               Event("Memcpy DtoH (Device -> Pageable)", (base + 34) * MS, (base + 35) * MS, DeviceType.CUDA,
                     corr=base + 2),
               Event("cudaMemcpyAsync", (base + 11) * MS, (base + 12) * MS, corr=base + 3),
               Event("Memcpy HtoD (Pageable -> Device)", (base + 12) * MS, (base + 13) * MS, DeviceType.CUDA,
                     corr=base + 3),
               Event("sort_kernel", (base + 14) * MS, (base + 29) * MS, DeviceType.CUDA, corr=base + 4),
               Event("cudaLaunchKernel", (base + 14) * MS, (base + 15) * MS, corr=base + 4)]
    ev.append(Event("cudaDeviceSynchronize", 99 * MS, int(99.5 * MS)))  # outside every span
    return ev


class Prof:
    """What the reducers read of a ``torch.profiler.profile``."""

    def __init__(self, events):
        class Results:
            def events(self_):
                return events

        class Profiler:
            kineto_results = Results()

        self.profiler = Profiler()


def test_self_time_waits_and_roots():
    out = spans.reduce(Prof(program_events()), trace.WINDOW_SPAN)
    rows, roots = out["by_name"], out["roots"]
    assert set(rows) == {"request.parse", "search", "search.plan", "search_batch.answer", "answer.readback"}
    assert all(r["calls"] == 2 for r in rows.values())
    # self time is the duration less the child spans: search 37 - 2 - 28
    assert rows["search"]["total_s"] == pytest.approx(2 * 0.037)
    assert rows["search"]["self_s"] == pytest.approx(2 * 0.007)
    assert rows["search_batch.answer"]["self_s"] == pytest.approx(2 * 0.022)
    assert rows["answer.readback"]["self_s"] == pytest.approx(2 * 0.006)
    # the sync by name and the DtoH copy by its correlation id; not the
    # HtoD copy, a launch, or the sync outside every span
    assert out["waits_found"] == {"sync": 3, "dtoh_copy": 2}
    assert rows["answer.readback"]["self_wait_s"] == pytest.approx(2 * 0.004)
    assert rows["search"]["wait_s"] == pytest.approx(2 * 0.004) and rows["search"]["self_wait_s"] == 0
    assert rows["request.parse"]["wait_s"] == 0
    # roots: two parses and two searches, four calls into the program
    assert roots["calls"] == 4
    assert roots["total_s"] == pytest.approx(2 * (0.001 + 0.037))
    assert roots["wait_s"] == pytest.approx(2 * 0.004)
    assert spans.root_host_s({"spans": out}) == pytest.approx(2 * 0.034)


def test_containment_assigns_spans_to_their_root():
    """Spans cut at their parent's end, and spans on the window's edges."""
    rows = spans._tree([(0, 10, "a"), (2, 12, "b"), (12, 14, "c"), (20, 30, "a")], [(5, 7), (13, 14), (40, 41)])
    assert rows[None]["calls"] == 3  # a, c, the second a; b lies in the first a
    assert rows["b"]["total_s"] == pytest.approx(8e-9)  # cut at 10
    assert rows["a"]["self_s"] == pytest.approx(12e-9)
    assert rows[None]["wait_s"] == pytest.approx(3e-9)  # the wait at 40 lies in no span
    outside = spans.from_events([span(trace.WINDOW_SPAN, 10, 20), span("search", 5, 8), span("search", 12, 14)],
                                trace.WINDOW_SPAN)[0]
    assert outside == [(12 * MS, 14 * MS, "search")]


def test_no_program_spans_read_nothing():
    """A program without spans or counters: the metrics leave themselves out."""
    out = spans.reduce(Prof([e for e in program_events() if not e.is_user_annotation()
                             or e.name() == trace.WINDOW_SPAN]), trace.WINDOW_SPAN)
    assert out["by_name"] == {} and out["roots"] is None
    assert spans.root_host_s({"spans": out}) is None and spans.root_wait_s({"spans": out}) is None
    assert spans.work({"work": {}}, "sorted_keys") is None
    assert spans.work({"work": {"sorted_keys": {"single": 12, "tree": 3}}}, "sorted_keys") == 15

    class Index:
        gathered_rows = {"single": 5}

    assert spans.counters(Index()) == {"gathered_rows": {"single": 5}}
    assert spans.delta({"gathered_rows": {"single": 5}}, {"gathered_rows": {"single": 9, "tree": 2}}) == {
        "gathered_rows": {"single": 4, "tree": 2}}


def test_trace_reduce_unchanged_by_program_spans():
    """``trace.reduce`` on the same events with and without the program's
    spans: the same output but for the idle labels, which the spans name."""
    events = program_events()
    without = [e for e in events if not e.is_user_annotation() or e.name() == trace.WINDOW_SPAN]
    reduce = getattr(trace.reduce, "original", trace.reduce)  # as it is before spans.install()
    a, b = reduce(Prof(events)), reduce(Prof(without))
    assert set(a) == set(b)
    for key in a:
        if key != "idle_gaps":
            assert json.dumps(a[key]) == json.dumps(b[key]), key
    assert sum(s for _n, s in a["idle_gaps"]) == pytest.approx(sum(s for _n, s in b["idle_gaps"]))
    assert any(name.startswith("answer.readback") for name, _s in a["idle_gaps"])
    assert not any(name.startswith("search") or name.startswith("answer") for name, _s in b["idle_gaps"])


class Program:
    """A stand-in for the port and its index: each search gathers 7 rows."""

    class Request:
        @staticmethod
        def from_dict(d):
            return d

    class Index:
        def __init__(self):
            self.gathered_rows = {"single": 0}

    @staticmethod
    def search(request, index):
        index.gathered_rows["single"] += 7

        class Result:
            data, num_hits = [], 0

        return Result()


def hooked_window():
    """The hooked answerer and window over :class:`Program`, as the runner
    calls them: a window of no seconds answers one lone request."""
    from benchmark.harness import window

    spans.install()
    index = Program.Index()
    index.gathered_rows["single"] = 100  # rows gathered before the window
    answer = window.answerer(Program, index, "lone")

    class Stream:
        def next_unit(self):
            return [{"search_req": "a"}]

    return window.run(answer, Stream(), 0.0, np.zeros(0, bool), window.GcClock())


def test_installed_reduce_keeps_what_trace_reduce_gives():
    """With the hooks installed, ``trace.reduce`` gives what it gave and
    adds ``spans`` (the idle time by innermost span among them) and
    ``work``, the counters' deltas over the window."""
    spans.install()
    spans.install()  # once only
    original = trace.reduce.original
    assert not getattr(original, "reads_spans", False)
    w = hooked_window()
    got, want = trace.reduce(Prof(program_events())), original(Prof(program_events()))
    assert {k: got[k] for k in want} == want and set(got) - set(want) == {"spans", "work"}
    assert got["work"] == {"gathered_rows": {"single": 7 * w.answered}}
    assert spans.per_request({"trace": got, "window": w}, lambda t: spans.work(t, "gathered_rows")) == 7
    idle = got["spans"]["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(sum(s for _n, s in original(Prof(program_events()), top=None)
                                                   ["idle_gaps"]))
    assert idle["answer.readback"] > 0 and idle.get(None, 0) > 0  # the gap before the first request


def test_profiler_spans_share_the_wall_clock():
    """A span's start and end in the profiler against ``time.time_ns()``
    read beside it: the clock of the harness's full-collection intervals."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        before = time.time_ns()
        with record_function("probe"):
            time.sleep(0.005)
        after = time.time_ns()
    probe = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(probe) == 1
    start, end = probe[0].start_ns(), probe[0].start_ns() + probe[0].duration_ns()
    assert abs(start - before) < MS and abs(end - after) < MS, (start - before, end - after)
    assert np.isclose(end - start, after - before, atol=MS)


def test_a_traced_record_without_spans_or_work_raises():
    """A window not run through the hooks leaves ``work`` out of the reduced
    trace, and the metrics raise on it; an untraced record reads nothing."""
    from benchmark.harness import window

    spans.install()
    hooked_window()
    trace.reduce(Prof(program_events()))  # takes the window's work
    w = window.run(lambda unit: [None], type("S", (), {"next_unit": lambda self: [{}]})(), 0.0, np.zeros(0, bool),
                   window.GcClock())
    got = trace.reduce(Prof(program_events()))
    assert "spans" in got and "work" not in got
    with pytest.raises(KeyError, match="work"):
        spans.per_request({"trace": got, "window": w}, spans.root_wait_s)
    with pytest.raises(KeyError, match="spans or work"):
        spans.per_request({"trace": trace.reduce.original(Prof(program_events())), "window": w},
                          spans.root_wait_s)
    assert spans.per_request({"trace": None, "window": w}, spans.root_wait_s) is None
