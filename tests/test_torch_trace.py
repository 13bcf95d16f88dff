"""The port's spans and work counters (``veloci_tpu_torch/trace.py``).

* Under ``torch.profiler``, a lone single-term request, a lone AND of two
  ORs and a ``dense_only`` request each record the documented span names,
  each nested under the span that caused it and all under their root
  (``search``); ``Request.from_dict`` and a direct ``search_batch`` are
  roots of their own.
* With the profiler and the log off, a timer is the one shared no-op
  object and no ``record_function`` is made; it costs less than a
  ``record_function`` or an ``@contextmanager`` timer.
* With ``VELOCI_LOG=info``, one ``search took`` line a ``search`` call,
  under a profiler too.
* ``TorchIndex.gathered_rows`` and ``sorted_keys`` move by the amounts the
  code implies: a single-term run is gathered once and sorted twice.

Tolerance: exact. The corpus is made here, from fixed words."""

import json
import logging
import os
import subprocess
import sys
import timeit
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import veloci_tpu_torch as vt
from veloci_tpu_torch import trace
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture
from torch_rebind import on_the_cpu  # noqa: F401 -- the CPU is the default device here

REPO = Path(__file__).resolve().parent.parent
TITLES = ["mein buch", "dein buch", "mein heft", "ein buch und ein heft", "kein buch"]
TYPES = ["taschenbuch", "heft", "taschenbuch"]
DOCS = 60


def _ndjson() -> str:
    return "\n".join(json.dumps({"title": TITLES[i % len(TITLES)], "type": TYPES[i % len(TYPES)]})
                     for i in range(DOCS))


@pytest.fixture(scope="module")
def index(on_the_cpu):  # noqa: F811 -- the imported fixture
    pers = vt.Persistence.create_from_str(_ndjson(), "{}")
    return vt.persistence.as_index(pers)


def leaf(term, path="title"):
    return {"search": {"terms": [term], "path": path}}


SINGLE = {"search_req": leaf("buch"), "top": 10}
AND_OF_ORS = {"search_req": {"and": {"queries": [
    {"or": {"queries": [leaf("mein"), leaf("mein", "type")]}},
    {"or": {"queries": [leaf("buch"), leaf("buch", "type")]}},
]}}, "top": 10}
DENSE_AND = {"search_req": {"and": {"queries": [leaf("buch"), leaf("heft", "type")]}}, "top": 10}


def span_paths(prof) -> list:
    """Each host span of ``prof`` as the ``/``-joined names of the spans
    around it and its own, in start order."""
    spans = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU),
                   key=lambda r: (r[0], -r[1]))
    out, stack = [], []
    for start, end, name in spans:
        while stack and stack[-1][0] <= start:
            stack.pop()
        stack.append((end, name))
        out.append("/".join(n for _e, n in stack))
    return out


def traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        result = fn()
    return result, span_paths(prof)


BATCH_PHASES = ["search_batch.plan", "search_batch.prefetch", "search_batch.resolve", "search_batch.answer"]
ANSWER_STEPS = ["answer.upload", "answer.candidates", "answer.num_hits", "answer.topk", "answer.readback",
                "answer.emit"]


@pytest.mark.parametrize("request_json,route_spans", [
    (SINGLE, ["answer.candidates/gather_runs", "answer.topk/segmented_topk"]),
    (AND_OF_ORS, ["answer.candidates/gather_runs", "answer.candidates/_slot_entries",
                  "answer.topk/segmented_topk"]),
], ids=["single_term", "and_of_ors"])
def test_batched_request_spans(index, request_json, route_spans):
    req = vt.Request.from_dict(request_json)
    want = vt.search_batch([req], index)[0]
    got, paths = traced(lambda: vt.search(req, index))
    assert [(h.id, h.score) for h in got.data] == [(h.id, h.score) for h in want.data] and got.num_hits
    assert paths[0] == "search" and all(p.split("/")[0] == "search" for p in paths), paths
    assert "search/search.plan" in paths
    for phase in BATCH_PHASES:
        assert f"search/{phase}" in paths, (phase, paths)
    for step in ANSWER_STEPS:
        assert f"search/search_batch.answer/{step}" in paths, (step, paths)
    for path in route_spans:
        assert f"search/search_batch.answer/{path}" in paths, (path, paths)
    # the ops' spans sit only under the answer's steps
    gathers = {p for p in paths if p.endswith("gather_runs")}
    assert gathers == {"search/search_batch.answer/answer.candidates/gather_runs"}


def test_dense_only_request_spans(index):
    req = vt.Request.from_dict(DENSE_AND)
    got, paths = traced(lambda: vt.search(req, index, dense_only=True))
    assert got.num_hits and got.data
    assert paths[0] == "search" and all(p.split("/")[0] == "search" for p in paths), paths
    assert paths.count("search/execute.leaves") == 3  # the prefetch and each leaf's plane
    for step in ["search.plan", "execute.combine", "execute.extras", "execute.topk", "execute.emit"]:
        assert f"search/{step}" in paths, (step, paths)
    assert "search/execute.topk/topk_dense" in paths
    assert not any("search_batch" in p for p in paths)


def test_parse_and_search_batch_are_roots(index):
    reqs, paths = traced(lambda: [vt.Request.from_dict(SINGLE), vt.Request.from_dict(AND_OF_ORS)])
    assert paths == ["request.parse", "request.parse"]
    _results, paths = traced(lambda: vt.search_batch(reqs, index))
    assert paths[0] == "search_batch" and paths.count("search_batch") == 1
    assert all(p.startswith("search_batch") for p in paths)
    assert "search_batch/search_batch.answer/answer.topk/segmented_topk" in paths
    assert "search_batch/search_batch.plan" in paths and not any(p.startswith("search/") for p in paths)


@pytest.fixture
def quiet_log():
    """The port's logger at warning for the test (restored after)."""
    before = trace.logger.level
    trace.logger.setLevel(logging.WARNING)
    yield
    trace.logger.setLevel(before)


def test_off_span_is_the_shared_no_op(index, quiet_log, monkeypatch):
    assert not torch.autograd._profiler_enabled()

    def no_record(*args, **kwargs):
        raise AssertionError("record_function made with the profiler off")

    monkeypatch.setattr(trace, "record_function", no_record)
    for timer in (trace.info_time, trace.debug_time, trace.trace_time):
        assert timer("search") is trace._OFF
        with timer("search") as entered:
            assert entered is None
    for request_json, dense in ((SINGLE, False), (AND_OF_ORS, False), (DENSE_AND, True)):
        assert vt.search(vt.Request.from_dict(request_json), index, dense_only=dense).num_hits


def test_off_span_costs_less_than_the_alternatives(quiet_log):
    """ns per enter and exit, the least of five runs of 20,000 each."""

    @contextmanager
    def generator_timer(label):
        yield

    def per_call(stmt):
        return min(timeit.repeat(stmt, number=20_000, repeat=5, globals={
            "trace": trace, "generator_timer": generator_timer, "record_function": record_function})) / 20_000 * 1e9

    off = per_call("with trace.debug_time('x'): pass")
    generator = per_call("with generator_timer('x'): pass")
    record = per_call("with record_function('x'): pass")
    print(f"span off {off:.0f} ns, @contextmanager {generator:.0f} ns, record_function {record:.0f} ns a span")
    assert off < generator and off < record


def test_info_log_one_search_line_a_call():
    """Three ``search`` calls, the last under a profiler: three lines."""
    script = "\n".join([
        "import veloci_tpu_torch as vt",
        "from torch.profiler import profile, ProfilerActivity",
        "from veloci_tpu_torch.trace import enable_log",
        "enable_log()",
        "vt.set_default_device('cpu')",
        "pers = vt.Persistence.create_from_str('{\"title\": \"mein buch\"}\\n{\"title\": \"buch\"}', '{}')",
        "req = vt.Request.from_dict({'search_req': {'search': {'terms': ['buch'], 'path': 'title'}}})",
        "vt.search(req, pers); vt.search(req, pers)",
        "with profile(activities=[ProfilerActivity.CPU]):",
        "    vt.search(req, pers)",
    ])
    env = dict(os.environ, VELOCI_LOG="info")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert proc.stderr.count("] search took") == 3, proc.stderr
    assert proc.stderr.count("search_batch") == 0 and proc.stderr.count("request.parse took") == 1


def _run_length(index, term) -> int:
    return vt.search_batch([vt.Request.from_dict({"search_req": leaf(term)})], index)[0].num_hits


def test_counters_move_by_the_work_done(index):
    n = _run_length(index, "buch")
    assert n == sum("buch" in TITLES[i % len(TITLES)].split() for i in range(DOCS))
    rows, keys = dict(index.gathered_rows), dict(index.sorted_keys)
    vt.search(vt.Request.from_dict(SINGLE), index)
    assert index.gathered_rows["single"] - rows.get("single", 0) == n
    assert index.sorted_keys["single"] - keys.get("single", 0) == 2 * n

    # AND of ORs: both words' runs gathered, their rows sorted once
    # (torch.unique), the anchors that hold both ranked by two sorts
    mein, both = _run_length(index, "mein"), vt.search(vt.Request.from_dict(AND_OF_ORS), index).num_hits
    rows, keys = dict(index.gathered_rows), dict(index.sorted_keys)
    vt.search(vt.Request.from_dict(AND_OF_ORS), index)
    assert index.gathered_rows["tree"] - rows.get("tree", 0) == n + mein
    assert index.sorted_keys["tree"] - keys.get("tree", 0) == (n + mein) + 2 * both

    # the dense executor selects over its plane's hits
    keys = dict(index.sorted_keys)
    hits = vt.search(vt.Request.from_dict(DENSE_AND), index, dense_only=True).num_hits
    assert index.sorted_keys["executor"] - keys.get("executor", 0) == hits > 0
