"""One run of one cell: set-up, warm-up, the window, the comparison and
the metrics, as the result line's dict."""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

from . import check, program, spec, traffic, window
from .peaks import peak_bytes_per_s

FORBIDDEN = ("jax", "jaxlib", "flax", "veloci_tpu")  # top-level module names the run may not load


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def device_info(device: str, chips: int) -> dict:
    if device.startswith("cuda"):
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(chips)))}
    return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str, t0: float,
             log=lambda msg: print(msg, file=sys.stderr, flush=True), cache_dir=program.CACHE_DIR) -> dict:
    """Run ``cell`` once and return its result line (a dict). ``t0`` is the
    process's start on ``time.perf_counter``'s clock."""
    from ..reference.index import ReferenceIndex
    from ..reference.search import Reference

    corpus = spec.corpus_module(cell.config)
    readers = {m["name"]: spec.metric_reader(m["name"]) for m in (cell.per_layer if trace else cell.end_to_end)}
    harness_s = 0.0
    setup = program.set_up(cell.config, corpus, seed, device, cache_dir=cache_dir)
    log(f"set-up {json.dumps({k: round(v, 4) for k, v in setup.seconds.items()})}"
        + ("" if setup.cache_hit is None else f", kept index {'read' if setup.cache_hit else 'built'}"))

    t = time.perf_counter()
    words = corpus.words(cell.config["corpus"], seed)
    stream = traffic.Stream(cell.traffic, words, seed, traffic.WINDOW)
    warm = traffic.Stream(cell.traffic, words, seed, traffic.WARMUP)
    mask = traffic.check_mask(seed, float(cell.traffic.get("check_share", 1.0)))
    answer = window.answerer(setup.vt, setup.index, cell.traffic["loop"])
    harness_s += time.perf_counter() - t

    t = time.perf_counter()
    for _ in range(int(cell.traffic.get("warmup_units", 1))):
        answer(warm.next_unit())
    _sync(device)
    setup.seconds["shape_warmup"] = time.perf_counter() - t
    if device.startswith("cuda"):
        import torch

        torch.cuda.reset_peak_memory_stats()

    prof = None
    if trace:
        t = time.perf_counter()
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace as tracing

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.startswith("cuda") else [])
        prof = profile(activities=activities)
        prof.__enter__()
        span = record_function(tracing.WINDOW_SPAN)
        span.__enter__()
        harness_s += time.perf_counter() - t
    setup_s = time.perf_counter() - t0 - harness_s
    with window.GcClock() as clock:
        w = window.run(answer, stream, seconds, mask, clock)
    _sync(device)
    traced = None
    if trace:
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    dev = device_info(device, cell.chips)
    log(f"window {w.seconds:.3f} s: {w.answered} answered, {w.failed} failed, {len(w.checked)} to check; "
        f"gc {w.gc_count} full collections, {w.gc_ms:.1f} ms")
    for err in w.errors:
        log(f"error: {err}")
    setup.close()
    del answer
    gc.collect()
    if device.startswith("cuda"):
        import torch

        torch.cuda.empty_cache()
    if trace:
        t = time.perf_counter()
        traced = tracing.reduce(prof, w.gc_intervals)
        prof = None
        log(f"trace reduced in {time.perf_counter() - t:.1f} s: window {traced['window_s']:.3f} s, "
            f"busy {traced['busy_s']:.4f} s, {traced['device_events']} device events")

    t = time.perf_counter()
    ref_index = ReferenceIndex(corpus.ndjson(cell.config["corpus"], seed), cell.config.get("index_config") or {},
                               fields=set(cell.traffic["fields"]))
    reference = Reference(ref_index)
    checks = check.compare(w.checked, reference, w.failed, cell.config["limits"]["score_rel_gap"])
    rows = [8 * reference.posting_rows(r) + 4 * len(ids) for r, ids, _s, _n in w.checked]
    log(f"reference: {len(w.checked)} requests compared in {time.perf_counter() - t:.1f} s")

    record = {
        "window": w,
        "setup_s": setup_s,
        "setup": dict(setup.seconds),
        "trace": traced,
        "device": dev,
        "postings_bytes": float(np.mean(rows)) * w.answered if rows else None,
        "peak_bytes_per_s": peak_bytes_per_s(dev["kind"]),
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = readers[m["name"]](record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
    correct = check.holds(checks)
    for line in check.lines(checks):
        log(line)
    out = {"correct": correct, "attempted": w.attempted, "failed": w.failed, "metrics": metrics, "device": dev}
    if traced is not None:
        out["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    out["checks"] = checks
    return out
