"""Whole runs on the CPU (the card check skipped) at a small size: a sound
run is correct; with the control in the program's place, or with the
timed path broken underneath, ``correct`` comes out false."""

import time

import pytest

from benchmark.harness import runner, spec, window
from benchmark.readings import control_answerer
from benchmark.reference.index import ReferenceIndex
from benchmark.reference.search import Reference

from .conftest import small_cell


def run(cell, tmp_path, seconds=0.6, seed=3000000017, trace=False):
    return runner.run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(), log=lambda m: None,
                           cache_dir=tmp_path)


CELLS = [("large-6m.and-lone", 3000), ("large-6m.term-lone", 3000)]
# a batch loop over the same corpus, for the faults only a batch can have
BATCH = {"loop": "batch", "batch": 16, "top": 10, "tree": "leaf", "fields": ["title", "type"], "draw": "pairs",
         "edits": [[0, 1.0]], "check_share": 1.0}


@pytest.mark.parametrize("name,docs", CELLS)
def test_sound_run_is_correct(tmp_path, on_cpu, name, docs):
    cell = small_cell(name, docs)
    out = run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert out["checks"]["checked"]["value"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "qps" in out["metrics"] and "setup_s" in out["metrics"]
    assert runner.forbidden_modules() == []


@pytest.mark.parametrize("name,docs", CELLS)
def test_traced_run_is_correct(tmp_path, on_cpu, name, docs):
    """The traced run reads the per-layer metrics (on the CPU those of the
    device find nothing and are left out) and labels the host's time."""
    cell = small_cell(name, docs)
    out = run(cell, tmp_path, trace=True)
    assert out["correct"], out["checks"]
    assert {"gc_ms_per_s", "upload_s", "warmup_s"} <= set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert out["device"]["window_s"] > 0 and out["breakdown"]["idle_gaps"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("name,docs", CELLS)
def test_control_is_not_correct(tmp_path, on_cpu, monkeypatch, name, docs):
    """The reference in bfloat16, the precision below the configuration's
    float32, answering in the program's place."""
    cell = small_cell(name, docs)
    corpus = spec.corpus_module(cell.config)
    control = Reference(ReferenceIndex(corpus.ndjson(cell.config["corpus"], 3000000017),
                                       cell.config["index_config"]), "bfloat16")
    monkeypatch.setattr(window, "answerer", lambda vt, index, loop: control_answerer(control))
    out = run(cell, tmp_path)
    assert not out["correct"] and out["checks"]["score_gap"]["value"] > out["checks"]["score_gap"]["max"]


def test_half_the_batch_left_out(tmp_path, on_cpu, monkeypatch):
    import veloci_tpu_torch as vt
    from veloci_tpu_torch.search.result import SearchResult

    real = vt.search_batch

    def half(requests, index):
        n = len(requests) // 2
        return real(requests[:n], index) + [SearchResult() for _ in requests[n:]]

    sound = run(small_cell("large-6m.term-lone", 3000, traffic=BATCH), tmp_path)
    assert sound["correct"], sound["checks"]
    monkeypatch.setattr(vt, "search_batch", half)
    out = run(small_cell("large-6m.term-lone", 3000, traffic=BATCH), tmp_path)
    assert not out["correct"] and out["checks"]["hits_wrong"]["value"] > 0


@pytest.mark.parametrize("name,docs", CELLS)
@pytest.mark.parametrize("fault", ["score", "top_hit"])
def test_answer_altered_where_made(tmp_path, on_cpu, monkeypatch, name, docs, fault):
    """Each answer altered as the batch route emits it: a score off by one
    part in 10,000, or the top hit dropped."""
    from veloci_tpu_torch.search import batch
    from veloci_tpu_torch.search.result import Hit

    real = batch._emit

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        if fault == "score":
            res.data = [Hit(h.id, h.score * (1 + 1e-4)) for h in res.data]
        else:
            res.data = res.data[1:]
        return res

    monkeypatch.setattr(batch, "_emit", altered)
    out = run(small_cell(name, docs), tmp_path)
    assert not out["correct"]
    wrong = "score_gap" if fault == "score" else "ids_wrong"
    c = out["checks"][wrong]
    assert c["value"] > c["max"]
