"""The harness: cells found by name, the card check, the kept index's key."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import program, spec

ROOT = Path(__file__).resolve().parents[2]


def make_tree(tmp_path):
    """A copy of ``BENCHMARK.json`` and ``benchmark/`` to add files to."""
    root = tmp_path / "tree"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files, with
    entries in BENCHMARK.json, make a cell with no edit to the harness."""
    root = make_tree(tmp_path)
    bench_dir = root / "benchmark"
    config = json.loads((bench_dir / "configs" / "large-6m.json").read_text())
    config.update(name="large-12m", corpus=dict(config["corpus"], docs=12_000_000))
    (bench_dir / "configs" / "large-12m.json").write_text(json.dumps(config))
    mix = json.loads((bench_dir / "traffic" / "term-lone.json").read_text())
    (bench_dir / "traffic" / "fuzzy-d1-batch.json").write_text(
        json.dumps(dict(mix, loop="batch", batch=64, edits=[[1, 1.0]])))
    (bench_dir / "metrics" / "answered.per_s.py").write_text(
        "def read(record):\n    return record['window'].answered / 2\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "large-12m", "source": "x", "file": "benchmark/configs/large-12m.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "large-12m.fuzzy-d1-batch", "config": "large-12m",
                               "traffic": "fuzzy-d1-batch", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "answered.per_s", "unit": "requests/s", "better": "higher",
                               "source": "host_clock", "layer": "device", "moves": "qps",
                               "workloads": ["large-12m.fuzzy-d1-batch"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("large-12m.fuzzy-d1-batch", bench_dir)
    assert cell.config["corpus"]["docs"] == 12_000_000 and cell.traffic["edits"] == [[1, 1.0]]
    assert cell.traffic["loop"] == "batch"
    assert "answered.per_s" in [m["name"] for m in cell.per_layer]

    class W:
        answered = 10

    assert spec.metric_reader("answered.per_s", bench_dir)({"window": W}) == 5
    assert spec.corpus_module(cell.config, bench_dir).__name__.endswith("repeat")
    # listed for its own cell only
    assert "answered.per_s" not in [m["name"] for m in spec.load_cell("large-6m.term-lone", bench_dir).per_layer]


def test_every_listed_metric_has_a_reader():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert spec.corpus_module(cell.config)


def run_py(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")  # no card, wherever the test runs
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_no_card_no_result():
    """Without a CUDA card the run prints no result, names what it missed,
    and exits non-zero."""
    out = run_py(ROOT, "--workload", "large-6m.and-lone", "--seed", "3000000001", "--seconds", "1",
                 "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_alone_gives_no_result(tmp_path):
    """A tree with only BENCHMARK.json and benchmark/ cannot run the port."""
    root = make_tree(tmp_path)
    out = run_py(root, "--workload", "large-6m.term-lone", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_kept_index_key(tmp_path):
    """The key follows the configuration, the corpus generator and every
    index-writing source of the port: a changed source misses the cache."""
    root = tmp_path / "root"
    for src in program.INDEX_SOURCES:
        (root / src).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / src, root / src)
    config = json.loads((ROOT / "benchmark" / "configs" / "large-6m.json").read_text())
    corpus = ROOT / "benchmark" / "corpus" / "repeat.py"
    key = program.cache_key(config, corpus, root)
    assert program.cache_key(json.loads(json.dumps(config)), corpus, root) == key
    for src in program.INDEX_SOURCES:
        before = (root / src).read_bytes()
        (root / src).write_bytes(before + b"\n")
        assert program.cache_key(config, corpus, root) != key, src
        (root / src).write_bytes(before)
    smaller = dict(config, corpus=dict(config["corpus"], docs=3000))
    assert program.cache_key(smaller, corpus, root) != key
    other = tmp_path / "repeat.py"
    other.write_text(corpus.read_text() + "\n")
    assert program.cache_key(config, other, root) != key


def test_kept_index_is_built_once(tmp_path, on_cpu):
    cell = spec.load_cell("large-6m.term-lone")
    config = dict(cell.config, corpus=dict(cell.config["corpus"], docs=500))
    corpus = spec.corpus_module(config)
    first = program.set_up(config, corpus, 1, "cpu", cache_dir=tmp_path)
    second = program.set_up(config, corpus, 2, "cpu", cache_dir=tmp_path)
    assert first.cache_hit is False and "index_build" in first.seconds
    assert second.cache_hit is True and "index_build" not in second.seconds
    assert second.index.num_docs == 500
    assert [p.name for p in tmp_path.iterdir()] == [first.index_dir.name]
    first.close()
    second.close()


def test_idle_time_goes_to_the_innermost_span_and_op():
    """Each piece of a gap goes to what runs across it: spans a (0-10 s)
    holding b (2-5 s), an op x (3-4 s) inside b and an op y (11-13 s)
    outside any span; the device idles 1-6 s and 8-14 s."""
    import numpy as np

    from benchmark.harness import trace

    s = 1e9
    spans = [(0, 10 * s, "a"), (2 * s, 5 * s, "b")]
    ops = [(3 * s, 4 * s, "x"), (11 * s, 13 * s, "y")]
    idle = trace._idle_by_label(np.array([[1 * s, 6 * s], [8 * s, 14 * s]]), spans, ops)
    assert idle == {"a": 4.0, "b": 2.0, "b > x": 1.0, "y": 2.0, "python": 2.0}


def test_device_busy_is_a_union():
    import numpy as np

    from benchmark.harness import trace

    merged = trace._union(np.array([[0, 4], [1, 2], [3, 6], [8, 9]], dtype=np.float64))
    assert merged.tolist() == [[0, 6], [8, 9]]
