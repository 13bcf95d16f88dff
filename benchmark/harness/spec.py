"""Finds what a cell needs by the names in ``BENCHMARK.json``.

A configuration is ``configs/<config>.json``, its corpus generator
``corpus/<generator>.py``, a traffic mix ``traffic/<traffic>.json`` and a
metric ``metrics/<metric>.py``, all under ``benchmark/``: a new cell, mix
or metric is a new file, with no edit to the harness.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    traffic_name: str
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem.replace('.', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR, root: Path = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration, its
    traffic mix and the metrics it reports."""
    root = bench_dir.parent if root is None else root
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def corpus_module(config: dict, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "corpus" / f"{config['corpus']['generator']}.py")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    return load_module(bench_dir / "metrics" / f"{name}.py").read
