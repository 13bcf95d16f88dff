"""CPU tests of the benchmark's harness and reference. Run from the root of
the repository: ``python -m pytest benchmark/tests -q``."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def on_cpu():
    """The port's default device is the CPU for the test (restored after)."""
    import veloci_tpu_torch as vt

    before = vt.default_device()
    vt.set_default_device("cpu")
    yield
    vt.set_default_device(before)


def small_cell(name: str, docs: int, batch: int = 16, check_share: float = 0.25, traffic: dict = None):
    """The benchmark's cell ``name`` cut to ``docs`` documents, with its mix
    or ``traffic`` in its place, and, in a batch loop, batches of ``batch``."""
    from benchmark.harness import spec

    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["corpus"]["docs"] = docs
    cell.traffic = dict(traffic or cell.traffic, warmup_units=1)
    if cell.traffic["loop"] == "batch":
        cell.traffic.update(batch=batch, check_share=check_share)
    return cell
