"""Nothing under ``benchmark/`` loads JAX or the JAX package, and the
reference loads nothing of the program. Each check imports in a child
process, so that this test process's own imports do not count."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"

CHILD = r"""
import importlib, importlib.util, json, sys
from pathlib import Path
root, targets = Path(sys.argv[1]), json.loads(sys.argv[2])
sys.path.insert(0, str(root))
for t in targets:
    if t.endswith(".py"):  # a file loaded by path, as the harness loads metrics and corpora
        spec = importlib.util.spec_from_file_location("bench_file_" + Path(t).stem.replace(".", "_"), root / t)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(t)
print(json.dumps(sorted(sys.modules)))
"""


def loaded_by(targets):
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT), json.dumps(targets)],
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def top_level(names, wanted):
    return sorted({n for n in names if n.split(".", 1)[0] in wanted})


def benchmark_modules():
    """Every module of the benchmark but its tests: packages by name, the
    files found by name (metrics, corpora) by path."""
    out = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(ROOT)
        if "tests" in rel.parts:
            continue
        if rel.parts[1] in ("metrics", "corpus"):
            out.append(str(rel))
        else:
            out.append(".".join(rel.with_suffix("").parts).removesuffix(".__init__"))
    return out


def test_benchmark_loads_no_jax():
    modules = benchmark_modules()
    assert "benchmark.run" in modules and "benchmark.reference.search" in modules
    assert any(m.endswith("postings_roofline_pct.py") for m in modules)
    assert top_level(loaded_by(modules), {"jax", "jaxlib", "flax", "veloci_tpu"}) == []


def test_reference_loads_nothing_of_the_program():
    refs = [m for m in benchmark_modules() if m.startswith("benchmark.reference")]
    loaded = loaded_by(refs)
    assert top_level(loaded, {"veloci_tpu_torch", "veloci_tpu", "jax", "torch"}) == []


def test_whole_name_comparison():
    """``veloci_tpu_torch`` is not ``veloci_tpu``: names compare whole."""
    from benchmark.harness.runner import forbidden_modules

    assert forbidden_modules(["veloci_tpu_torch", "veloci_tpu_torch.search", "jaxtyping"]) == []
    assert forbidden_modules(["veloci_tpu.search", "jax", "numpy"]) == ["jax", "veloci_tpu.search"]
