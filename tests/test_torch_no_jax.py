"""The port runs where JAX is absent: it never imports ``jax`` nor runs
``veloci_tpu/__init__.py``, reaches the reference's host layers (the query
generator included) only through ``veloci_tpu_torch._host``, and refuses a
CUDA device it does not have. The
standalone ``chip_smoke.py`` refuses to run without a card or without the
repository around it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import torch

REPO = Path(__file__).resolve().parent.parent

# Built, saved, read back and searched in a fresh interpreter. With
# "block", importing jax raises ImportError for the whole run.
SCRIPT = r"""
import sys
if sys.argv[1] == "block":
    sys.modules["jax"] = None
import tempfile
import numpy as np
import torch
from veloci_tpu_torch import Request, SearchQueryGeneratorParameters, _host, load_index, search_batch
from veloci_tpu_torch import search_query

rng = np.random.default_rng(3)
vocab = ["hello", "help", "hells", "world", "word", "Hello", "x" * 40]
docs = "\n".join('{"title": "%s"}' % " ".join(rng.choice(vocab, 4)) for _ in range(400))
pers = _host.persistence.Persistence.from_built(_host.create.create_indices_from_str(docs, "{}"))
with tempfile.TemporaryDirectory() as d:
    pers.save(d)
    index = load_index(d, "cpu")
    if not torch.cuda.is_available():
        try:
            load_index(d, "cuda")
        except RuntimeError:
            pass
        else:
            raise AssertionError("a CUDA index was built without CUDA")
res = search_batch([Request.from_dict({"search_req": {"search": dict(terms=[t], path="title", **kw)}})
                    for t, kw in [("hello", {}), ("helo", {"levenshtein_distance": 1}),
                                  ("wrd", {"levenshtein_distance": 2})]], index)
assert all(r.num_hits > 0 and r.data for r in res), res
reqs = [search_query(index, SearchQueryGeneratorParameters(search_term=q))
        for q in ("hel*", "hello AND wor*", "word OR hello AND help")]
res = search_batch(reqs, index)
assert all(r.num_hits > 0 and r.data for r in res), res
loaded = [m for m, mod in sys.modules.items() if mod is not None and (m == "jax" or m.startswith("jax."))]
assert not loaded, loaded
assert sys.argv[1] != "block" or sys.modules["jax"] is None
assert "jax" not in sys.modules or sys.argv[1] == "block"
assert "veloci_tpu" not in sys.modules and not any(m.startswith("veloci_tpu.") for m in sys.modules)
print("PORT-OK")
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
    )


@pytest.mark.parametrize("mode", ["block", "absent"])
def test_port_runs_without_jax(mode):
    proc = _run(["-c", SCRIPT, mode], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "PORT-OK" in proc.stdout


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path",
    sorted(p.relative_to(REPO).as_posix() for p in (REPO / "veloci_tpu_torch").rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_jax_or_reference_import(path):
    bad = [
        m for m in _imports(REPO / path)
        if m.split(".")[0] in ("jax", "jaxlib", "veloci_tpu")
    ]
    assert not bad, bad


def test_cuda_index_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from veloci_tpu_torch import TorchIndex

    import numpy as np

    with pytest.raises(RuntimeError, match="cuda"):
        TorchIndex.from_reference_arrays(
            num_docs=0, dictionaries={}, fields={}, offsets=np.zeros(2, np.int64),
            anchors=np.zeros(0, np.int32), scores=np.zeros(0, np.uint16), key_base={},
            device="cuda",
        )


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env_free = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert env_free.returncode != 0 and '"ok"' not in env_free.stdout
