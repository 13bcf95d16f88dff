"""The port stands alone: it never imports ``jax`` nor anything of the JAX
package ``veloci_tpu/``, runs from a tree that holds only the port, the
native indexer's source and ``chip_smoke.py`` (its search, a regex request,
a document read, warmup, a boost_term / text_locality / why_found request,
suggest, an explained request, ``explain_plan``, its server, stats and
CLI, imported and answering over HTTP, and ``parallel/``: an attached
8-shard CPU mesh answering as the unsharded index does, and the host
fan-out over separate indices, included), and refuses a CUDA device
it does not have. ``chip_smoke.py`` refuses to run without a card, in the
repository, in that tree and alone."""

import ast
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import torch
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in (REPO / "veloci_tpu_torch").rglob("*.py"))

# Built, saved, read back and searched in a fresh interpreter. With
# "block", importing jax raises ImportError for the whole run.
SCRIPT = r"""
import sys
if sys.argv[1] == "block":
    sys.modules["jax"] = None
    sys.modules["veloci_tpu"] = None
import tempfile
from pathlib import Path
import numpy as np
import torch
from veloci_tpu_torch import (
    Persistence, Request, SearchQueryGeneratorParameters, create_indices_from_str, load_index,
    search, search_batch, search_query, search_to_result_with_doc, suggest, suggest_batch, suggest_query,
)

rng = np.random.default_rng(3)
vocab = ["hello", "help", "hells", "world", "word", "Hello", "x" * 40]
docs = "\n".join('{"title": "%s"}' % " ".join(rng.choice(vocab, 4)) for _ in range(400))
pers = Persistence.from_built(create_indices_from_str(docs, "{}"))
with tempfile.TemporaryDirectory() as d:
    pers.save(d)
    index = load_index(d, "cpu")
    if not torch.cuda.is_available():
        try:
            load_index(d)
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
leaf = lambda t, **kw: {"search": dict(terms=[t] if isinstance(t, str) else t, path="title", **kw)}
deep = {"and": {"queries": [{"or": {"queries": [{"and": {"queries": [leaf("hello"), leaf("wrd", levenshtein_distance=1)]}},
                                                leaf("hel", starts_with=True)]}}, leaf("help")]}}
for d in ({"search_req": deep}, {"search_req": leaf(["world", "x"])}, {"search_req": leaf("hello")}):
    res = search(Request.from_dict(d), index)
    assert res.num_hits > 0 and res.data, res
    assert search(Request.from_dict(d), index, dense_only=True).data == res.data
assert index.path_counts["executor"] == 5, index.path_counts
regex = search_query(index, SearchQueryGeneratorParameters(search_term="*ell*"))
res = search(regex, index)
assert res.num_hits > 0 and res.data, res
assert index.path_counts["regex_dfa"] > 0 and not index.path_counts["regex_host_scan"], index.path_counts
whole = search_to_result_with_doc(index, res)
picked = search_to_result_with_doc(index, res, ["title"])  # "{}" keeps no select stores: {}
assert [d.hit for d in whole.data] == [d.hit for d in picked.data] == res.data, (whole, picked)
assert all("ell" in d.doc["title"].lower() for d in whole.data), whole
assert index.warmup() > 0 and index.last_warmup_breakdown, index.last_warmup_breakdown
feat = {"search_req": {"or": {"queries": [leaf("hello"), leaf("world")]}}, "text_locality": True,
        "boost_term": [{"terms": ["help"], "path": "title", "levenshtein_distance": 1}], "why_found": True}
res = search(Request.from_dict(feat), index)
assert res.num_hits > 0 and res.data and res.why_found_terms, res
assert search_batch([Request.from_dict(feat)], index)[0].data == res.data
sugg = suggest_batch(index, [suggest_query("hel", index), suggest_query("wor", index, levenshtein=1)])
assert all(sugg) and suggest(index, suggest_query("hel", index)) == sugg[0], sugg
explained = search(Request.from_dict({"search_req": {"or": {"queries": [leaf("hello"), leaf("wrd", levenshtein_distance=1)]}},
                                      "explain": True}), index)
assert explained.data and set(explained.explain) == {h.id for h in explained.data}, explained
from veloci_tpu_torch import explain_plan
assert "digraph" in explain_plan(Request.from_dict({"search_req": leaf("hello")}), index)
import json, threading, urllib.request
import veloci_tpu_torch.cli, veloci_tpu_torch.search.explain
from veloci_tpu_torch import server
from veloci_tpu_torch.search import stats
with tempfile.TemporaryDirectory() as d:
    pers.save(str(Path(d) / "db"))
    server.BASE_DIR = d
    srv = server.make_server("127.0.0.1", 0, device="cpu")
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/db/search?query=hello&explain=true"
    with urllib.request.urlopen(url, timeout=120) as resp:
        body = json.loads(resp.read())
    srv.shutdown()
assert body["data"] and all(d["explain"] for d in body["data"]), body
assert stats.snapshot()["fallback_reasons"].get("explain"), stats.snapshot()
from veloci_tpu_torch.parallel.mesh_executor import build_doc_mesh
from veloci_tpu_torch.parallel.shards import build_sharded
mesh_reqs = [Request.from_dict({"search_req": deep}), Request.from_dict(feat), regex,
             Request.from_dict({"search_req": leaf("helo", levenshtein_distance=1)})]
detached = [search(r, index) for r in mesh_reqs] + search_batch(mesh_reqs, index)
index.attach_mesh(build_doc_mesh(8, ["cpu"] * 8))
on_mesh = [search(r, index) for r in mesh_reqs] + search_batch(mesh_reqs, index)
index.detach_mesh()
assert [(r.num_hits, r.data) for r in on_mesh] == [(r.num_hits, r.data) for r in detached], (on_mesh, detached)
assert index.path_counts["mesh_batch"] and index.path_counts["mesh_executor"], index.path_counts
fanned = build_sharded(docs.split("\n"), "{}", shard_size=150, device="cpu")
assert len(fanned.shards) == 3 and fanned.search(Request.from_dict({"search_req": leaf("hello")})).data
loaded = [m for m, mod in sys.modules.items() if mod is not None and (m == "jax" or m.startswith("jax."))]
assert not loaded, loaded
assert sys.argv[1] != "block" or sys.modules["jax"] is None and sys.modules["veloci_tpu"] is None
assert "jax" not in sys.modules or sys.argv[1] == "block"
assert sys.modules.get("veloci_tpu") is None and not any(m.startswith("veloci_tpu.") for m in sys.modules)
ref_dir = Path(sys.argv[2]).resolve() / "veloci_tpu"
inside = [m for m, mod in list(sys.modules.items())
          if getattr(mod, "__file__", None) and Path(mod.__file__).resolve().is_relative_to(ref_dir)]
assert not inside, inside
print("PORT-OK")
"""


@pytest.fixture(scope="module")
def port_only(tmp_path_factory):
    """A tree with the port, the native indexer's source and chip_smoke.py,
    and nothing else of the repository."""
    root = tmp_path_factory.mktemp("port_only")
    skip = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so")
    shutil.copytree(REPO / "veloci_tpu_torch", root / "veloci_tpu_torch", ignore=skip)
    shutil.copytree(REPO / "native", root / "native", ignore=skip)
    shutil.copy(REPO / "chip_smoke.py", root / "chip_smoke.py")
    assert not (root / "veloci_tpu").exists()
    return root


def _run(args, root, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(root))
    return subprocess.run(
        [sys.executable, *args], cwd=root, env=env, capture_output=True, text=True, timeout=timeout
    )


@pytest.mark.parametrize("mode", ["block", "absent"])
def test_port_runs_without_jax(mode):
    proc = _run(["-c", SCRIPT, mode, str(REPO)], REPO)
    assert proc.returncode == 0, proc.stderr
    assert "PORT-OK" in proc.stdout


@pytest.mark.parametrize("mode", ["block", "absent"])
def test_port_runs_without_reference_package(port_only, mode):
    proc = _run(["-c", SCRIPT, mode, str(port_only)], port_only)
    assert proc.returncode == 0, proc.stderr
    assert "PORT-OK" in proc.stdout
    assert list((port_only / "build" / "native").glob("libveloci_native-*.so"))


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


# a citation of a reference kernel as file:line, as chip_smoke.py's kernel
# table gives it, names no path that is opened
_CITATION = re.compile(r"veloci_tpu/[\w/]+\.py:\d+")


def _reaches_reference(tree):
    """Loading by file location, or a string that names the reference
    package's directory as a path."""
    docs = {id(c) for c in _docstrings(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr == "spec_from_file_location":
            yield "spec_from_file_location"
        elif isinstance(node, ast.alias) and node.name == "spec_from_file_location":
            yield "spec_from_file_location"
        elif (
            isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs
            and re.search(r"(^|[/\\])veloci_tpu([/\\]|$)", node.value)
            and not _CITATION.fullmatch(node.value)
        ):
            yield node.value


def test_scan_covers_the_mesh():
    """The import scan reads the mesh's modules too."""
    assert {f"veloci_tpu_torch/parallel/{m}.py" for m in ("sharding", "mesh_executor", "shards")} <= set(PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES + ["chip_smoke.py"])
def test_no_jax_or_reference_import(path):
    tree = ast.parse((REPO / path).read_text(), path)
    bad = [
        m for m in _imports(tree)
        if m.split(".")[0] in ("jax", "jaxlib", "veloci_tpu")
    ]
    assert not bad, bad
    assert not list(_reaches_reference(tree))


def test_reference_scan_catches_loaders():
    """The scan above rejects the ways around an import statement."""
    for src in (
        'import importlib.util\nimportlib.util.spec_from_file_location("m", "x.py")',
        'from importlib.util import spec_from_file_location',
        'from pathlib import Path\nREF = Path(__file__).parent.parent / "veloci_tpu"',
        'open("../veloci_tpu/create.py")',
    ):
        assert list(_reaches_reference(ast.parse(src))), src
    ok = '"""Counterpart of veloci_tpu/create.py."""\nREPLACES = "veloci_tpu/ops/pallas_levenshtein.py:72"'
    assert not list(_reaches_reference(ast.parse(ok)))


def test_cuda_index_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from veloci_tpu_torch import TorchIndex

    import numpy as np

    with pytest.raises(RuntimeError, match="cuda"):
        TorchIndex.from_reference_arrays(
            num_docs=0, all_fields=[], term_bytes={}, fields={}, offsets=np.zeros(2, np.int64),
            anchors=np.zeros(0, np.int32), scores=np.zeros(0, np.uint16), key_base={},
        )


def test_chip_smoke_refuses_without_card_or_repo(port_only, tmp_path):
    """Without a card it refuses in the repository and in the port-only
    tree; with nothing of the repository beside it, it refuses too."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    for root in (REPO, port_only):
        proc = _run(["chip_smoke.py"], root, timeout=90)
        assert proc.returncode != 0 and '"ok"' not in proc.stdout, root
        assert "torch.cuda.is_available() is False" in proc.stderr, proc.stderr
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env_free = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=90, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert env_free.returncode != 0 and '"ok"' not in env_free.stdout
