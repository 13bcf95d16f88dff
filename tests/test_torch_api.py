"""The JAX package's own public API on the port.

* Names: every name ``veloci_tpu/__init__.py`` and
  ``veloci_tpu/search/__init__.py`` export, the port's packages export.
* The reference's call, ``search(request, Persistence.create_from_str(...))``,
  answers as the reference answers it.
* One default device: it starts as the card, a CUDA default with no card
  raises (nothing falls back to the CPU), and ``tests/torch_rebind.py``'s
  fixture sets the CPU for a rebound module and restores the old default.
* A ``Persistence`` uploads once, shared by threads and by every entry
  point, and ``add_token_values_to_tokens`` drops the upload.
* ``get_facet`` takes a host bool mask as well as a plane, and
  ``get_term_ids_in_field`` has the reference's signature, each equal to
  the reference's.
* The trace timers: with ``VELOCI_LOG=info`` one ``search took`` line a
  ``search``, none without it.
* The CLI's test subcommands: ``create_test_index`` on generated
  paragraphs and on 2,000 jmdict-like documents (the package's corpus
  equal to ``bench.build_corpus``), and ``test_large_search --device cpu``.

Tolerance: exact. Inputs are made from a seed with numpy."""

import ast
import importlib
import inspect
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import torch
import veloci_tpu as ref
import veloci_tpu_torch as vt
from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu_torch import cli
from veloci_tpu_torch.persistence import TorchIndex, default_device, set_default_device
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture
from torch_rebind import on_the_cpu  # noqa: F401 -- the CPU is the default device here

REPO = Path(__file__).resolve().parent.parent
ref_facet = importlib.import_module("veloci_tpu.search.facet")
ref_field_search = importlib.import_module("veloci_tpu.search.field_search")
port_facet = importlib.import_module("veloci_tpu_torch.search.facet")
port_field_search = importlib.import_module("veloci_tpu_torch.search.field_search")


def _exported(init: Path):
    """The names a package's ``__init__.py`` imports or assigns."""
    tree = ast.parse(init.read_text())
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            yield from (a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            yield from (t.id for t in node.targets if isinstance(t, ast.Name))


@pytest.mark.parametrize("package", ["veloci_tpu", "veloci_tpu.search"])
def test_public_names_cover_the_reference(package):
    names = list(_exported(REPO / package.replace(".", "/") / "__init__.py"))
    assert len(names) >= 7
    port = importlib.import_module(package.replace("veloci_tpu", "veloci_tpu_torch", 1))
    assert [n for n in names if not hasattr(port, n)] == []
    assert vt.search is port.search and callable(vt.search)  # the function, at the top and in the subpackage
    assert vt.__version__ == ref.__version__


@pytest.fixture(scope="module")
def pers_pair():
    """The test corpus with its token values, in both packages."""
    ref_pers = ref.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    ref.add_token_values_to_tokens(ref_pers, *TOKEN_VALUES)
    pers = vt.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    vt.add_token_values_to_tokens(pers, *TOKEN_VALUES)
    return ref_pers, pers


REQUESTS = [
    {"search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}}},
    {"search_req": {"search": {"terms": ["will"], "path": "meanings.eng[]", "levenshtein_distance": 1}},
     "facets": [{"field": "tags[]"}, {"field": "commonness"}]},
    {"search_req": {"or": {"queries": [{"search": {"terms": ["majes"], "path": "meanings.ger[]",
                                                   "starts_with": True}},
                                       {"search": {"terms": ["begeisterung"], "path": "meanings.ger[]",
                                                   "token_value": {"path": "meanings.ger[]",
                                                                   "boost_fun": "Log10", "param": 1}}}]}},
     "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}], "top": 5},
]


def _key(res):
    return res.num_hits, [(h.id, np.float32(h.score).tobytes()) for h in res.data], res.facets


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_reference_call_answers_as_the_reference(pers_pair, i):
    ref_pers, pers = pers_pair
    got = vt.search(vt.Request.from_dict(REQUESTS[i]), pers)
    assert got.data and _key(got) == _key(ref.search(ref.Request.from_dict(REQUESTS[i]), ref_pers))
    assert pers.index().device == torch.device("cpu")


def test_default_device_starts_on_the_card():
    """A fresh interpreter's default device is the card, and the port's
    only look at ``torch.cuda.is_available()`` is the check that refuses a
    card that is not there."""
    out = subprocess.run([sys.executable, "-c", "import veloci_tpu_torch as vt; print(vt.default_device())"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "cuda", out.stderr
    from veloci_tpu_torch import persistence

    probes = [p.name for p in (REPO / "veloci_tpu_torch").rglob("*.py") if "is_available()" in p.read_text()]
    assert probes == ["persistence.py"]
    source = Path(persistence.__file__).read_text()
    assert inspect.getsource(persistence._device).count("is_available()") == source.count("is_available()")


def test_cuda_default_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from veloci_tpu_torch import server

    pers = vt.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    pers.save(str(tmp_path / "db"))
    req = vt.Request.from_dict(REQUESTS[0])
    old = default_device()
    set_default_device("cuda")
    try:
        for call in (lambda: vt.load_index(str(tmp_path / "db")), pers.index, lambda: vt.search(req, pers),
                     lambda: vt.search_batch([req], pers),
                     lambda: server.ensure_database(str(tmp_path / "db"), trusted_path=True)):
            with pytest.raises(RuntimeError, match="cuda"):
                call()
        assert pers._index is None and not server.PERSISTENCES
    finally:
        set_default_device(old)


REBOUND_CHECK = '''
from veloci_tpu_torch.persistence import default_device


def test_default_is_the_cpu():
    assert str(default_device()) == "cpu"
'''


def test_rebind_fixture_sets_and_restores_the_default(tmp_path):
    """A rebound module's tests see the CPU; the next module sees the
    default as it was (a child pytest over a reference-like file, its
    rebound twin and a module after it)."""
    for name in ("torch_rebind.py", "test_torch_limits.py"):
        (tmp_path / name).write_text((REPO / "tests" / name).read_text())
    (tmp_path / "test_fake.py").write_text(REBOUND_CHECK)
    (tmp_path / "test_torch_ref_fake.py").write_text(
        'from torch_rebind import rebind; rebind("test_fake", globals())  # noqa: E702\n')
    (tmp_path / "test_zz_after.py").write_text(
        "from veloci_tpu_torch.persistence import default_device\n\n\n"
        "def test_default_is_the_card_again():\n    assert str(default_device()) == 'cuda'\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly", "-p", "no:xdist",
         "test_torch_ref_fake.py", "test_zz_after.py"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0 and "2 passed" in proc.stdout, proc.stdout + proc.stderr


def _counting_uploads(monkeypatch):
    uploads = []
    real = TorchIndex.from_persistence.__func__

    def counted(cls, pers, device=None):
        uploads.append(device)
        return real(cls, pers, device)

    monkeypatch.setattr(TorchIndex, "from_persistence", classmethod(counted))
    return uploads


def test_persistence_uploads_once(monkeypatch):
    uploads = _counting_uploads(monkeypatch)
    pers = vt.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    reqs = [vt.Request.from_dict(d) for d in REQUESTS]
    barrier = threading.Barrier(8)
    answers = [None] * 8

    def one(k):
        barrier.wait()
        answers[k] = _key(vt.search(reqs[k % len(reqs)], pers))

    threads = [threading.Thread(target=one, args=(k,)) for k in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a second upload would show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(uploads) == 1 and all(answers)
    index = pers.index()
    assert [_key(vt.search(r, index)) for r in reqs] == answers[: len(reqs)]
    part = vt.RequestSearchPart.from_dict({"terms": ["majes"], "path": "meanings.ger[]", "starts_with": True})
    batch = vt.search_batch(reqs, pers)
    assert [_key(r) for r in batch] == [_key(r) for r in vt.search_batch(reqs, index)]
    assert vt.search_to_result_with_doc(pers, batch[0], ["ent_seq"]).data
    assert vt.suggest(pers, vt.suggest_query("maj", pers)) == vt.suggest_batch(index, [vt.suggest_query("maj", index)])[0]
    assert vt.explain_plan(reqs[1], pers) == vt.explain_plan(reqs[1], index)
    assert vt.search_query(pers, vt.SearchQueryGeneratorParameters(search_term="will")).search_req is not None
    assert vt.highlight_field(pers, vt.RequestSearchPart.from_dict(
        {"terms": ["majestät"], "path": "meanings.ger[]"}))
    assert port_field_search.get_term_ids_in_field(pers, part).terms == {}
    assert importlib.import_module("veloci_tpu_torch.search.read_document").read_data(pers, 0, ["ent_seq"])
    mask = np.ones(pers.num_docs, dtype=bool)
    assert port_facet.get_facet(pers, vt.FacetRequest(field="tags[]", top=10), mask)
    assert len(uploads) == 1 and pers.index() is index


def test_host_entries_read_the_persistence_without_an_upload(monkeypatch):
    """The query generator and ``read_data`` read only host stores: on a
    ``Persistence`` they answer as on its upload, and upload nothing."""
    uploads = _counting_uploads(monkeypatch)
    pers = vt.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    read_data = importlib.import_module("veloci_tpu_torch.search.read_document").read_data
    params = vt.SearchQueryGeneratorParameters(search_term="will majes*", facets=["tags[]"])
    host = (repr(vt.search_query(pers, params)), repr(vt.suggest_query("maj", pers)), read_data(pers, 0, ["ent_seq"]))
    assert not uploads and pers._index is None
    index = pers.index()
    want = (repr(vt.search_query(index, params)), repr(vt.suggest_query("maj", index)), read_data(index, 0, ["ent_seq"]))
    assert host == want


PACKAGE_CHECK = """
import sys
import veloci_tpu_torch as vt
assert "torch" not in sys.modules, "import veloci_tpu_torch loaded torch"
from veloci_tpu_torch.search import facet
assert "torch" in sys.modules and callable(vt.search)
assert vt.search is sys.modules["veloci_tpu_torch.search.executor"].search
from veloci_tpu_torch import search
assert search is vt.search and all(hasattr(vt, name) for name in vt.__all__)
print("ok")
"""


def test_package_loads_its_names_at_first_use():
    """``import veloci_tpu_torch`` loads no torch; a name loads its module,
    and ``search`` stays the function once the subpackage is imported."""
    proc = subprocess.run([sys.executable, "-c", PACKAGE_CHECK], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout + proc.stderr


def test_upload_on_another_device_raises(monkeypatch):
    """``Persistence.index(device)`` naming the kept upload's device returns
    it; naming another raises and keeps the upload (the meta device stands
    in for a second device on the CPU), until the upload is dropped."""
    uploads = _counting_uploads(monkeypatch)
    pers = vt.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    first = pers.index()
    assert pers.index("cpu") is first and len(uploads) == 1
    with pytest.raises(vt.VelociError, match="uploaded to cpu, not meta"):
        pers.index("meta")
    assert pers.index() is first and len(uploads) == 1
    pers.invalidate_device_cache()
    other = pers.index("meta")
    assert other.device == torch.device("meta") and pers.index() is other and len(uploads) == 2


def test_add_token_values_drops_the_upload(monkeypatch, pers_pair):
    uploads = _counting_uploads(monkeypatch)
    req = REQUESTS[2]
    pers = vt.Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    before = vt.search(vt.Request.from_dict(req), pers)
    vt.add_token_values_to_tokens(pers, *TOKEN_VALUES)
    assert pers._index is None and len(uploads) == 1
    after = vt.search(vt.Request.from_dict(req), pers)
    assert len(uploads) == 2
    want = ref.search(ref.Request.from_dict(req), pers_pair[0])
    assert _key(after) == _key(want) != _key(before)  # the new column counts


@pytest.mark.parametrize("field", ["tags[]", "commonness", "meanings.eng[]", "ent_seq"])
def test_get_facet_takes_a_host_mask(pers_pair, field):
    """Equal counts from a host mask and from a plane, and equal to the
    reference's but where a hit holds a tag longer than the field stores
    (document 6's): there the reference raises ``IndexError`` (ROADMAP
    C10) and the port counts the text."""
    ref_pers, pers = pers_pair
    rng = np.random.default_rng(len(field))
    index = pers.index()
    compared = 0
    for _ in range(6):
        mask = rng.random(pers.num_docs) < 0.6
        got = port_facet.get_facet(pers, vt.FacetRequest(field=field, top=10), mask)
        plane = torch.from_numpy(mask.astype(np.float32))
        assert got and port_facet.get_facet(index, vt.FacetRequest(field=field, top=10), plane) == got
        if field == "tags[]" and mask[6]:
            with pytest.raises(IndexError):
                ref_facet.get_facet(ref_pers, ref.FacetRequest(field=field, top=10), mask)
            continue
        assert got == ref_facet.get_facet(ref_pers, ref.FacetRequest(field=field, top=10), mask)
        compared += 1
    assert compared


FIELD_PARTS = [
    {"terms": ["majes"], "path": "meanings.ger[]", "levenshtein_distance": 0, "starts_with": True},
    {"terms": ["will"], "path": "meanings.eng[]", "levenshtein_distance": 1},
    {"terms": ["Begeisterung"], "path": "meanings.ger[]", "top": 1,
     "token_value": {"path": "meanings.ger[]", "boost_fun": "Log10", "param": 1}},
    {"terms": ["maj"], "path": "meanings.ger[]", "starts_with": True, "levenshtein_distance": 1, "top": 2,
     "skip": 1, "boost": 2.5},
]
FLAGS = [{}, {"return_term": True}, {"return_term": True, "return_term_lowercase": True},
         {"get_scores": False, "get_ids": True, "return_term": True},
         {"store_term_id_hits": True, "store_term_texts": True, "get_ids": True}]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "-".join(f) or "default")
@pytest.mark.parametrize("i", range(len(FIELD_PARTS)))
def test_get_term_ids_in_field_as_the_reference(pers_pair, i, flags):
    ref_pers, pers = pers_pair
    got = port_field_search.get_term_ids_in_field(pers, vt.RequestSearchPart.from_dict(FIELD_PARTS[i]), **flags)
    want = ref_field_search.get_term_ids_in_field(ref_pers, ref.RequestSearchPart.from_dict(FIELD_PARTS[i]),
                                                  **flags)
    assert np.array_equal(got.term_ids, want.term_ids) and np.array_equal(got.hits_ids, want.hits_ids)
    assert np.asarray(got.term_scores, np.float32).tobytes() == np.asarray(want.term_scores, np.float32).tobytes()
    assert (got.terms, got.term_id_hits_in_field, got.term_text_in_field) == (
        want.terms, want.term_id_hits_in_field, want.term_text_in_field)
    assert len(got.hits_ids) or len(got.term_ids)


def _cli(*args, log=None):
    env = {k: v for k, v in os.environ.items() if k != "VELOCI_LOG"}
    if log is not None:
        env["VELOCI_LOG"] = log
    return subprocess.run([sys.executable, "-m", "veloci_tpu_torch.cli", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)


@pytest.mark.parametrize("log", ["info", None], ids=["info", "unset"])
def test_large_search_logs_each_search(log):
    proc = _cli("test_large_search", "--num-docs", "2000", "--device", "cpu", log=log)
    assert proc.returncode == 0, proc.stderr
    assert "2000 hits" in proc.stdout and "cpu" in proc.stdout and "6 searches" in proc.stdout, proc.stdout
    assert proc.stderr.count("search took") == (6 if log else 0), proc.stderr


def test_create_test_index_on_paragraphs(tmp_path, capsys):
    rng = np.random.default_rng(17)
    words = [f"wort{i}" for i in range(50)]
    paragraphs = [" ".join(rng.choice(words, size=int(rng.integers(3, 30)))) for _ in range(120)]
    book = tmp_path / "book.txt"
    book.write_text("\n\n".join(p.replace(" ", "\n", 1) for p in paragraphs) + "\n\n\n")
    cli.main(["create_test_index", "--corpus", "gutenberg", "--data", str(book), "--target", str(tmp_path / "g")])
    assert "120 docs" in capsys.readouterr().out
    pers = vt.Persistence.load(str(tmp_path / "g"))
    res = vt.search(vt.Request.from_dict({"search_req": {"search": {"terms": ["wort7"], "path": "line"}},
                                          "top": 200}), pers)
    assert res.num_hits == sum("wort7" in p.split() for p in paragraphs) > 0
    doc = vt.search_to_result_with_doc(pers, res).data[0].doc
    assert doc["line"] == paragraphs[int(doc["nr"])].replace(" ", "\n", 1)


def test_create_test_index_on_jmdict_like_documents(tmp_path, capsys):
    import bench  # the reference's corpus, here only

    from veloci_tpu_torch.synthetic import build_corpus

    data, vocab = build_corpus(2000)
    ref_data, ref_vocab = bench.build_corpus(2000)
    assert data == ref_data and np.array_equal(vocab, ref_vocab)
    cli.main(["create_test_index", "--num-docs", "2000", "--target", str(tmp_path / "j")])
    assert "2000 docs" in capsys.readouterr().out
    pers = vt.Persistence.load(str(tmp_path / "j"))
    assert pers.num_docs == 2000 and sorted(pers.get_all_fields()) == ["cat", "ent_seq", "pop", "title"]
    res = vt.search(vt.Request.from_dict({"search_req": {"search": {"terms": [str(vocab[0])], "path": "title"}}}),
                    pers)
    assert res.num_hits == sum(str(vocab[0]) in line.split('"')[3].split() for line in data.split("\n"))
