"""The port's HTTP server (``veloci_tpu_torch/server.py``), its stats and
its CLI (``veloci_tpu_torch/cli.py``) against the JAX package's.

* ``tests/test_server.py``'s cases, imported under a ``server`` fixture of
  this file's: the port's server on the CPU (``make_server(...,
  device="cpu")``) over an index the port built and saved. The folding
  case is copied, because it reads the reference's ``stats`` module; here
  it reads the port's.
* A parity test: the same GET and POST requests to a reference server and a
  port server over one ``TEST_CONFIG`` index directory that the reference
  saved (the port reads the reference's directory). Bodies must be equal
  but for ``execution_time_ns``, the values of ``/stats`` (its keys are
  compared) and ``explain_plan``'s ``path`` line, which names each
  package's own route.
* ``tests/test_cli.py``'s cases with its ``Persistence`` and ``main``
  rebound to the port's.
* With no GPU, a database the server or the CLI loads onto the card fails
  to load, and nothing is loaded on the CPU instead.

Tolerance: exact, apart from the three exceptions above.
"""

import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import pytest

import torch

import test_cli as tcli
import veloci_tpu.server as ref_server
import veloci_tpu_torch as vt
import veloci_tpu_torch.server as port_server
from corpus import TEST_CONFIG, data_ndjson
from test_server import (  # noqa: F401 -- the reference's cases, run here on the port's server
    CONFIG,
    TEST_DATA,
    _get,
    _post,
    test_concurrent_requests,
    test_db_name_missing_is_400_not_500,
    test_db_name_traversal_rejected,
    test_get_doc_by_id,
    test_get_idtree,
    test_get_request,
    test_get_suggest,
    test_get_version,
    test_post_explain_plan,
    test_post_request_invalid_field,
    test_post_search_query_params,
    test_post_search_raw_request,
    test_search_batch_route,
    test_stats_route,
)
from veloci_tpu import Persistence
from veloci_tpu_torch import cli as port_cli
from veloci_tpu_torch.error import InvalidRequestError
from veloci_tpu_torch.search import stats as port_stats
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """One directory of databases for both packages' servers:
    ``test_http`` (``tests/test_server.py``'s document, built by the port)
    and ``test_all`` (the ``TEST_CONFIG`` corpus, built by the reference)."""
    base = tmp_path_factory.mktemp("torch_server_dbs")
    vt.Persistence.create_from_str(TEST_DATA, CONFIG).save(str(base / "test_http"))
    Persistence.create_from_str(data_ndjson(), TEST_CONFIG).save(str(base / "test_all"))
    return base


def _start(module, base, **kw):
    srv = module.make_server("127.0.0.1", 0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv, limit=30.0):
    """``shutdown`` waits for ``serve_forever`` to return: at most ``limit``."""
    stopper = threading.Thread(target=srv.shutdown, daemon=True)
    stopper.start()
    stopper.join(limit)
    srv.server_close()
    assert not stopper.is_alive(), f"the server on port {srv.server_address[1]} did not stop in {limit} s"


def _join_all(threads, limit):
    """Joins ``threads`` within one deadline of ``limit`` seconds in all."""
    deadline = time.monotonic() + limit
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    return [t for t in threads if t.is_alive()]


@pytest.fixture(scope="module")
def servers(dbs):
    """The port's server on the CPU and the reference's, both over ``dbs``."""
    old = port_server.BASE_DIR, ref_server.BASE_DIR
    port_server.BASE_DIR = ref_server.BASE_DIR = str(dbs)
    port = _start(port_server, dbs, device="cpu")
    ref = _start(ref_server, dbs)
    try:
        yield {"port": port, "ref": ref}
    finally:
        _stop(port)
        _stop(ref)
        port_server.PERSISTENCES.clear()
        ref_server.PERSISTENCES.clear()
        port_server.BASE_DIR, ref_server.BASE_DIR = old


@pytest.fixture(scope="module")
def server(servers):
    """``tests/test_server.py``'s fixture, on the port's server."""
    return servers["port"], "test_http"


def test_request_folding_under_concurrency(server):
    """32 parallel lone GET /search requests fold into micro-batches via the
    dispatcher thread; every response must still be correct and /stats must
    show folding activity."""
    port_stats.reset()
    paths = ["/DB/search?query=hi&top=5", "/DB/search?query=fred&top=5"] * 16

    def one(path):
        return _get(server, path)

    with ThreadPoolExecutor(max_workers=32) as pool:
        results = list(pool.map(one, paths))
    for (status, body), path in zip(results, paths):
        assert status == 200, path
        assert json.loads(body)["num_hits"] >= 1, path
    snap = port_stats.snapshot()
    assert snap["paths"].get("fold_dispatches", 0) >= 1


@pytest.mark.parametrize("raised, retried", [(InvalidRequestError, True), (RuntimeError, False)])
def test_fold_retries_alone_only_request_errors(monkeypatch, raised, retried):
    """A folded batch that raises a request error answers each of its
    requests alone and counts them as ``fold_retried_alone``; any other
    error fails every request of the fold, as in the reference."""
    entered, gate = threading.Event(), threading.Event()

    def lone(request, _pers):
        if request == "first":
            entered.set()
            gate.wait(30)
        return ("alone", request)

    def folded_batch(requests, _pers):
        raise raised(f"planted in a fold of {len(requests)}")

    monkeypatch.setattr(port_server, "_FOLD_ENABLED", True)
    monkeypatch.setattr(port_server, "search", lone)
    monkeypatch.setattr(port_server, "search_batch", folded_batch)
    port_stats.reset()
    pers, out = object(), {}

    def call(request):
        try:
            out[request] = port_server._folded_search(pers, request)
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[request] = e

    first = threading.Thread(target=call, args=("first",), daemon=True)
    first.start()
    assert entered.wait(30)  # the dispatcher holds "first" while the rest queue
    rest = [threading.Thread(target=call, args=(r,), daemon=True) for r in ("a", "b", "c")]
    for t in rest:
        t.start()
    for _ in range(3000):
        if port_server._fold_queue.qsize() == len(rest):
            break
        threading.Event().wait(0.01)
    assert port_server._fold_queue.qsize() == len(rest)
    gate.set()
    assert not _join_all([first, *rest], 60)
    assert out["first"] == ("alone", "first")
    paths = port_stats.snapshot()["paths"]
    assert paths["fold_folded_requests"] == len(rest)
    if retried:
        assert [out[r] for r in "abc"] == [("alone", r) for r in "abc"]
        assert paths["fold_retried_alone"] == len(rest)
    else:
        assert all(isinstance(out[r], RuntimeError) for r in "abc")
        assert "fold_retried_alone" not in paths


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")  # the planted exit
@pytest.mark.parametrize("fault", [RuntimeError, SystemExit])
def test_a_fold_fault_outside_a_group_answers_and_the_loop_goes_on(monkeypatch, fault):
    """A fault in the fold loop outside a group's search (a ``RuntimeError``,
    or a ``SystemExit`` that ends the loop's thread): the fold's request is
    answered with an error instead of waiting without end, and the next
    folded request is answered, by a new loop where the old one ended."""
    monkeypatch.setattr(port_server, "_FOLD_ENABLED", True)
    monkeypatch.setattr(port_server, "search", lambda request, _pers: ("alone", request))
    real, planted = port_server._answer_fold, []

    def faulty(batch):
        if not planted:
            planted.append(batch)
            raise fault("planted outside a group")
        return real(batch)

    monkeypatch.setattr(port_server, "_answer_fold", faulty)
    pers = object()
    with pytest.raises(RuntimeError, match="planted" if fault is RuntimeError else "ended before answering"):
        port_server._folded_search(pers, "first")
    assert port_server._folded_search(pers, "second") == ("alone", "second")
    assert port_server._fold_thread.is_alive() and len(planted) == 1


def test_server_cases_listed():
    """Every case of ``tests/test_server.py`` runs here."""
    import test_server

    cases = {n for n in dir(test_server) if n.startswith("test_")}
    assert len(cases) == 15 and cases <= set(globals())


# ---------------------------------------------------------------- parity with the reference's server

GER, ENG = "meanings.ger[]", "meanings.eng[]"
Q = urllib.parse.quote


def _leaf(term, path=GER, **kw):
    return {"search": dict({"terms": [term], "path": path}, **kw)}


GETS = [
    "/version",
    "/DB/search?query=majestät",
    "/DB/search?query=majestät&top=2&skip=1",
    "/DB/search?query=guter%20treffer&operator=and",
    "/DB/search?query=weich~1&levenshtein=1",
    "/DB/search?query=majes*",
    "/DB/search?query=urge&explain=true",
    "/DB/search?query=will&why_found=true&select=meanings.ger[],meanings.eng[]",
    "/DB/search?query=treffer&facets=tags[],commonness&facetlimit=2",
    "/DB/search?query=guter&boost_fields=meanings.ger[]-%3E2.5",
    "/DB/search?query=die%20erbin%20taschenbuch&phrase_pairs=true",
    "/DB/search?query=text%20localität&text_locality=true",
    "/DB/search?query=guter&boost_terms=meanings.ger[]:treffer-%3E2.0",
    "/DB/search?query=guter&filter=" + Q("tags[]:nice"),
    "/DB/search?query=nothere",
    "/DB/search?query=guter&fields=nothere",
    "/DB/suggest?query=maj",
    "/DB/suggest?query=tre&top=3&levenshtein=1",
    "/DB/suggest?query=wil&fields=meanings.eng[]",
    "/DB/_id/2",
    "/DB/_idtree/2",
    "/DB/_idtree/5",
    "/DB/inspect/" + Q("meanings.ger[].textindex.value_id_to_parent") + "/3",
    "/DB/nothere",
    "/no_such_db/search?query=x",
]
POSTS = [
    ("/DB/search", {"search_req": _leaf("majestät")}),
    ("/DB/search", {"search_req": {"or": {"queries": [_leaf("majestät"), _leaf("urge", ENG)]}}, "explain": True,
                    "select": [GER, "ent_seq"]}),
    ("/DB/search", {"search_req": _leaf("意慾", "kanji[].text"), "explain": True,
                    "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}]}),
    ("/DB/search", {"search_req": _leaf("urge", ENG, options={"explain": True}), "why_found": True}),
    ("/DB/search", {"search_req": _leaf("nothere", "nofield")}),
    ("/DB/search_batch", [{"search_req": _leaf("majestät")}, {"search_req": _leaf("urge", ENG), "explain": True},
                          {"search_req": {"and": {"queries": [_leaf("guter"), _leaf("treffer")]}}, "top": 1},
                          {"search_req": _leaf("weich", levenshtein_distance=1), "facets": [{"field": "commonness"}]}]),
    ("/DB/search_query_params", {"search_term": "majestät", "top": 3, "select": "meanings.ger[]", "why_found": True}),
    ("/DB/search_query_params", {"search_term": "urge", "explain": True}),
    ("/DB/search_query_params/explain_plan", {"search_term": "weich~1 guter", "facets": ["tags[]"]}),
    ("/DB/search_query_params/explain_plan", {"search_term": "die erbin taschenbuch", "phrase_pairs": True,
                                              "boost_terms": {"meanings.ger[]:treffer": 2.0}}),
    ("/DB/suggest", {"suggest": [{"terms": ["maj"], "path": GER, "starts_with": True}], "top": 5}),
    ("/DB/highlight", {"terms": ["majestät"], "path": GER, "snippet": True}),
    ("/DB/nothere", {}),
]


def _fetch(srv, method, path, body=None):
    path = urllib.parse.quote(path.replace("DB", "test_all"), safe="/?=&%:,[]~*-")
    url = f"http://127.0.0.1:{srv.server_address[1]}{path}"
    data = None if body is None else json.dumps(body).encode("utf-8")
    req = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _comparable(path, text):
    """The body as compared: ``execution_time_ns`` dropped, ``explain_plan``
    without its ``path`` line."""
    if path.endswith("explain_plan"):
        return [line for line in text.split("\n") if not line.startswith("  path ")]
    try:
        body = json.loads(text)
    except ValueError:
        return text

    def strip(obj):
        if isinstance(obj, dict):
            return {k: strip(v) for k, v in obj.items() if k != "execution_time_ns"}
        if isinstance(obj, list):
            return [strip(v) for v in obj]
        return obj
    return strip(body)


@pytest.mark.parametrize("method,path,body", [("GET", p, None) for p in GETS] + [("POST", p, b) for p, b in POSTS],
                         ids=lambda v: v if isinstance(v, str) else None)
def test_body_equals_reference_servers(servers, method, path, body):
    want = _fetch(servers["ref"], method, path, body)
    got = _fetch(servers["port"], method, path, body)
    assert got[0] == want[0], (got, want)
    assert _comparable(path, got[1]) == _comparable(path, want[1])
    if path.endswith("explain_plan"):
        assert sum(line.startswith("  path ") for line in got[1].split("\n")) == 1


def test_parity_cases_exercise_what_they_name(servers):
    """The parity requests reach answers, explain entries, errors and plans."""
    port = servers["port"]
    status, body = _fetch(port, "GET", "/DB/search?query=urge&explain=true")
    assert status == 200 and all(d["explain"] for d in json.loads(body)["data"])
    status, body = _fetch(port, "POST", *POSTS[2])
    assert status == 200 and sum("Boost" in e for e in json.loads(body)["data"][0]["explain"]) == 2
    assert _fetch(port, "GET", "/DB/search?query=guter&fields=nothere")[0] == 400
    assert _fetch(port, "GET", "/DB/nothere")[0] == 404
    status, body = _fetch(port, "POST", *POSTS[8])
    assert status == 200 and "digraph" in body and "execution path: " in body


def test_stats_keys_equal_reference(servers):
    for srv in servers.values():
        _fetch(srv, "GET", "/DB/search?query=majestät")
    want = json.loads(_fetch(servers["ref"], "GET", "/stats")[1])
    got = json.loads(_fetch(servers["port"], "GET", "/stats")[1])
    assert set(got) == set(want)
    assert got["total_requests"] >= 1 and got["paths"]


def test_concurrent_mixed_requests_equal_sequential(servers):
    """Searches, explained searches, batches, suggests, plans, highlights
    and document reads from 16 threads at once: each body equals the body
    of the same request sent alone."""
    port = servers["port"]
    calls = [("GET", p, None) for p in GETS if "no_such_db" not in p] + [("POST", p, b) for p, b in POSTS]
    alone = [_comparable(p, _fetch(port, m, p, b)[1]) for m, p, b in calls]
    with ThreadPoolExecutor(max_workers=16) as pool:
        together = list(pool.map(lambda c: _comparable(c[1], _fetch(port, *c)[1]), calls * 3))
    assert together == alone * 3


def test_index_counters_exact_under_threads(dbs):
    """Server threads add to one index's counters at once: with a short
    switch interval and 36 threads, no addition is lost. (The interpreter
    switches threads on the interval whatever the cores: a count tied to
    the cores made this test slower, not stricter, on a larger machine.)"""
    import sys

    index = vt.load_index(str(dbs / "test_http"), "cpu")
    threads = 36
    per_thread = 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [(index.count_path("x"), index.count_rows("r", 2))
                                                    for _ in range(per_thread)], daemon=True)
                   for _ in range(threads)]
        for w in workers:
            w.start()
        alive = _join_all(workers, 120)
    finally:
        sys.setswitchinterval(old)
    assert not alive
    assert index.path_counts["x"] == threads * per_thread
    assert index.gathered_rows["r"] == 2 * threads * per_thread


# ---------------------------------------------------------------- the CLI

CLI_CASES = ["test_cli_create_index_and_load", "test_cli_convert_json_to_ndjson", "test_cli_heap_report_runs"]


@pytest.mark.parametrize("name", CLI_CASES)
def test_cli_cases_on_the_port(monkeypatch, tmp_path, capsys, name):
    monkeypatch.setattr(tcli, "Persistence", vt.Persistence)
    monkeypatch.setattr(tcli, "cli_main", port_cli.main)
    fn = getattr(tcli, name)
    if name == "test_cli_heap_report_runs":
        fn(tmp_path)
    else:
        fn(tmp_path, capsys)


def test_cli_index_equals_reference(tmp_path):
    """The port's ``create_index`` writes the reference's index: its heap
    report is the reference's, line for line."""
    data = tmp_path / "data.ndjson"
    data.write_text(data_ndjson())
    cfg = tmp_path / "config.toml"
    cfg.write_text(TEST_CONFIG)
    port_cli.main(["create_index", "--data", str(data), "--config", str(cfg), "--target", str(tmp_path / "db")])
    built = Persistence.create_from_file(str(data), TEST_CONFIG).heap_size_report()
    read = Persistence.load(str(tmp_path / "db")).heap_size_report()
    assert vt.Persistence.load(str(tmp_path / "db")).heap_size_report() == read
    assert vt.Persistence.create_from_file(str(data), TEST_CONFIG).heap_size_report() == built
    assert vt.Persistence.create_im(data_ndjson(), TEST_CONFIG).heap_size_report() == built
    mm = vt.Persistence.create_mmap(str(tmp_path / "mm"), data_ndjson(), TEST_CONFIG)
    assert mm.heap_size_report() == read and mm.path == str(tmp_path / "mm")
    index = vt.load_index(str(tmp_path / "db"), "cpu")
    assert index.bytes_indexed == Persistence.load(str(tmp_path / "db")).bytes_indexed > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="this machine has a CUDA device")
def test_no_gpu_no_cpu_fallback(dbs):
    """Without a GPU a database loaded onto the card fails to load, through
    the server and through ``cli serve``, and is not loaded on the CPU."""
    path = str(dbs / "test_http")
    with pytest.raises(RuntimeError, match="cuda"):
        port_server.ensure_database(path, trusted_path=True, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port_cli.main(["serve", path, "--port", "0"])
    assert path not in port_server.PERSISTENCES
