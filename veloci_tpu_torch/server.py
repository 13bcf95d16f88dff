"""HTTP API server of the port, on one torch device.

The port's copy of ``veloci_tpu/server.py``, with its routes (reference
server/rocket_server.rs:110-510):

* ``GET  /version``
* ``GET  /stats``                            (route counters, :mod:`.search.stats`)
* ``GET  /<db>/search?query=...``            (query-generator params)
* ``POST /<db>/search``                      (raw `Request` JSON)
* ``POST /<db>/search_batch``                (list of requests, one batch)
* ``POST /<db>/search_query_params``         (`SearchQueryGeneratorParameters`)
* ``POST /<db>/search_query_params/explain_plan``
* ``GET  /<db>/suggest?query=...`` / ``POST /<db>/suggest``
* ``POST /<db>/highlight``                   (`RequestSearchPart`)
* ``GET  /<db>/_id/<id>``                    (doc store fetch)
* ``GET  /<db>/_idtree/<id>``                (reconstruction from indices)
* ``GET  /<db>/inspect/<path>/<id>``         (raw index reads)

Databases load lazily from disk on first touch, under a lock (reference
`ensure_database`, rocket_server.rs:95-100), onto the server's device: the
default device (:func:`.persistence.set_default_device`, the card) unless
:func:`make_server` (or the CLI's ``--device``) asks for another; with no
GPU a load onto the card raises, and nothing carries on on the CPU.
A database is warmed up after its load (``TorchIndex.warmup``) unless
``VELOCI_WARMUP=0``. Lone searches and suggests that arrive together fold
into one ``search_batch`` or ``suggest_batch`` (``VELOCI_FOLD=0`` turns this
off, ``VELOCI_FOLD_MAX`` caps a fold); a handler waits at most
``_FOLD_WAIT_S`` (600 s) for its answer, and a fold loop that died is
replaced. The listening socket's backlog is 1024 connections. Every kernel
launch stays on the calling thread's current stream.
"""

from __future__ import annotations

import json
import os
import queue as _queue
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import torch

from .error import VelociError
from .persistence import TorchIndex, default_device, load_index
from .query.generator import SearchQueryGeneratorParameters, search_query, suggest_query
from .query.request import Request, RequestBoostPart, RequestSearchPart
from .search.batch import search_batch
from .search.executor import explain_plan, search, search_to_result_with_doc, suggest, suggest_batch
from .search.field_search import highlight_field
from .search.read_document import read_data
from .search.stats import count_path, snapshot

__all__ = ["VelociServer", "make_server", "ensure_database", "main", "PERSISTENCES"]

PERSISTENCES: Dict[str, TorchIndex] = {}
_LOCK = threading.Lock()

# databases resolve under this directory; the decoded URL segment must stay
# inside it (rejects '/', '\\', '..': a remote client must not be able to
# load arbitrary filesystem paths through GET /<db>/search)
BASE_DIR = os.environ.get("VELOCI_DB_DIR", ".")


def _resolve_db_path(database: str) -> str:
    if (
        not database
        or database in (".", "..")
        or "/" in database
        or "\\" in database
        or "\x00" in database
        or os.path.isabs(database)
    ):
        raise VelociError(f"invalid database name: {database!r}")
    base = os.path.realpath(BASE_DIR)
    path = os.path.realpath(os.path.join(base, database))
    if path != base and not path.startswith(base + os.sep):
        raise VelociError(f"invalid database name: {database!r}")
    if not os.path.isdir(path):
        raise VelociError(f"database not found: {database!r}")
    return path


def ensure_database(database: str, *, trusted_path: bool = False, device=None) -> TorchIndex:
    """Load (once) and return a database, on ``device`` (the default device
    when it is None).

    ``trusted_path=True`` is for local callers (the CLI's positional
    database arguments); HTTP handlers always go through name validation.
    """
    with _LOCK:
        index = PERSISTENCES.get(database)
        if index is None:
            path = database if trusted_path else _resolve_db_path(database)
            index = load_index(path, device)
            if os.environ.get("VELOCI_WARMUP", "1") != "0":
                index.warmup()  # build the kernels and fill the caches before the first request
            PERSISTENCES[database] = index
        return index


def _csv(val: Optional[str]):
    if val is None:
        return None
    return [v for v in val.split(",") if v]


def _params_from_query(qs: Dict[str, str]) -> SearchQueryGeneratorParameters:
    """GET /search query params -> generator params (rocket_server.rs:176-244)."""

    def get(name, cast=None):
        v = qs.get(name)
        if v is None or cast is None:
            return v
        return cast(v)

    def get_bool(name):
        v = qs.get(name)
        return None if v is None else v.lower() == "true"

    boost_fields = None
    if qs.get("boost_fields"):
        boost_fields = {}
        for el in _csv(qs["boost_fields"]):
            field, _, val = el.partition("->")
            boost_fields[field] = float(val)
    boost_terms = None
    if qs.get("boost_terms"):
        boost_terms = {}
        for el in _csv(qs["boost_terms"]):
            term, _, val = el.partition("->")
            boost_terms[term] = float(val) if val else 2.0
    boost_queries = None
    if qs.get("boost_queries"):
        boost_queries = [RequestBoostPart.from_dict(b) for b in json.loads(qs["boost_queries"])]

    stopwords = _csv(qs.get("stopwords"))
    return SearchQueryGeneratorParameters(
        search_term=qs.get("query", ""),
        top=get("top", int),
        skip=get("skip", int),
        operator=qs.get("operator"),
        levenshtein=get("levenshtein", int),
        levenshtein_auto_limit=get("levenshtein_auto_limit", int),
        facetlimit=get("facetlimit", int),
        why_found=get_bool("why_found"),
        phrase_pairs=get_bool("phrase_pairs"),
        text_locality=get_bool("text_locality"),
        facets=_csv(qs.get("facets")),
        stopword_lists=_csv(qs.get("stopword_lists")),
        stopwords=set(stopwords) if stopwords else None,
        fields=_csv(qs.get("fields")),
        boost_fields=boost_fields,
        boost_terms=boost_terms,
        explain=get_bool("explain"),
        boost_queries=boost_queries,
        filter=qs.get("filter"),
        select=qs.get("select"),
    )


# ---------------------------------------------------------------- folding
# Lone requests arriving concurrently fold into ONE batched call: the
# dispatcher thread drains whatever queued while the previous batch ran (no
# artificial wait: no added latency when idle, natural micro-batches under
# load). VELOCI_FOLD=0 disables.
_FOLD_ENABLED = os.environ.get("VELOCI_FOLD", "1") != "0"
_MAX_FOLD = int(os.environ.get("VELOCI_FOLD_MAX", "256"))
# how long a handler waits for its folded answer; each second it also
# replaces a fold loop that died, so the queue drains
_FOLD_WAIT_S = 600.0
_fold_queue: "_queue.Queue" = _queue.Queue()
_fold_thread: Optional[threading.Thread] = None
_fold_lock = threading.Lock()


class _FoldItem:
    __slots__ = ("pers", "request", "event", "result", "error", "kind")

    def __init__(self, pers, request, kind="search"):
        self.pers = pers
        self.request = request
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.kind = kind


def _answer_fold(batch) -> None:
    """Answers one fold: a ``suggest_batch`` or ``search_batch`` for each
    index and kind (``search`` for a lone request)."""
    by_pers: Dict[tuple, tuple] = {}
    for it in batch:
        by_pers.setdefault((id(it.pers), it.kind), (it.pers, []))[1].append(it)
    count_path("fold_dispatches")
    if len(batch) > 1:
        count_path("fold_folded_requests", len(batch))
    for (_pid, kind), (pers, items) in by_pers.items():
        try:
            if kind == "suggest":
                res = suggest_batch(pers, [it.request for it in items])
                for it, r in zip(items, res):
                    it.result = r
            elif len(items) == 1:
                items[0].result = search(items[0].request, pers)
            else:
                res = search_batch([it.request for it in items], pers)
                for it, r in zip(items, res):
                    it.result = r
        except VelociError as e:
            # A bad request (unknown field, invalid boost) raises for the
            # whole batch it was folded into: answer each request of that
            # fold alone, so its neighbours get their own answers
            # (ROADMAP C9). Counted as fold_retried_alone.
            if len(items) == 1:
                items[0].error = e
            else:
                count_path("fold_retried_alone", len(items))
                for it in items:
                    try:
                        it.result = (suggest(pers, it.request) if kind == "suggest"
                                     else search(it.request, pers))
                    except Exception as e1:  # noqa: BLE001 - surfaced per request
                        it.error = e1
        except Exception as e:  # noqa: BLE001 - surfaced per request
            for it in items:
                if it.result is None:
                    it.error = e


def _fold_loop() -> None:  # pragma: no cover - exercised via threads in tests
    while True:
        batch = [_fold_queue.get()]
        while len(batch) < _MAX_FOLD:
            try:
                batch.append(_fold_queue.get_nowait())
            except _queue.Empty:
                break
        try:
            _answer_fold(batch)
        except Exception as e:  # noqa: BLE001 - a fault outside a group's search
            for it in batch:
                if it.result is None and it.error is None:
                    it.error = e
        finally:  # every item of the fold is answered, whatever ended it
            for it in batch:
                if it.result is None and it.error is None:
                    it.error = RuntimeError("the fold loop ended before answering")
                it.event.set()


def _start_fold_loop() -> None:
    """Starts the fold loop, or a new one if the last has died."""
    global _fold_thread
    if _fold_thread is None or not _fold_thread.is_alive():
        with _fold_lock:
            if _fold_thread is None or not _fold_thread.is_alive():
                _fold_thread = threading.Thread(target=_fold_loop, daemon=True, name="veloci-fold")
                _fold_thread.start()


def _folded(pers, request: Request, kind: str):
    item = _FoldItem(pers, request, kind)
    _start_fold_loop()
    _fold_queue.put(item)
    waited = 0.0
    while not item.event.wait(1.0):
        waited += 1.0
        if waited >= _FOLD_WAIT_S:
            raise TimeoutError(f"no answer from the fold loop in {_FOLD_WAIT_S:g} s")
        _start_fold_loop()
    if item.error is not None:
        raise item.error
    return item.result


def _folded_search(pers, request: Request):
    if not _FOLD_ENABLED:
        return search(request, pers)
    return _folded(pers, request, "search")


def _folded_suggest(pers, request: Request):
    """Concurrent suggest requests fold like search does: queued items
    drain into ONE suggest_batch per dispatch round."""
    if not _FOLD_ENABLED:
        return suggest(pers, request)
    return _folded(pers, request, "suggest")


def _search_result_json(pers, request: Request) -> dict:
    res = _folded_search(pers, request)
    with_doc = search_to_result_with_doc(pers, res, request.select)
    return with_doc.to_dict()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _reply(self, obj, status=200, raw=False) -> None:
        body = (obj if raw else json.dumps(obj, ensure_ascii=False)).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json" if not raw else "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def _error(self, message: str, status=400) -> None:
        self._reply({"error": message}, status=status)

    def _database(self, segment: str) -> TorchIndex:
        return ensure_database(urllib.parse.unquote(segment), device=self.server.device)

    def _body_json(self):
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    # ------------------------------------------------------------------ GET
    def do_GET(self) -> None:  # noqa: N802
        try:
            parsed = urllib.parse.urlparse(self.path)
            qs = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
            parts = [p for p in parsed.path.split("/") if p]
            if parsed.path == "/version":
                self._reply("0.8", raw=True)
                return
            if parsed.path == "/stats":
                self._reply(snapshot())
                return
            if len(parts) == 2 and parts[1] == "search":
                pers = self._database(parts[0])
                request = search_query(pers, _params_from_query(qs))
                if qs.get("select"):
                    request.select = _csv(qs["select"])
                self._reply(_search_result_json(pers, request))
                return
            if len(parts) == 2 and parts[1] == "suggest":
                pers = self._database(parts[0])
                request = suggest_query(
                    qs.get("query", ""),
                    pers,
                    int(qs["top"]) if qs.get("top") else None,
                    int(qs["skip"]) if qs.get("skip") else None,
                    int(qs["levenshtein"]) if qs.get("levenshtein") else None,
                    _csv(qs.get("fields")),
                    int(qs["levenshtein_auto_limit"]) if qs.get("levenshtein_auto_limit") else None,
                )
                self._reply(_folded_suggest(pers, request))
                return
            if len(parts) == 3 and parts[1] == "_id":
                pers = self._database(parts[0])
                self._reply(json.loads(pers.doc_loader.get_doc(int(parts[2]))))
                return
            if len(parts) == 3 and parts[1] == "_idtree":
                pers = self._database(parts[0])
                self._reply(read_data(pers, int(parts[2]), pers.get_all_fields()))
                return
            if len(parts) == 4 and parts[1] == "inspect":
                pers = self._database(parts[0])
                store = pers.get_valueid_to_parent(urllib.parse.unquote(parts[2]))
                self._reply([int(v) for v in store.get_values(int(parts[3]))])
                return
            self._error("not found", 404)
        except VelociError as e:
            self._error(str(e), 400)
        except Exception as e:  # pragma: no cover
            self._error(repr(e), 500)

    # ----------------------------------------------------------------- POST
    def do_POST(self) -> None:  # noqa: N802
        try:
            parsed = urllib.parse.urlparse(self.path)
            parts = [p for p in parsed.path.split("/") if p]
            if len(parts) >= 2:
                route = "/".join(parts[1:])
                pers = self._database(parts[0])
                body = self._body_json()
                if route == "search":
                    self._reply(_search_result_json(pers, Request.from_dict(body)))
                    return
                if route == "search_batch":
                    # one batch for the whole list (search/batch.py)
                    requests = [Request.from_dict(b) for b in body]
                    out = [search_to_result_with_doc(pers, res, req.select).to_dict()
                           for req, res in zip(requests, search_batch(requests, pers))]
                    self._reply(out)
                    return
                if route == "search_query_params":
                    request = search_query(pers, SearchQueryGeneratorParameters.from_dict(body))
                    if body.get("select"):
                        request.select = _csv(body["select"])
                    self._reply(_search_result_json(pers, request))
                    return
                if route == "search_query_params/explain_plan":
                    request = search_query(pers, SearchQueryGeneratorParameters.from_dict(body))
                    self._reply(explain_plan(request, pers), raw=True)
                    return
                if route == "suggest":
                    self._reply(_folded_suggest(pers, Request.from_dict(body)))
                    return
                if route == "highlight":
                    self._reply(highlight_field(pers, RequestSearchPart.from_dict(body)))
                    return
            self._error("not found", 404)
        except VelociError as e:
            self._error(str(e), 400)
        except Exception as e:  # pragma: no cover
            self._error(repr(e), 500)


class VelociServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True
    device = None  # where the databases it loads go (make_server sets it)
    # the listen backlog (socketserver's default is 5): connections the
    # kernel completes while the accept loop is behind wait here. Past it
    # the kernel drops new handshakes, and one it dropped after the client
    # had sent its request is answered with a reset; the kernel caps the
    # value at net.core.somaxconn
    request_queue_size = 1024


def make_server(host: str = "0.0.0.0", port: int = 3000, device=None) -> VelociServer:
    """A threading HTTP server whose databases load onto ``device``, the
    default device when it is None."""
    server = VelociServer((host, port), _Handler)
    server.device = default_device() if device is None else torch.device(device)
    return server


def main() -> None:  # pragma: no cover - the CLI's serve is the tested entry
    """``python -m veloci_tpu_torch.server [databases] [--host] [--port]
    [--device]`` (``main``, ``veloci_tpu/server.py:412``): the CLI's
    ``serve``."""
    from .cli import main as cli_main

    cli_main(["serve", *sys.argv[1:]])


if __name__ == "__main__":  # pragma: no cover
    main()
