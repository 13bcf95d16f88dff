"""Command-line tools of the port.

The port's copy of ``veloci_tpu/cli.py`` (reference veloci_bins,
veloci_bins/src/bin/):

* ``create_index``: build an index directory from an ndjson file and a
  TOML/JSON fields config (create_index.rs:22-37)
* ``convert_json_to_line_delimited``: arbitrary JSON -> ndjson
* ``create_test_index``: build a test corpus's index: the jmdict-like
  synthetic corpus (:func:`.synthetic.build_corpus`), or one document a
  paragraph of a text file the user gives (``--corpus gutenberg --data
  book.txt``) (create_test_index.rs:19-31)
* ``test_large_search``: a corpus of one document repeated ``--num-docs``
  times, searched six times through ``search`` on a ``Persistence``
  (test_large_search.rs:23-45)
* ``test_very_large_index``: ``--pairs`` pairs through the external
  :class:`.spill.SpillSorter`, the merged stream verified, the peak of
  anonymous memory printed (test_very_large_index.rs:19-31)
* ``serve``: start the HTTP server (``server.py``)

Every command that uploads an index takes ``--device``; without it, the
default device (:func:`.persistence.set_default_device`): the card. The log
level comes from ``VELOCI_LOG`` (:func:`.trace.enable_log`); at ``info``
each root span logs its time: a ``search took`` line per ``search`` call,
a ``search_batch took`` line per direct ``search_batch`` call (each of
``serve``'s folds and batch requests), and a ``request.parse took`` line
per ``Request.from_dict`` (each request body ``serve`` parses).

Usage: ``python -m veloci_tpu_torch.cli <command> [args]``.
"""

from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from pathlib import Path

import numpy as np

from .json_flatten import to_line_delimited
from .trace import enable_log

__all__ = ["main"]


def cmd_create_index(args) -> None:
    from .persistence import Persistence

    config = Path(args.config).read_text() if args.config else "{}"
    data = Path(args.data).read_text()
    t0 = time.time()
    pers = Persistence.create_from_str(data, config)
    pers.save(args.target)
    print(
        f"created index {args.target!r}: {pers.num_docs} docs, "
        f"{pers.bytes_indexed} bytes indexed in {time.time() - t0:.1f}s"
    )


def cmd_convert(args) -> None:
    out = to_line_delimited(Path(args.input).read_bytes())
    if args.output:
        Path(args.output).write_text(out)
    else:
        sys.stdout.write(out)


def cmd_create_test_index(args) -> None:
    from .persistence import Persistence

    if args.corpus == "gutenberg":  # one document a paragraph of the given text
        paragraphs = [p.strip() for p in Path(args.data).read_text().split("\n\n") if p.strip()]
        data = "\n".join(json.dumps({"line": p, "nr": str(i)}) for i, p in enumerate(paragraphs))
        config = '{"line": {"fulltext": {"tokenize": true}}}'
        target = args.target or "gutenberg"
    else:  # the jmdict-like synthetic corpus
        from .synthetic import build_corpus

        data, _vocab = build_corpus(args.num_docs)
        config = "{}"
        target = args.target or "jmdict_like"
    pers = Persistence.create_from_str(data, config)
    pers.save(target)
    print(f"created {target!r}: {pers.num_docs} docs")


def cmd_test_large_search(args) -> None:
    """One document repeated ``--num-docs`` times, searched for "buch"
    through ``search`` on the built ``Persistence``: once cold (the call
    uploads the index), then five times warm (test_large_search.rs:39-45)."""
    from .persistence import Persistence
    from .query.generator import SearchQueryGeneratorParameters, search_query
    from .search.executor import search

    doc = '{"type":"taschenbuch","title":"mein buch"}'
    data = "\n".join([doc] * args.num_docs)
    t0 = time.time()
    pers = Persistence.create_from_str(data, "{}")
    print(f"built {args.num_docs}-doc index in {time.time() - t0:.1f}s")
    t0 = time.time()
    req = search_query(pers, SearchQueryGeneratorParameters(search_term="buch"))
    res = search(req, pers)
    print(f"search 'buch' (cold: the upload of the index to {pers.index().device}): "
          f"{res.num_hits} hits in {(time.time() - t0) * 1e3:.1f}ms")
    lat = []
    for _ in range(5):
        t0 = time.time()
        res = search(req, pers)
        lat.append((time.time() - t0) * 1e3)
    print(f"search 'buch' warm: {res.num_hits} hits, "
          f"p50 {sorted(lat)[len(lat) // 2]:.1f}ms over {len(lat)} runs; 6 searches")


def _anon_mb() -> float:
    """This process's anonymous resident memory (``RssAnon``), MB; the peak
    RSS where ``/proc`` is not there."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("RssAnon:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def cmd_test_very_large_index(args) -> None:
    """``--pairs`` pseudo-random (key, value) pairs through the external
    :class:`.spill.SpillSorter` (at its default chunk threshold unless
    ``--chunk-items``), merged and verified block by block (sorted, the
    payloads intact, the keys' checksum kept), with the peak of anonymous
    memory, which the chunk buffers bound and not the pair count
    (test_very_large_index.rs:19-31). Prints one ``test_very_large_index
    ok`` line with ``anon_peak_mb``."""
    from .spill import SpillSorter

    pairs = args.pairs
    gen_batch = 1_000_000
    rng = np.random.default_rng(42)
    t0 = time.time()
    key_sum = 0  # a Python int, reduced mod 2^64
    anon_peak = _anon_mb()
    with SpillSorter(**({"chunk_items": args.chunk_items} if args.chunk_items else {})) as s:
        left = pairs
        while left > 0:
            n = min(gen_batch, left)
            keys = rng.integers(0, 1 << 62, size=n, dtype=np.uint64)
            key_sum = (key_sum + int(keys.sum(dtype=np.uint64))) & 0xFFFFFFFFFFFFFFFF
            s.add(keys, keys ^ np.uint64(0xDEADBEEF))
            left -= n
            anon_peak = max(anon_peak, _anon_mb())
        add_s = time.time() - t0
        t0 = time.time()
        sk, sv = s.finish()
        merge_s = time.time() - t0
        anon_peak = max(anon_peak, _anon_mb())
        blk = 4_000_000  # verified a block at a time, in bounded memory
        out_sum = count = 0
        prev_last = None
        for base in range(0, len(sk), blk):
            kb = np.asarray(sk[base : base + blk])
            vb = np.asarray(sv[base : base + blk])
            assert np.all(kb[1:] >= kb[:-1]), "merged stream not sorted"
            assert prev_last is None or kb[0] >= prev_last, "run boundary out of order"
            prev_last = kb[-1]
            assert np.all(vb == (kb ^ np.uint64(0xDEADBEEF))), "payload mismatch"
            out_sum = (out_sum + int(kb.sum(dtype=np.uint64))) & 0xFFFFFFFFFFFFFFFF
            count += len(kb)
        anon_peak = max(anon_peak, _anon_mb())
    assert count == pairs, (count, pairs)
    assert out_sum == key_sum, "key checksum mismatch"
    rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
    print(f"test_very_large_index ok: pairs={pairs} add={add_s:.1f}s merge+verify={merge_s:.1f}s "
          f"anon_peak_mb={anon_peak:.0f} rss_mb={rss_mb:.0f} "
          f"pairs_per_s={pairs / max(add_s + merge_s, 1e-9):.0f}")


def cmd_serve(args) -> None:
    from .server import ensure_database, make_server

    for db in args.databases:
        t0 = time.perf_counter()
        index = ensure_database(db, trusted_path=True)
        total = time.perf_counter() - t0
        warmup = sum(index.last_warmup_breakdown.values())
        print(f"database {db!r}: {index.num_docs} docs on {index.device}, "
              f"load {total - warmup:.3f} s, warmup {warmup:.3f} s", flush=True)
    server = make_server(args.host, args.port)
    print(f"Starting Server on {args.host}:{args.port} (device {server.device}) ...", flush=True)
    server.serve_forever()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="veloci_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("create_index", help="build an index from ndjson")
    p.add_argument("--data", "-d", required=True, help="ndjson data file")
    p.add_argument("--target", "-t", required=True, help="index directory")
    p.add_argument("--config", "-c", help="TOML/JSON fields config file")
    p.set_defaults(fn=cmd_create_index)

    p = sub.add_parser("convert_json_to_line_delimited", help="arbitrary JSON -> ndjson")
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("create_test_index", help="build a test corpus index")
    p.add_argument("--corpus", choices=["jmdict", "gutenberg"], default="jmdict")
    p.add_argument("--data", help="text file for the gutenberg corpus")
    p.add_argument("--target", "-t")
    p.add_argument("--num-docs", type=int, default=100_000)
    p.set_defaults(fn=cmd_create_test_index)

    p = sub.add_parser("test_large_search", help="repeat-corpus smoke test")
    p.add_argument("--num-docs", type=int, default=1_000_000)
    p.add_argument("--device", help="torch device of the index (default: the card)")
    p.set_defaults(fn=cmd_test_large_search)

    p = sub.add_parser("test_very_large_index", help="40M-pair spill-writer smoke test (bounded-memory external sort)")
    p.add_argument("--pairs", type=int, default=40_000_000)
    p.add_argument("--chunk-items", type=int, default=0, help="SpillSorter chunk size (0 = the default threshold)")
    p.set_defaults(fn=cmd_test_very_large_index)

    p = sub.add_parser("serve", help="start the HTTP server")
    p.add_argument("databases", nargs="*", help="databases to load before the first request")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--device", help="torch device of the databases (default: the card)")
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    enable_log()
    if getattr(args, "device", None) is None:
        args.fn(args)
        return
    from .persistence import default_device, set_default_device

    old = default_device()
    set_default_device(args.device)
    try:
        args.fn(args)
    finally:
        set_default_device(old)


if __name__ == "__main__":  # pragma: no cover
    main()
