"""Command-line tools of the port.

The port's copy of ``veloci_tpu/cli.py`` (reference veloci_bins,
veloci_bins/src/bin/):

* ``create_index``: build an index directory from an ndjson file and a
  TOML/JSON fields config (create_index.rs:22-37)
* ``convert_json_to_line_delimited``: arbitrary JSON -> ndjson
* ``serve``: start the HTTP server (``server.py``), its databases on the
  card unless ``--device`` names another (``--device cpu`` for the CPU)

Usage: ``python -m veloci_tpu_torch.cli <command> [args]``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from .json_flatten import to_line_delimited
from .persistence import Persistence

__all__ = ["main"]


def cmd_create_index(args) -> None:
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


def cmd_serve(args) -> None:
    from .server import ensure_database, make_server

    for db in args.databases:
        t0 = time.perf_counter()
        index = ensure_database(db, trusted_path=True, device=args.device)
        total = time.perf_counter() - t0
        warmup = sum(index.last_warmup_breakdown.values())
        print(f"database {db!r}: {index.num_docs} docs on {index.device}, "
              f"load {total - warmup:.3f} s, warmup {warmup:.3f} s", flush=True)
    server = make_server(args.host, args.port, device=args.device)
    print(f"Starting Server on {args.host}:{args.port} (device {args.device}) ...", flush=True)
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

    p = sub.add_parser("serve", help="start the HTTP server")
    p.add_argument("databases", nargs="*", help="databases to load before the first request")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=3000)
    p.add_argument("--device", default="cuda", help="torch device of the databases (default: the card)")
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":  # pragma: no cover
    main()
