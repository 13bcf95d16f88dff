"""Run one cell of the benchmark of veloci_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is a ``workloads`` entry of ``BENCHMARK.json``; its configuration,
traffic mix and metrics are found by name under ``benchmark/``. The run
sets up the port (index built from the seed's corpus, or read from
``benchmark/cache/``), warms up, measures for ``--seconds`` seconds, checks
the answers against the plain reference, and prints one JSON line last on
standard output. Without a CUDA card, or with fewer than the cell asks for,
it prints no result and exits with 2. If ``jax``, ``jaxlib``, ``flax`` or
``veloci_tpu`` was loaded, it names them on standard error, prints no result
and exits with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark.harness import runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        log(f"no result: {args.workload} needs {cell.chips} CUDA card(s), torch.cuda finds {found}")
        return 2
    log(f"{args.workload} seed {args.seed}, {args.seconds:g} s, trace {args.trace}, "
        f"on {torch.cuda.get_device_name(0)}")
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0, log=log)
    loaded = runner.forbidden_modules()
    if loaded:
        log(f"no result: the run loaded {', '.join(loaded)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
