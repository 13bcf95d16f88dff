"""The readings the comparison's limits are set from (PERF.md, "limits").

    python3 benchmark/readings.py --config <config> --seeds <n> [<n> ...] \
        [--control-seeds <k>] [--seconds <s>] [--out <file.json>]

For every cell of the configuration and every seed, in one process: the
program answers a short window of the cell's traffic (its index made
once for a kept configuration, once a seed otherwise) and the harness's
comparison reads its numbers (the lower readings). For the first
``--control-seeds`` seeds the control, the reference computed in
bfloat16 (the precision below the configuration's float32), answers the
same requests in the program's place, and the same comparison reads its
numbers (the upper readings). The window checks as many requests as a
run of ``run_seconds`` does. The benchmark's runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


class _Hit:
    __slots__ = ("id", "score")

    def __init__(self, i, s):
        self.id, self.score = i, s


class _Result:
    __slots__ = ("data", "num_hits")

    def __init__(self, answer):
        self.data = [_Hit(int(i), float(s)) for i, s in zip(answer.ids, answer.scores)]
        self.num_hits = answer.num_hits


def control_answerer(reference):
    """The control in the program's place: each unit answered by ``reference``."""
    return lambda unit: [_Result(reference.answer(d)) for d in unit]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from benchmark.harness import check, program, spec, traffic, window
    from benchmark.reference.index import ReferenceIndex
    from benchmark.reference.search import Reference

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [spec.load_cell(w["name"]) for w in bench["workloads"] if w["config"] == args.config]
    config = cells[0].config
    corpus = spec.corpus_module(config)
    kept = config.get("index", "built") == "kept"
    limit = config["limits"]["score_rel_gap"]
    out = {"config": args.config, "seconds": args.seconds, "readings": []}
    setup = ref_index = None
    for n, seed in enumerate(args.seeds):
        if setup is None or not kept:
            if setup is not None:
                setup.close()
            setup = program.set_up(config, corpus, seed, args.device)
            ref_index = None
        if ref_index is None or not kept:
            ref_index = ReferenceIndex(corpus.ndjson(config["corpus"], seed), config.get("index_config") or {},
                                       fields={f for cell in cells for f in cell.traffic["fields"]})
        words = corpus.words(config["corpus"], seed)
        for cell in cells:
            share = min(1.0, float(cell.traffic.get("check_share", 1.0)) * bench["run_seconds"] / args.seconds)
            mask = traffic.check_mask(seed, share)
            answer = window.answerer(setup.vt, setup.index, cell.traffic["loop"])
            warm = traffic.Stream(cell.traffic, words, seed, traffic.WARMUP)
            for _ in range(int(cell.traffic.get("warmup_units", 1))):
                answer(warm.next_unit())
            with window.GcClock() as clock:
                w = window.run(answer, traffic.Stream(cell.traffic, words, seed), args.seconds, mask, clock)
            t = time.perf_counter()
            row = {"cell": cell.name, "seed": seed, "answered": w.answered,
                   "program": check.compare(w.checked, Reference(ref_index), w.failed, limit)}
            ref_s = time.perf_counter() - t
            if n < args.control_seeds:
                control = control_answerer(Reference(ref_index, "bfloat16"))
                answers = [(r, *window.summary(control([r])[0])) for r, _i, _s, _h in w.checked]
                row["control"] = check.compare(answers, Reference(ref_index), 0, limit)
            row["reference_s"] = ref_s
            out["readings"].append(row)
            flat = {k: {side: row[side][k]["value"] for side in ("program", "control") if side in row}
                    for k in row["program"]}
            print(json.dumps({"cell": cell.name, "seed": seed, "answered": w.answered,
                              "reference_s": round(ref_s, 2), **flat}), flush=True)
    if setup is not None:
        setup.close()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"readings done in {time.perf_counter() - T0:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
