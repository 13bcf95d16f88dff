#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (veloci_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure is an exception and a non-zero exit):

1. card   -- require CUDA; print the card's name and power limit.
2. build  -- compile every ``veloci_tpu_torch/csrc/*.cu`` with nvcc, all at
             once; print the seconds and nvcc's register/spill report.
3. kernel -- each Levenshtein sweep kernel against its plain PyTorch version
             on the card: the banded one at band 2 and 4 and the full-width
             one, Q = 1, 64 and 256, on the slice's field dictionary and on a
             synthetic 1,000,000-term dictionary; all three outputs must be
             equal (tolerance: exact, the outputs are integers). Median ms of
             each, CUDA events.
4. slice  -- a jmdict-shaped 200,000-document corpus (the generator of
             bench.py's build_corpus, seed 1234) is built with the reused
             host builder, saved, read back by the port's reader and uploaded.
             Two main paths through ``search_batch``: single leaves (batches
             of 256 exact, ~1 and ~2 requests, and single fuzzy requests),
             then query trees (batches of 256 query-string requests from the
             query generator -- two or three zipf words, some of them ``*``
             wildcards, each pair joined by AND or OR -- and of 256 explicit AND-of-ORs
             fuzzy requests). Each path runs with the kernels' launch
             counters set to 0 just before it and read just after; each
             kernel the path needs must have launched. Answers are checked for shape and
             order, and requests are answered again on the CPU through the
             plain versions from the same index: ids, order, num_hits and f32
             score bits must be identical.
5. profile -- one batch of each mix under torch.profiler: the device's busy
             share of the batch's wall time and its largest kernels.
"""

from __future__ import annotations

import gc
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
N_DOCS = 200_000
BATCH = 256
TIMED_BATCHES = 16  # per mix
CPU_CHECKED_BATCHES = 4  # per single-leaf mix, re-answered on the CPU
CPU_CHECKED_TREE_BATCHES = 1  # per tree mix (their CPU sweeps are full-width)
SINGLES = 32  # one-request batches (single-query sweep entry point)
SYNTH_TERMS = 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- corpus
def build_corpus(n_docs: int):
    """bench.py's build_corpus: zipfian 40k vocabulary, 3-9-token titles."""
    rng = np.random.default_rng(1234)
    vocab_size = 40_000
    vocab = np.array(
        [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(vocab_size)]
    )
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    lengths = rng.integers(3, 10, size=n_docs)
    total_words = int(lengths.sum())
    words = rng.choice(vocab, size=total_words, p=probs)
    pops = rng.integers(1, 1000, size=n_docs)
    out = []
    pos = 0
    for i in range(n_docs):
        ln = lengths[i]
        title = " ".join(words[pos : pos + ln])
        pos += ln
        out.append(
            '{"title": "%s", "ent_seq": "%d", "cat": "c%d", "pop": %d}'
            % (title, i, i % 16, pops[i])
        )
    return "\n".join(out), vocab, probs


BENCH_CONFIG = """
["*GLOBAL*"]
features = ["All"]
["cat"]
facet = true
["pop".boost]
boost_type = "f32"
"""


def mutate(word: str, edits: int, rng) -> str:
    """``edits`` random substitutions / insertions / deletions."""
    w = list(word)
    for _ in range(edits):
        op = int(rng.integers(3))
        ch = "abcdefgh0123456789"[int(rng.integers(18))]
        if op == 1:
            w.insert(int(rng.integers(len(w) + 1)), ch)
        elif op == 0 or len(w) <= 2:
            w[int(rng.integers(len(w)))] = ch
        else:
            del w[int(rng.integers(len(w)))]
    return "".join(w)


def request_mixes(vocab, probs, rng, fields):
    """Per mix, TIMED_BATCHES batches of BATCH requests, each a request dict
    or a query string for the generator; terms drawn with the corpus's own
    zipfian weights."""
    mixes = {}
    for name, edits in (("exact", 0), ("fuzzy_d1", 1), ("fuzzy_d2", 2)):
        batches = []
        for _ in range(TIMED_BATCHES):
            batch = []
            for w in rng.choice(vocab, size=BATCH, p=probs):
                leaf = {"terms": [mutate(str(w), edits, rng)], "path": "title"}
                if edits:
                    leaf["levenshtein_distance"] = edits
                batch.append({"search_req": {"search": leaf}, "top": 10})
            batches.append(batch)
        mixes[name] = batches
    # the server's folded `search?query=` requests: 2-3 words, about one in
    # three a wildcard of its first 4-6 chars, words joined by AND or by a
    # space (OR) half the time each: "a AND b c" is an OR of an AND
    batches = []
    for _ in range(TIMED_BATCHES):
        batch = []
        for _q in range(BATCH):
            words = [str(w) for w in rng.choice(vocab, size=int(rng.integers(2, 4)), p=probs)]
            words = [w[: int(rng.integers(4, 7))] + "*" if rng.random() < 1 / 3 else w for w in words]
            query = words[0]
            for w in words[1:]:
                query += (" AND " if rng.random() < 0.5 else " ") + w
            batch.append(query)
        batches.append(batch)
    mixes["query_string"] = batches
    # explicit AND of two per-word ORs over every searchable field, d 1-2
    batches = []
    for _ in range(TIMED_BATCHES):
        batch = []
        for _q in range(BATCH):
            groups = []
            for w in rng.choice(vocab, size=2, p=probs):
                d = int(rng.integers(1, 3))
                groups.append({"or": {"queries": [
                    {"search": {"terms": [str(w)], "path": f, "levenshtein_distance": d}}
                    for f in fields
                ]}})
            batch.append({"search_req": {"and": {"queries": groups}}, "top": 10})
        batches.append(batch)
    mixes["and_of_ors_fuzzy"] = batches
    return mixes


# ---------------------------------------------------------------- timing
def time_ms(fn, warmup: int = 2, iters: int = 5, reps: int = 5) -> float:
    """Median per-call ms over ``reps`` runs of ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


# ---------------------------------------------------------------- phases
def kernel_phase(sweep, encode_query, dictionaries, rng, report):
    """Kernel vs plain on the card at every shape; exact equality."""
    err = {"batch": 0, "single": 0, "full": 0}
    times = {}
    for dname, (chars_t, lens, words) in dictionaries.items():
        n = chars_t.shape[1]
        for q in (1, 64, 256):
            picked = rng.choice(words, size=q)
            enc = [encode_query(mutate(str(w), int(rng.integers(3)), rng)) for w in picked]
            queries = torch.from_numpy(np.stack([e[0] for e in enc])).cuda()
            qlens = torch.tensor([e[1] for e in enc], dtype=torch.int32, device="cuda")
            for band in (2, 4, None):
                if band is None:
                    def kern():
                        return sweep.levenshtein_sweep_full_batch(chars_t, lens, queries, qlens)

                    def plain():
                        return sweep.levenshtein_sweep_full_batch_plain(chars_t, lens, queries, qlens)
                    entry = "full"
                else:
                    if q == 1:
                        def kern():
                            return sweep.levenshtein_sweep_banded(
                                chars_t, lens, queries[0], qlens, band=band
                            )
                        entry = "single"
                    else:
                        def kern():
                            return sweep.levenshtein_sweep_banded_batch(
                                chars_t, lens, queries, qlens, band=band
                            )
                        entry = "batch"

                    def plain():
                        return sweep.levenshtein_sweep_banded_batch_plain(
                            chars_t, lens, queries, qlens, band=band
                        )

                got, want = kern(), plain()
                torch.cuda.synchronize()
                if entry == "single":
                    want = tuple(w[0] for w in want)
                for g, w in zip(got, want):
                    if g.shape != w.shape or not torch.equal(g, w):
                        raise AssertionError(
                            f"sweep kernel != plain: {dname} N={n} Q={q} {entry} band={band}"
                        )
                e = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max()) if g.numel() else 0
                        for g, w in zip(got, want))
                err[entry] = max(err[entry], e)
                big = n * q > 16_000_000
                k_ms = time_ms(kern, iters=3 if big else 10)
                p_ms = time_ms(plain, warmup=1, iters=1, reps=3 if big else 5)
                times[(dname, q, band)] = (k_ms, p_ms)
                row = dict(dictionary=dname, terms=n, queries=q, band=band, entry=entry,
                           equal=True, kernel_ms=k_ms, plain_ms=p_ms)
                report["kernel_rows"].append(row)
                log(f"kernel {dname:>9} N={n:>8} Q={q:>3} {'band=' + str(band) if band else 'full  '} "
                    f"{entry:>6}: equal, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
    return err, times


def profile_phase(vt, index, requests_of, make, report):
    """One batch of each mix under torch.profiler: the share of the wall
    time the device was busy, and the kernels that took it (the profiler's
    own overhead inflates the wall time, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, batches in requests_of.items():
        reqs = [make(d, index) for d in batches[1]]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vt.search_batch(reqs, index)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an operator's own row repeats its kernels' time
        dev = [
            (e.self_device_time_total, e.key[:60]) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA
        ]
        busy_us = sum(t for t, _k in dev)
        top = [(k, round(t, 1)) for t, k in sorted(dev, reverse=True)[:4] if t > 0]
        report["slice"].setdefault("profile", {})[name] = dict(
            wall_us=wall_us, device_busy_us=busy_us, top_device_us=top
        )
        share = f"{100 * busy_us / wall_us:.1f}%" if busy_us else "not measured"
        log(f"profile {name:>16}: wall {wall_us / 1e3:.3f} ms, device busy {share}; "
            f"top device time (us): {top}")


def check_result(res, req):
    top = req["top"] if isinstance(req, dict) else 10
    assert 0 <= len(res.data) <= top and res.num_hits >= len(res.data), res
    scores = np.array([h.score for h in res.data], dtype=np.float64)
    ids = np.array([h.id for h in res.data], dtype=np.int64)
    assert np.all(np.isfinite(scores)) and np.all(scores > 0), res
    order = np.lexsort((-ids, -scores))
    assert np.array_equal(order, np.arange(len(ids))), res  # (score desc, id desc)
    assert np.all((ids >= 0) & (ids < N_DOCS)), res


def result_key(res):
    return res.num_hits, [(h.id, np.float32(h.score).view(np.int32).item()) for h in res.data]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    os.environ.setdefault("VELOCI_NATIVE_CACHE", str(ROOT / "build" / "native"))
    sys.path.insert(0, str(ROOT))
    import veloci_tpu_torch as vt
    from veloci_tpu_torch import _host
    from veloci_tpu_torch.ops import _build
    from veloci_tpu_torch.ops import levenshtein, levenshtein_sweep

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    report = {"card": card, "kind": kind, "kernel_rows": [], "slice": {}}
    rng = np.random.default_rng(2024)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} CUDA source(s) in {build_s:.2f} s")
    for src, lib in libs.items():
        ptxas = Path(f"{lib}.ptxas.txt")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {src}: {line.strip()}")
    report["build_s"] = build_s

    # ---- corpus, index build, save, read + upload
    t0 = time.perf_counter()
    data, vocab, probs = build_corpus(N_DOCS)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pers = _host.persistence.Persistence.from_built(
        _host.create.create_indices_from_str(data, BENCH_CONFIG)
    )
    index_build_s = time.perf_counter() - t0
    index_dir = ROOT / "build" / "smoke_index"
    t0 = time.perf_counter()
    pers.save(str(index_dir))
    save_s = time.perf_counter() - t0
    del pers, data
    t0 = time.perf_counter()
    index = vt.load_index(str(index_dir), "cuda")
    torch.cuda.synchronize()
    load_upload_s = time.perf_counter() - t0
    title = index.fields["title"]
    log(f"slice: {N_DOCS} docs, generated in {gen_s:.2f} s, index built in "
        f"{index_build_s:.2f} s, saved in {save_s:.2f} s, read + uploaded in "
        f"{load_upload_s:.2f} s; title dictionary {title.chars_t.shape[1]} sweep rows, "
        f"{index.packed.shape[0]} postings")
    report["slice"].update(gen_s=gen_s, index_build_s=index_build_s, save_s=save_s,
                           load_upload_s=load_upload_s,
                           title_sweep_rows=int(title.chars_t.shape[1]),
                           postings=int(index.packed.shape[0]))

    # ---- kernel phase
    synth_rng = np.random.default_rng(99)
    s_lens = synth_rng.integers(1, 33, size=SYNTH_TERMS).astype(np.int32)
    s_lens[synth_rng.random(SYNTH_TERMS) < 0.01] = 0  # pad / long-term rows
    s_chars = synth_rng.integers(97, 123, size=(32, SYNTH_TERMS)).astype(np.uint16)
    s_chars[np.arange(32)[:, None] >= s_lens[None, :]] = 0
    s_words = ["".join(chr(c) for c in s_chars[: s_lens[i], i]) or "a"
               for i in synth_rng.integers(0, SYNTH_TERMS, 2000)]
    title_words = index.get_dictionary("title").terms
    dictionaries = {
        "title": (title.chars_t, title.lengths, np.array(title_words[:: max(1, len(title_words) // 5000)])),
        "synthetic": (torch.from_numpy(s_chars).cuda(), torch.from_numpy(s_lens).cuda(),
                      np.array(s_words)),
    }
    kernel_err, kernel_times = kernel_phase(
        levenshtein_sweep, levenshtein.encode_query, dictionaries, rng, report
    )
    del dictionaries
    torch.cuda.empty_cache()

    # ---- main path
    mixes = request_mixes(vocab, probs, rng, sorted(index.key_base))
    singles = [
        {"search_req": {"search": {"terms": [mutate(str(w), 2, rng)], "path": "title",
                                   "levenshtein_distance": 2}}, "top": 10}
        for w in rng.choice(vocab, size=SINGLES, p=probs)
    ]

    def make(spec, idx):
        """A request dict, or a query string through the query generator."""
        if isinstance(spec, str):
            return vt.search_query(idx, vt.SearchQueryGeneratorParameters(search_term=spec))
        return vt.Request.from_dict(spec)

    for name, batches in mixes.items():  # warm-up: first-touch allocations
        vt.search_batch([make(d, index) for d in batches[0]], index)
    vt.search_batch([make(singles[0], index)], index)
    torch.cuda.synchronize()

    gc_full_ms = []  # full (generation 2) garbage collections during the main path
    gc_start = [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        elif info["generation"] == 2:
            gc_full_ms.append((time.perf_counter() - gc_start[0]) * 1e3)

    kernel_fns = {
        name: getattr(levenshtein_sweep, name)
        for name in ("levenshtein_sweep_banded_batch", "levenshtein_sweep_banded",
                     "levenshtein_sweep_full_batch")
    }
    requests_of = dict(mixes, single_fuzzy_d2=[[d] for d in singles])
    # the main paths, each with the kernels it must launch: the single-leaf
    # requests, then the query-string trees
    paths = (
        ("single_leaf", ("exact", "fuzzy_d1", "fuzzy_d2", "single_fuzzy_d2"),
         ("levenshtein_sweep_banded_batch", "levenshtein_sweep_banded")),
        ("query_trees", ("query_string", "and_of_ors_fuzzy"),
         ("levenshtein_sweep_banded_batch", "levenshtein_sweep_full_batch")),
    )
    answers = {}
    lat = {}
    rows_per_batch = {}  # posting rows gathered per batch, by mix
    path_launches = {}
    gc.callbacks.append(on_gc)
    for path, names, needed in paths:
        for fn in kernel_fns.values():
            fn.launches = 0
        for name in names:
            lat[name], answers[name], rows_per_batch[name] = [], [], []
            for batch in requests_of[name]:
                reqs = [make(d, index) for d in batch]
                rows0 = sum(index.gathered_rows.values())
                t0 = time.perf_counter()
                res = vt.search_batch(reqs, index)
                lat[name].append(time.perf_counter() - t0)
                rows_per_batch[name].append(sum(index.gathered_rows.values()) - rows0)
                answers[name].append(res)
        torch.cuda.synchronize()
        path_launches[path] = {name: fn.launches for name, fn in kernel_fns.items()}
        log(f"main path {path} launches: {path_launches[path]}")
        for k in needed:
            if path_launches[path][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by the main path {path}")
    gc.callbacks.remove(on_gc)
    launches = {k: sum(p[k] for p in path_launches.values()) for k in kernel_fns}
    log(f"main path launches: {launches}; routes: {dict(index.path_counts)}")
    log(f"main path: {len(gc_full_ms)} full garbage collections, "
        f"ms each: {[round(t, 1) for t in gc_full_ms]}")
    for name, rows in rows_per_batch.items():
        log(f"rows gathered per batch {name:>16}: median {int(np.median(rows))}, "
            f"max {max(rows)}")
    report["slice"]["gc_full_ms"] = gc_full_ms
    report["slice"]["rows_per_batch"] = rows_per_batch
    report["slice"]["path_launches"] = path_launches

    # ---- checks: shape and order, then the CPU plain path on the same index
    hits = 0
    for name, results in answers.items():
        for batch, res in zip(requests_of[name], results):
            assert len(res) == len(batch)
            for r, d in zip(res, batch):
                check_result(r, d)
                hits += bool(r.data)
    if hits < len(singles):
        raise AssertionError(f"only {hits} requests found anything")
    cpu_index = vt.load_index(str(index_dir), "cpu")
    checked = 0
    for name, results in answers.items():
        if name not in mixes:
            n_check = len(results)
        elif name in ("query_string", "and_of_ors_fuzzy"):
            n_check = CPU_CHECKED_TREE_BATCHES
        else:
            n_check = CPU_CHECKED_BATCHES
        t0 = time.perf_counter()
        for batch, res in list(zip(requests_of[name], results))[:n_check]:
            cpu = vt.search_batch([make(d, cpu_index) for d in batch], cpu_index)
            for a, b, d in zip(res, cpu, batch):
                if result_key(a) != result_key(b):
                    raise AssertionError(f"GPU != CPU plain path for {d}")
            checked += len(batch)
        log(f"checked on the CPU: {name}, {n_check} batch(es) in {time.perf_counter() - t0:.1f} s")
    log(f"checked: every answer finite, <= top, (score desc, id desc); {checked} "
        f"requests identical to the CPU plain path")

    for name, samples in lat.items():
        n_req = 1 if name.startswith("single") else BATCH
        ms = np.array(samples) * 1e3
        row = dict(batch=n_req, batches=len(ms), p50_ms=float(np.percentile(ms, 50)),
                   p99_ms=float(np.percentile(ms, 99)),
                   qps=n_req * len(ms) / float(ms.sum() / 1e3), samples_ms=ms.tolist())
        report["slice"][name] = row
        log(f"slice {name:>16}: batch {n_req:>3} x {len(ms)}: p50 {row['p50_ms']:.3f} ms, "
            f"p99 {row['p99_ms']:.3f} ms, {row['qps']:.1f} QPS")

    profile_phase(vt, index, requests_of, make, report)

    main_shape = ("title", 256, 2)
    kernels = [
        {"name": "levenshtein_sweep_banded_batch", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/banded_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:341",
         "launches": launches["levenshtein_sweep_banded_batch"],
         "max_abs_err": kernel_err["batch"],
         "ms": kernel_times[main_shape][0], "plain_ms": kernel_times[main_shape][1]},
        {"name": "levenshtein_sweep_banded", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/banded_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:412",
         "launches": launches["levenshtein_sweep_banded"],
         "max_abs_err": kernel_err["single"],
         "ms": kernel_times[("title", 1, 2)][0], "plain_ms": kernel_times[("title", 1, 2)][1]},
        {"name": "levenshtein_sweep_full_batch", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/full_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:72",
         "launches": launches["levenshtein_sweep_full_batch"],
         "max_abs_err": kernel_err["full"],
         "ms": kernel_times[("title", 256, None)][0], "plain_ms": kernel_times[("title", 256, None)][1]},
    ]
    report["kernels"] = kernels
    report["launches"] = launches
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
