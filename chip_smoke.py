#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (veloci_tpu_torch) on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py [--compare-full OLD_full_levenshtein.cu] [--compare-regex TREE]

``--compare-full`` builds another version of the full-width kernel's source
(the same C entry point) and times it against the tree's in turns (old,
new, new, old) at every full-width shape below, outputs required equal.
``--compare-regex`` takes another tree (a directory holding
``veloci_tpu_torch/`` and ``native/``, such as a ``git archive`` of a
commit with the same index format): after the main paths, child processes
load the saved index with that tree's package and with this one's and
answer the ``regex`` mix, in REGEX_AB_ROUNDS rounds of (other, this, this,
other); each child's p50 / p99 and B8 launches, then each tree's median p50.

Phases (any failure is an exception and a non-zero exit):

1. card   -- require CUDA; print the card's name and power limit.
2. build  -- compile every ``veloci_tpu_torch/csrc/*.cu`` with nvcc, all at
             once; print the seconds and nvcc's register/spill report.
3. kernel -- each Levenshtein sweep kernel against its plain PyTorch version
             on the card: the banded one at band 2 and 4 and the full-width
             one, Q = 1, 64 and 256, on the slice's field dictionary and on a
             synthetic 1,000,000-term dictionary, and on an edge-case set
             (code points above 255 and colliding in their low 8 bits,
             queries of 0-33 chars, empty and 32-char terms); all three
             outputs must be equal (tolerance: exact, the outputs are
             integers). Median ms of each, CUDA events, beside the bound:
             the larger of the bytes moved over 3.35 TB/s and the integer
             operations over the card's INT32 rate.
4. slice  -- a jmdict-shaped 200,000-document corpus (the package's copy
             of bench.py's build_corpus, ``veloci_tpu_torch.synthetic``,
             seed 1234) is built with the port's
             index build and native indexer, saved, read back and uploaded;
             ``TorchIndex.warmup`` runs once (its seconds and breakdown
             printed).
             Three main paths through ``search_batch``, then one through
             ``search`` (below, ``executor``): single leaves
             (batches of 256 exact, ~1 and ~2 requests, and single fuzzy
             requests), then query trees (batches of 256 query-string
             requests from the query generator -- two or three zipf words,
             some of them ``*`` wildcards, each pair joined by AND or OR --
             and of 256 explicit AND-of-ORs fuzzy requests), then the
             ``generic`` mix (batches of 256 generator requests with facets
             on cat, phrase boosts, a Log10 popularity boost and, on half of
             them, a filter on one or two cat values). Each path runs with
             the kernels' launch counters set to 0 just before it and read
             just after; each kernel the path needs must have launched. Every full-width
             launch of the query_string mix is logged (field, N, Q, mean
             query length), and the kernel is checked and timed again on
             each field's launch at its median Q, on its own inputs. Answers are checked for shape and
             order, and requests are answered again on the CPU through the
             plain versions from the same index: ids, order, num_hits, f32
             score bits and facet lists must be identical.
             Right after the single-leaf path, the ``baselines`` path (no
             kernel of its own): the native single-core CPU baselines of
             ``veloci_tpu_torch.native`` (``native/baseline.cpp``, built
             with g++; a failed build fails the run) on the saved index's
             ``title`` host arrays, on the first batch of 256 of the exact,
             ``~1`` and ``~2`` mixes: the exact batch through
             ``baseline_exact_topk`` and ``baseline_exact_topk_vint`` (whose
             outputs must be bit-equal), the fuzzy batches through
             ``baseline_fuzzy_topk`` (distance clamped to the term's length
             - 1). Each of the 1,024 answers must equal the card's
             ``search_batch`` answer for the same request: ids up to 10 in
             order, num_hits, scores within 1e-5 relative. Then 5
             interleaved runs of each baseline and of the card's batch of
             the same requests: requests/s, median and spread, the
             baselines labelled with the host CPU's model name, the card's
             with its name and power limit; and the path's seconds.
             The fourth main path, ``executor``, sends lone requests through
             ``search``, 256 of each mix, timed one by one: ``deep_tree``
             (trees of three and four levels over zipf words, one ``~1``
             leaf each, a third with a ``starts_with`` ``~1`` leaf; most
             beyond the batched route's shapes), ``multi_term`` (one title
             leaf of 2-4 terms, half ``~1``) and ``generic_dense`` (the
             ``generic`` mix's first batch with ``dense_only``: filters,
             the Log10 boost, facets and phrase boosts on the dense
             executor). It must launch the dense resolve (B7) and the
             fused lone-request select (B2), and every answer is checked
             against the CPU plain path. The executor keeps no memo of
             field searches, so requests are not answered from a cache
             (filter masks and boost factors are cached per index, as on
             the batched route).
             The fifth main path, ``regex``, is the server's
             ``search?query=*foo*`` traffic, code and substring search:
             256 lone query strings through ``search`` (seed 8, zipf
             words): a third ``*<3-4 middle chars>*``, a third ``<first 2
             chars>*<last 2 chars>``, a third ``*<last 3 chars>``, half
             of them with a second plain word; each leaf expands over
             title, ent_seq, cat and pop. Each request's top 10 is read
             back with ``search_to_result_with_doc``, half with ``select``
             title and cat, half whole documents. It must launch the DFA
             walk (B8's two-matrix entry ``regex_match_pair``) once a regex
             leaf, over both matrices of its field (the sweep rows and the
             long terms) where the field has any row, and B7; the
             host-scan count must be 0. The DFA cache's hits and misses
             (``cached_dfa``: a miss compiles a pattern) are printed. p50 and p99 of a request
             and of its document read, host clock. Every answer and its
             documents are checked against the CPU plain path.
             The sixth main path, ``features``, on the same index: 256
             lone ``boost_term`` requests through ``search`` (seed 9: a
             title word, every other at ``~1``, with three boost_term
             parts, a title word at boost 2.0, a title word at ``~1`` at
             boost 3.0 and a cat value at boost 1.5; the term-boost
             cache's hits and misses are printed), 256 lone ``text_locality`` requests (seed 10: an OR
             of 2-3 title words), one ``search_batch`` of 256 generator
             requests with ``why_found`` (seed 11: 2-3 words, every other
             with ``select`` title and cat; each top 10 read back), and
             one ``suggest_batch`` of 256 prefixes of 2-5 chars on title
             (seed 12: two in three canonical requests at distance 0, the
             vectorised path; one in three from ``suggest_query`` at
             distance 1, the general path). It must launch B7, the fused
             select, the banded batch sweep and the full-width sweep
             (the suggest parts at ``~1`` match term prefixes). p50 and
             p99 of each mix and of the why_found document reads; every
             answer, its why_found metadata, its documents and every
             suggestion list are checked against the CPU plain path.
             The seventh main path, ``server``: the port's server on the
             saved index in a child process (``python -m
             veloci_tpu_torch.cli serve smoke_index --device cuda`` on a
             free loopback port; its exit, or no answer within
             SERVER_START_S, fails the run; it is stopped at the end of
             the phase), over HTTP: the ``query_string`` mix's first 256
             strings as ``GET /search?query=`` one at a time and then from
             32 client threads at once (the server folds them into
             batches; ``GET /stats`` before and after gives the fold
             counts), the ``generic`` mix's first 256 requests as one
             ``POST /search_batch``, the suggest mix's 256 prefixes as
             ``GET /suggest`` from 32 threads, 64 ``deep_tree`` requests
             with ``explain`` and ``select`` title as ``POST /search``, 16
             ``POST /search_query_params/explain_plan`` of ``generic``
             requests, and ``GET /_id`` and ``/_idtree`` of the top hits of
             32 of the sequential answers. p50 / p99 of each, client clock;
             wall and requests/s of the bursts; the child's load and
             warmup seconds (its ``database ...`` line). Every body
             (without ``execution_time_ns``) must equal the direct call on
             this process's index on the card, and the explained ones the
             CPU plain path's. Then the same traffic against an in-process
             server on this process's index, the launch counters set to 0
             just before and read just after (the path's launches: B1, the
             fused select, B3 and B7 must launch); its concurrent search
             burst is profiled in phase 8.
             Between the server and mesh paths, the ``api`` path: the
             JAX package's own call on the port. The saved index read
             back as a ``Persistence``, no device named in any call: the
             ``query_string`` mix's first 256 strings one by one through
             ``vt.search(req, pers)``, one ``vt.search_batch`` of them,
             ``search_to_result_with_doc``, ``suggest`` and
             ``explain_plan`` once each, the launch counters set to 0 just
             before and read just after (B1, the fused select and B3 must
             launch); the Persistence must upload exactly once, onto the
             card (the default device), and every answer must be bit-equal
             to the loaded TorchIndex's on the same requests. The first
             call's seconds (the upload), and the lone p50 / p99 of the
             other 255 beside the TorchIndex's on them. Then ``python -m
             veloci_tpu_torch.cli test_large_search --num-docs 100000`` in
             a child process on the card with ``VELOCI_LOG=info``: one
             ``search took`` line a search, six in all.
             The eighth main path, ``mesh``: the index attached to a mesh
             of 8 document shards (25,000 documents each), every shard on
             the one card (``MeshContext``; and a [2, 4] [q, d] mesh for
             one batch), so it measures the per-shard work and the merges,
             not collectives across cards. The reference's multichip
             battery's seven shapes (seed 13, zipf words, the ``cat`` facet
             and the ``pop`` Log10 boost): a single term; an OR of two
             terms with a cat filter, the boost and the facet; a term at
             ``~1``; an AND of two words of one document's title; a term
             under a filter of half the documents (8 of the 16 cat
             values); a term at ``~1`` with a cat filter and the boost; an
             OR of two such ANDs and a term. 32 of each alone through
             ``search``, then one ``search_batch`` of 256 of them, on the
             unsharded index, then with the launch counters set to 0 on
             the 8-shard mesh (with a regex, a ``boost_term`` and a
             ``text_locality`` request, which ride the mesh's per-request
             executor) and on the [2, 4] mesh; every mesh answer must
             equal the unsharded one (ids, order, num_hits, facets, f32
             score bits), and B7 and the fused select must launch. p50 /
             p99 of each shape on both, the batches' wall times; B7 and
             the fused select then checked bit for bit against their plain
             versions on each shard's shapes (B7 at the path's single term
             with the most rows in shard 0, the select over each shard's
             length window), with their times and bounds; the path's lone
             requests and its batch under the profiler in phase 8. The
             kernels line gives each kernel's launches on this path
             (``mesh_launches``).
5. dense   -- kernel B7 (``csrc/dense_resolve.cu``), its direct path and
             its keys path, each against its plain version on the card,
             bit-equal, at the main path's largest multi-term leaf (its
             recorded inputs) and on a synthetic 6,000,000-document plane
             with 2^23 gathered rows; per path the call's ms (CUDA events)
             and, in phase 7, its device time and the scatter kernel's
             alone (profiler events); ms of the plain version and of one
             ``scatter_reduce_`` "amax" over the gathered rows, beside the
             bound: 8 bytes a gathered row read and 4 a document written,
             over 3.35 TB/s; and the leaf resolve from host arrays
             (``resolve_to_anchor_dense``, its one upload included).
6. regex   -- kernel B8 (``csrc/regex_dfa.cu``) against its plain walk on
             the card, bit for bit, in full and prefix mode, with the main
             path's first pattern of each kind: on the title field's sweep
             rows (u16, transposed) and long rows (int32 codes, row-major),
             on ent_seq's sweep rows, on a synthetic 1,000,000-term
             dictionary, on an edge set (the empty term, terms of 32, 33
             and 254 chars and longer, non-ASCII terms, the four code
             points re folds onto ASCII, patterns with \\w and with a dead
             state) in both layouts, on rows that mix ASCII and non-ASCII
             chars in every warp, and on long rows of unequal lengths in
             every warp; and the two-matrix entry ``regex_match_pair``
             against its plain version on each field's sweep and long rows
             and on the edge sets. Per shape the kernel's median ms (CUDA
             events; with the DFA's kernel argument built, and again with a
             new copy of the DFA each call, which builds it, as a pattern
             not yet cached does), the plain walk's, and the bound: 4 bytes a row for
             its length, 2 a char walked of a u16 row or 4 of an int32 row,
             1 a row written, over 3.35 TB/s, against ceil(log2 C) + 2
             integer operations a char step; chars walked counted on this
             run's data (a row stops at its length, the dead state, or its
             first prefix accept); the pair's bound the sum of its two
             matrices'. The kernel alone by profiler events in phase 8. B7 is checked again at the regex path's largest leaf,
             which takes its unstaged path (more than 1,024 terms).
7. select  -- the fused lone-request select (B2, ``levenshtein_select_banded``)
             against its plain twin on the card, equal, on every fuzzy spec
             the lone ``~2`` and executor mixes sent it, and at title x 1
             for every distance up to bands 2 and 4; at title x 1, band 2,
             d 2: the whole single-item ``_select`` call, fused and by the
             sweep path it replaced (the single-query sweep,
             ``select_matches`` and four readbacks), host clock, in turns; the fused kernel alone
             (profiler events, in phase 7), its plain twin, and its bound: 64 + 4
             bytes a term read and 12 a match written, 3 operations a band
             cell for the terms that pass the length test.
   B10     -- the ``boost_term`` factor (plain PyTorch) at the boost_term
             mix's first request, its parts' anchors cached: ms (CUDA
             events) beside its bound (8 bytes an anchor, 4 a document's
             factor); its device time in phase 8.
8. profile -- every profiler measurement, after every timing above (once
             the profiler has run, launches in the process take longer):
             B7's, B8's and the fused select's device times; one batch of
             each mix (32 lone requests of each executor mix, of the
             regex mix and of the lone feature mixes; the why_found and
             the suggest batch; the server path's concurrent search
             burst, sent to the in-process server) under torch.profiler:
             the device's busy share of the
             wall time and its largest kernels; and the single-query banded
             launch (B2's old entry) timed by its kernel's own device
             events, beside its CUDA-event time.
"""

from __future__ import annotations

import argparse
import ctypes
import gc
import hashlib
import json
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
EXECUTOR_REQUESTS = 256  # lone requests per executor mix
PROFILED_EXECUTOR_REQUESTS = 32
REGEX_REQUESTS = 256  # lone code-search requests of the regex path
REGEX_SELECT = ["title", "cat"]  # the select of half of them; the rest read whole documents
REGEX_SYNTH_TERMS = 1_000_000
FEATURE_REQUESTS = 256  # requests per mix of the features path
FEATURE_SELECT = ["title", "cat"]  # the select of half the why_found requests
DENSE_SYNTH_DOCS = 6_000_000  # B7's synthetic plane: past the reference's 2^21 sort capacity
DENSE_SYNTH_ROWS = 1 << 23
DENSE_SYNTH_TERMS = 64
REGEX_AB_ROUNDS = 3  # --compare-regex: rounds of (other tree, this tree, this tree, other tree)

# Peak rates of one H100 SXM at its 700 W limit: HBM3 at 3.35 TB/s; INT32
# instructions at 132 SMs x 64 INT32 lanes x 1.98 GHz (NVIDIA's data sheet
# and Hopper white paper). The sweeps are integer work: no tensor-core or
# float rate applies.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# banded DP cell: a compare and two fused add-mins (Hopper's DPX
# instructions); counting five (two adds and two mins apart) put the bound
# above the measured time
BAND_CELL_OPS = 3
BITPARALLEL_STEP_OPS = 16  # one bit-parallel step (Hyyro) per term char


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A line of the run's log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- corpus
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
    # the server's `search?query=...&facets=cat&filter=...` front end with a
    # popularity boost: query-string words as above, one word in four with
    # ~1, facets on cat, phrase boosts, and a filter on one or two cat
    # values on half of the requests (its own seed: the other mixes keep
    # their requests)
    grng = np.random.default_rng(6)
    batches = []
    for _ in range(TIMED_BATCHES):
        batch = []
        for _q in range(BATCH):
            words = []
            for w in grng.choice(vocab, size=int(grng.integers(2, 4)), p=probs):
                w = str(w)
                if grng.random() < 1 / 3:
                    w = w[: int(grng.integers(4, 7))] + "*"
                elif grng.random() < 3 / 8:
                    w += "~1"
                words.append(w)
            query = words[0]
            for w in words[1:]:
                query += (" AND " if grng.random() < 0.5 else " ") + w
            params = {"search_term": query, "facets": ["cat"], "phrase_pairs": True,
                      "boost_queries": [{"path": "pop", "boost_fun": "Log10", "param": 1}]}
            if grng.random() < 0.5:
                cats = grng.choice(16, size=int(grng.integers(1, 3)), replace=False)
                params["filter"] = " OR ".join(f"cat:c{c}" for c in cats)
            batch.append({"generator": params})
        batches.append(batch)
    mixes["generic"] = batches
    return mixes


# the lone-request mixes: each request alone through vt.search, with or
# without dense_only (the executor mixes, and the regex mix)
DENSE_ONLY = {"deep_tree": False, "multi_term": False, "generic_dense": True, "regex": False,
              "boost_term": False, "text_locality": False}


def executor_mixes(vocab, probs, generic_batch):
    """EXECUTOR_REQUESTS lone requests per executor mix (their own seed).
    ``deep_tree``: four shapes in turn over zipf words, each with one ``~1``
    leaf and, on every third request, a ``starts_with`` ``~1`` leaf:
    AND(OR(AND(a, b~1), c), d), OR(AND(OR(a, b~1), c), d) (the one the
    batched deep route takes), AND(OR(AND(a, c), d), b~1) and
    OR(AND(OR(AND(a, b~1), c), d), e). ``multi_term``: one title leaf of 2-4
    zipf words, every other one at distance 1. ``generic_dense``: the
    ``generic`` mix's first batch."""
    erng = np.random.default_rng(7)

    def leaf(w, **kw):
        return {"search": dict({"terms": [w], "path": "title"}, **kw)}

    def node(kind, *queries):
        return {kind: {"queries": list(queries)}}

    deep, multi = [], []
    for i in range(EXECUTOR_REQUESTS):
        a, b, c, d, e = (str(w) for w in erng.choice(vocab, size=5, p=probs))
        fz = leaf(b, levenshtein_distance=1)
        if i % 3 == 0:
            c_leaf = leaf(c[: int(erng.integers(4, 7))], starts_with=True, levenshtein_distance=1)
        else:
            c_leaf = leaf(c)
        tree = (
            node("and", node("or", node("and", leaf(a), fz), c_leaf), leaf(d)),
            node("or", node("and", node("or", leaf(a), fz), c_leaf), leaf(d)),
            node("and", node("or", node("and", leaf(a), c_leaf), leaf(d)), fz),
            node("or", node("and", node("or", node("and", leaf(a), fz), c_leaf), leaf(d)), leaf(e)),
        )[i % 4]
        deep.append({"search_req": tree, "top": 10})
        words = [str(w) for w in erng.choice(vocab, size=int(erng.integers(2, 5)), p=probs)]
        multi_leaf = {"terms": words, "path": "title"}
        if i % 2:
            multi_leaf["levenshtein_distance"] = 1
        multi.append({"search_req": {"search": multi_leaf}, "top": 10})
    return {"deep_tree": deep, "multi_term": multi, "generic_dense": list(generic_batch)}


def regex_mix(vocab, probs):
    """REGEX_REQUESTS lone code-search query strings (seed 8) over zipf
    words: a third ``*<3-4 middle chars>*``, a third ``<first 2
    chars>*<last 2 chars>``, a third ``*<last 3 chars>``; every other
    triple adds a second plain zipf word; every other request reads back
    ``select`` REGEX_SELECT, the others whole documents."""
    rrng = np.random.default_rng(8)
    out = []
    for i in range(REGEX_REQUESTS):
        w = str(rrng.choice(vocab, p=probs))
        if i % 3 == 0:
            k = min(int(rrng.integers(3, 5)), len(w))
            start = int(rrng.integers(0, len(w) - k + 1))
            query = f"*{w[start:start + k]}*"
        elif i % 3 == 1:
            query = f"{w[:2]}*{w[-2:]}"
        else:
            query = f"*{w[-3:]}"
        if (i // 3) % 2 == 0:
            query += " " + str(rrng.choice(vocab, p=probs))
        out.append({"regex": query, "select": REGEX_SELECT if i % 2 else None})
    return out


# the features path's mixes: boost_term and text_locality lone requests
# through vt.search (the executor), why_found one search_batch, suggest one
# suggest_batch
FEATURE_LONE = ("boost_term", "text_locality")


def feature_mixes(vocab, probs):
    """FEATURE_REQUESTS requests per mix of the ``features`` path, zipf words.
    ``boost_term`` (seed 9): a title leaf of one word, every other at
    distance 1, with three ``boost_term`` parts: a title word at boost 2.0,
    a title word at distance 1 at boost 3.0, and a ``cat`` value at boost
    1.5. A part's matched ids resolve to anchors as text ids, so the title
    words, which are tokens of the titles, boost no anchor, in both
    packages; the ``cat`` part (a sixteenth of the documents) gives the
    factor its device work. ``text_locality`` (seed 10): an
    OR of 2-3 title words. ``why_found`` (seed 11): generator requests over
    2-3 words, every other with ``select`` FEATURE_SELECT. ``suggest`` (seed
    12): the first 2-5 chars of a word on title; two in three as the
    canonical suggest request at distance 0 (a part without ``top``, the
    vectorised prefix path), one in three through ``suggest_query`` at
    distance 1 (the general path; the generator sets each part's ``top``,
    which the vectorised path declines)."""
    def leaf(w, **kw):
        return {"search": dict({"terms": [str(w)], "path": "title"}, **kw)}

    out = {}
    brng = np.random.default_rng(9)
    out["boost_term"] = []
    for i in range(FEATURE_REQUESTS):
        a, b, c = brng.choice(vocab, size=3, p=probs)
        out["boost_term"].append({
            "search_req": leaf(a, levenshtein_distance=1) if i % 2 else leaf(a),
            "boost_term": [{"terms": [str(b)], "path": "title", "boost": 2.0},
                           {"terms": [str(c)], "path": "title", "levenshtein_distance": 1, "boost": 3.0},
                           {"terms": [f"c{brng.integers(16)}"], "path": "cat", "boost": 1.5}],
            "top": 10})
    trng = np.random.default_rng(10)
    out["text_locality"] = [
        {"search_req": {"or": {"queries": [leaf(w) for w in trng.choice(vocab, size=int(trng.integers(2, 4)),
                                                                          p=probs)]}},
         "text_locality": True, "top": 10}
        for _ in range(FEATURE_REQUESTS)]
    wrng = np.random.default_rng(11)
    out["why_found"] = []
    for i in range(FEATURE_REQUESTS):
        words = wrng.choice(vocab, size=int(wrng.integers(2, 4)), p=probs)
        params = {"search_term": " ".join(str(w) for w in words), "why_found": True}
        if i % 2:
            params["select"] = ",".join(FEATURE_SELECT)
        out["why_found"].append({"generator": params})
    srng = np.random.default_rng(12)
    out["suggest"] = []
    for i in range(FEATURE_REQUESTS):
        w = str(srng.choice(vocab, p=probs))
        prefix = w[: int(srng.integers(2, 6))]
        if i % 3 == 2:
            out["suggest"].append({"suggest_query": prefix, "levenshtein": 1})
        else:
            out["suggest"].append({"suggest": [{"terms": [prefix], "path": "title", "starts_with": True}],
                                   "top": 10})
    return out


def check_suggestions(res, top=10):
    """At most ``top`` (text, score, term id), texts distinct, scores finite,
    positive and descending, equal scores text descending."""
    assert len(res) <= top and len({t for t, _s, _i in res}) == len(res), res
    for (t0, s0, _i0), (t1, s1, _i1) in zip(res, res[1:]):
        assert s0 > s1 or (s0 == s1 and t0 > t1), res
    assert all(np.isfinite(s) and s > 0 and i >= 0 for _t, s, i in res), res


def regex_leaf_keys(req):
    """The distinct regex leaves of a request, as ``(field, key)``."""
    return {(p.path, p.key()) for p in req.search_req.walk_parts() if p.is_regex}


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


def wall_ms(fn, warmup: int = 3, iters: int = 60) -> float:
    """Median host-clock ms of a call that ends in a readback (a sync)."""
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(samples)


def sweep_bound(chars_t, lens, queries, qlens, band):
    """(ms, "bytes" | "operations"): the least time the card could take for
    one sweep on these inputs. Bytes: each input read once (64 + 4 bytes a
    term, 64 + 4 a query), each output written once (9 bytes a pair).
    Operations, counted on this run's data: the banded DP computes
    2 * band + 1 cells of BAND_CELL_OPS per (query char, term); the
    bit-parallel sweep one step of BITPARALLEL_STEP_OPS per (query, term
    char), for the queries that are not empty."""
    n, q = chars_t.shape[1], queries.shape[0]
    moved = n * (64 + 4) + q * (64 + 4) + q * n * 9
    ql = qlens.to(torch.int64).clamp(max=32)
    if band is None:
        ops = BITPARALLEL_STEP_OPS * int((ql > 0).sum()) * int(lens.to(torch.int64).sum())
    else:
        ops = BAND_CELL_OPS * (2 * band + 1) * int(ql.sum()) * n
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


class BaselineFull:
    """Another version of csrc/full_levenshtein.cu (the same C entry point),
    built with the tree's flags into build/, for timing against the tree's
    kernel in one process."""

    def __init__(self, build, sweep, source: Path):
        text = source.read_bytes()
        self.lib_path = build.BUILD_DIR / f"baseline-{hashlib.sha256(text).hexdigest()[:16]}.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.proc = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(self.lib_path), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        self.signature = sweep.SIGNATURES[sweep.FULL]["veloci_full_sweep"]
        self.fn = None

    def wait(self) -> str:
        log_text, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the baseline full-width kernel:\n{log_text}")
        fn = ctypes.CDLL(str(self.lib_path)).veloci_full_sweep
        fn.restype, fn.argtypes = ctypes.c_int, self.signature
        self.fn = fn
        return log_text

    def __call__(self, chars_t, lens, queries, qlens):
        q, n = queries.shape[0], chars_t.shape[1]
        out = [torch.empty((q, n), dtype=t, device=chars_t.device)
               for t in (torch.int32, torch.int32, torch.bool)]
        err = self.fn(chars_t.data_ptr(), lens.data_ptr(), n, queries.data_ptr(),
                      qlens.data_ptr(), q, *(o.data_ptr() for o in out),
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"baseline full-width kernel launch failed ({err})")
        return tuple(out)


def compare_full(sweep, baseline, chars_t, lens, queries, qlens, big):
    """The baseline and the tree's full-width kernel on the same inputs:
    outputs equal, then timed in turns old, new, new, old."""
    new = sweep.levenshtein_sweep_full_batch
    got, old = new(chars_t, lens, queries, qlens), baseline(chars_t, lens, queries, qlens)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, old)):
        raise AssertionError("baseline full-width kernel != the tree's")
    iters = 3 if big else 10
    runs = []
    for fn in (baseline, new, new, baseline):
        runs.append(time_ms(lambda: fn(chars_t, lens, queries, qlens), iters=iters))
    old_ms, new_ms = (runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2
    return dict(old_new_new_old_ms=[runs[0], runs[1], runs[2], runs[3]], old_ms=old_ms,
                new_ms=new_ms, speedup=old_ms / new_ms)


# ---------------------------------------------------------------- phases
def edge_phase(sweep, encode_query, rng):
    """Every sweep kernel against its plain version on the edge cases: code
    points above 255 and colliding in their low 8 bits ('a' / U+0161),
    above the BMP, queries of 0, 1, 31, 32, 33 chars, terms of 0 and 32."""
    alphabet = ["a", "b", "\u0161", "\u0101", "\x01", "\u65e5", "\U0001F600"]
    words = ["".join(rng.choice(alphabet, size=int(k))) for k in rng.integers(0, 33, 5003)]
    words[:4] = ["", "a" * 32, "\u0161" * 32, "ab" * 16]
    enc = [encode_query(w) for w in words]
    chars_t = torch.from_numpy(np.ascontiguousarray(np.stack([e for e, _n in enc]).T)).cuda()
    lens = torch.tensor([n for _e, n in enc], dtype=torch.int32, device="cuda")
    qwords = ["", "a", "\u0161", "ab" * 15 + "a", "ab" * 16, "ab" * 16 + "a", "\u0161a" * 17]
    qwords += ["".join(rng.choice(alphabet, size=int(k))) for k in rng.integers(1, 34, 63)]
    queries = torch.from_numpy(np.stack([encode_query(w)[0] for w in qwords])).cuda()
    qlens = torch.tensor([len(w) for w in qwords], dtype=torch.int32, device="cuda")
    cases = [("full", None, sweep.levenshtein_sweep_full_batch, sweep.levenshtein_sweep_full_batch_plain)]
    for band in (2, 4):
        cases.append((f"band {band}", band,
                      lambda *a, b=band: sweep.levenshtein_sweep_banded_batch(*a, band=b),
                      lambda *a, b=band: sweep.levenshtein_sweep_banded_batch_plain(*a, band=b)))
    for name, _band, kern, plain in cases:
        got, want = kern(chars_t, lens, queries, qlens), plain(chars_t, lens, queries, qlens)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"sweep kernel != plain on the edge cases ({name})")
        log(f"kernel edge cases N={chars_t.shape[1]} Q={queries.shape[0]} {name}: equal")


def kernel_phase(sweep, encode_query, dictionaries, rng, report, baseline):
    """Kernel vs plain on the card at every shape; exact equality. Returns
    the largest errors, each shape's times, and the title x 256 shapes'
    arguments (for their kernels alone in phase 8)."""
    err = {"batch": 0, "single": 0, "full": 0}
    times, title_args = {}, {}
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
                bound_ms, bound_by = sweep_bound(chars_t, lens, queries, qlens, band)
                times[(dname, q, band)] = (k_ms, p_ms, bound_ms, bound_by)
                if dname == "title" and q == 256:
                    title_args[band] = (chars_t, lens, queries, qlens)
                row = dict(dictionary=dname, terms=n, queries=q, band=band, entry=entry,
                           equal=True, kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms,
                           bound_by=bound_by)
                cmp = ""
                if band is None and baseline is not None:
                    row["compare"] = compare_full(sweep, baseline, chars_t, lens, queries, qlens, big)
                    cmp = (f"; old / new / new / old "
                           f"{' / '.join(f'{t:.4f}' for t in row['compare']['old_new_new_old_ms'])} ms")
                report["kernel_rows"].append(row)
                log(f"kernel {dname:>9} N={n:>8} Q={q:>3} {'band=' + str(band) if band else 'full  '} "
                    f"{entry:>6}: equal, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}){cmp}")
    return err, times, title_args


def record_dense_leaves(executor, calls):
    """Route the executor's leaf resolves through a recorder that keeps each
    leaf's (field, term ids, scores) and calls the real resolve."""
    real = executor.resolve_to_anchor_dense

    def recording(index, field, term_ids, term_scores):
        calls.append((field, term_ids, term_scores))
        return real(index, field, term_ids, term_scores)

    executor.resolve_to_anchor_dense = recording
    return real


def synthetic_dense_leaf(postings):
    """DENSE_SYNTH_TERMS runs of DENSE_SYNTH_ROWS rows in all over
    DENSE_SYNTH_DOCS documents, each run's anchors ascending and spread over
    the plane (one row an anchor in a run, runs overlapping at random), as
    an index on the card with one field "s" of DENSE_SYNTH_TERMS keys:
    ``(index, field, term ids, term scores)``, the leaf resolve's inputs."""
    from types import SimpleNamespace

    srng = np.random.default_rng(8)
    run = DENSE_SYNTH_ROWS // DENSE_SYNTH_TERMS
    stride = DENSE_SYNTH_DOCS // run
    anchors = np.tile(np.arange(run, dtype=np.int64) * stride, DENSE_SYNTH_TERMS)
    anchors += srng.integers(0, stride, DENSE_SYNTH_ROWS)
    scores01 = srng.integers(0, 60000, DENSE_SYNTH_ROWS).astype(np.float32) / np.float32(100.0)
    packed = np.stack([anchors.astype(np.int32), scores01.view(np.int32)], axis=1)
    offsets = np.arange(DENSE_SYNTH_TERMS + 2, dtype=np.int64) * run
    offsets[-1] = offsets[-2]
    term_scores = (srng.integers(100, 1000, DENSE_SYNTH_TERMS) / np.float32(100.0)).astype(np.float32)
    index = SimpleNamespace(
        key_base={"s": (0, DENSE_SYNTH_TERMS)}, host_offsets=offsets, num_docs=DENSE_SYNTH_DOCS,
        offsets=torch.from_numpy(offsets).cuda(), packed=torch.from_numpy(packed).cuda(),
        device=torch.device("cuda"), max_row_score=postings.dense_max_row_score(scores01))
    return index, "s", np.arange(DENSE_SYNTH_TERMS), term_scores


def dense_bound(args):
    """(ms, "bytes"): 8 bytes a gathered row read, 4 a document written, 32
    a term (id, score, run start, the run's two offsets), over 3.35 TB/s;
    one multiply a row is far below the card's f32 rate."""
    t, total_rows, num_docs = args[2].shape[0], args[5], args[6]
    return (8 * total_rows + 4 * num_docs + 32 * t) / HBM_BYTES_PER_S * 1e3, "bytes"


def term_boost_phase(boost, index, parts, report):
    """B10, the ``boost_term`` factor (plain PyTorch,
    ``search/boost.term_boost_factor_device``), at one request of the
    ``boost_term`` mix, its parts' anchors cached as the mix finds most of
    them: the factor's ms (CUDA events) beside its bound, 8 bytes an anchor
    read and 4 a document's factor written over 3.35 TB/s (a bincount and a
    gather: no operation rate binds). Returns the call, for its device time
    in the profile phase."""
    part_anchors = boost.term_boost_anchors(index, parts, {})

    def call():
        return boost.term_boost_factor_device(index, parts, part_anchors)

    call()
    anchors = sum(len(a) for a, _most in part_anchors)
    bound = (8 * anchors + 4 * index.num_docs) / HBM_BYTES_PER_S * 1e3
    row = dict(parts=len(parts), anchors=anchors, num_docs=index.num_docs, ms=time_ms(call), bound_ms=bound)
    report["term_boost"] = row
    log(f"B10 term-boost factor at a boost_term request ({len(parts)} parts, {anchors} anchors, "
        f"{index.num_docs} docs): {row['ms']:.4f} ms (CUDA events), bound {bound:.6f} ms (bytes)")
    return call


def dense_phase(postings, search_step, shapes, report):
    """Kernel B7, its direct and its keys path, against its plain version on
    each shape, bit-equal; per path the call's ms (CUDA events); ms of the
    plain version, one scatter_reduce_ "amax" over the already gathered rows
    (the library call) and the leaf resolve from host arrays, beside the
    bound. ``shapes``: name -> (index, field, term ids, term scores).
    Returns the rows and each shape's arguments, for dense_device_phase."""
    rows, shape_args = {}, {}
    for name, (index, field, tids, tscores) in shapes.items():
        *args, direct_ok = postings.dense_resolve_args(index, field, tids, tscores)
        if not direct_ok:
            raise AssertionError(f"the direct path's condition does not hold on {name}")
        want = postings.dense_resolve_plain(*args)
        errs = []
        for path, direct in (("direct", True), ("keys", False)):
            got = postings.dense_resolve(*args, direct)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"dense_resolve {path} path != plain on {name}")
            errs.append(float((got - want).abs().max()))
        # the calls' times in turns (direct, keys, keys, direct): the call is
        # set by its host path, whose time drifts
        turns = [time_ms(lambda direct=direct: postings.dense_resolve(*args, direct), iters=50)
                 for direct in (True, False, False, True)]
        paths = {"direct": dict(call_ms=(turns[0] + turns[3]) / 2),
                 "keys": dict(call_ms=(turns[1] + turns[2]) / 2)}
        offsets, packed, d_tids, tsc, row_starts, total_rows, num_docs = args
        counts = (row_starts[1:] - row_starts[:-1]).cpu().numpy()
        _t, anchors, scores = search_step.gather_runs(offsets, packed, d_tids.to(torch.int64), tsc, counts)

        def library():
            return torch.full((num_docs,), float("-inf"), device="cuda").scatter_reduce_(
                0, anchors, scores, "amax")

        leaf_ms = time_ms(lambda: postings.resolve_to_anchor_dense(index, field, tids, tscores), iters=50)
        p_ms = time_ms(lambda: postings.dense_resolve_plain(*args), warmup=1, iters=3, reps=5)
        l_ms = time_ms(library, iters=10)
        bound_ms, bound_by = dense_bound(args)
        row = dict(shape=name, terms=int(d_tids.shape[0]), rows=int(total_rows), docs=int(num_docs),
                   hits=int((want > 0).sum()), equal=True, max_abs_err=max(errs), paths=paths,
                   direct_keys_keys_direct_ms=turns,
                   kernel_ms=paths["direct"]["call_ms"], leaf_resolve_ms=leaf_ms, plain_ms=p_ms,
                   library_ms=l_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows[name], shape_args[name] = row, args
        log(f"kernel dense_resolve {name}: T={row['terms']}, rows={total_rows}, docs={num_docs}, "
            f"hits={row['hits']}: both paths equal to plain; "
            + "; ".join(f"{path} call {v['call_ms']:.4f} ms" for path, v in paths.items())
            + f"; leaf resolve with its upload {leaf_ms:.4f} ms, plain {p_ms:.4f} ms, scatter_reduce_ "
            f"{l_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    report["dense_rows"] = list(rows.values())
    return rows, shape_args


def dense_device_phase(postings, rows, shape_args):
    """Per shape and path of B7, the call's device time and the scatter
    kernel's alone (profiler events), into ``rows``. It runs after every
    CUDA-event timing: once the profiler has run, launches in the process
    take longer."""
    for name, args in shape_args.items():
        for path, direct in (("direct", True), ("keys", False)):
            dev = device_ms(lambda direct=direct: postings.dense_resolve(*args, direct))
            rows[name]["paths"][path].update(
                device_ms=sum(dev.values()),
                kernel_ms=sum(ms for key, ms in dev.items() if "scatter_max_kernel" in key),
                device_events={key[:70]: ms for key, ms in dev.items()})
        log(f"kernel dense_resolve {name}, device time by profiler events: "
            + "; ".join(f"{path} {v['device_ms']:.4f} ms (scatter kernel {v['kernel_ms']:.4f})"
                        for path, v in rows[name]["paths"].items()))


def walk_steps(regex_dfa, chars_t, lengths, dfa, prefix: bool) -> int:
    """The chars the DFA walk reads on these inputs: a row stops at its
    length (at most the matrix width), at the dead state, or, in prefix
    mode, at its first accept (at once when the start state accepts)."""
    dev = chars_t.device
    w = chars_t.shape[0]
    lens = lengths.to(torch.int64).clamp(max=w)
    bounds = torch.from_numpy(dfa.boundaries.astype(np.int64)).to(dev)
    trans = torch.from_numpy(dfa.trans.astype(np.int64)).to(dev)
    accept = torch.from_numpy(np.asarray(dfa.accept, dtype=bool)).to(dev)
    state = torch.zeros_like(lens)
    alive = (lens > 0) & ~(accept[0] & prefix)
    steps = 0
    for j in range(int(lens.max()) if lens.numel() else 0):
        active = alive & (j < lens)
        steps += int(active.sum())
        cls = torch.searchsorted(bounds, regex_dfa._codes(chars_t[j]), right=True)
        state = torch.where(active, trans[cls, state], state)
        if prefix:
            alive &= ~(accept[state] & active)
        alive &= ~((state == dfa.dead) & active)
    return steps


def regex_bound(regex_dfa, chars_t, lengths, dfa, prefix: bool):
    """(ms, "bytes" | "operations", chars walked) of one B8 launch: what
    the function needs, 4 bytes a row read for its length, 2 a char walked
    of a u16 row or 4 of an int32 row, 1 a row written; ceil(log2 C) + 2
    integer operations a char step (the class's binary search, the table
    read, the stop test)."""
    steps = walk_steps(regex_dfa, chars_t, lengths, dfa, prefix)
    n = lengths.shape[0]
    moved = 5 * n + chars_t.element_size() * steps
    c = len(dfa.boundaries) + 1
    ops = (int(np.ceil(np.log2(c))) + 2) * steps
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes", steps


# the edge set's patterns: re's shorthand past ASCII, the folds, a dead
# state, the empty pattern, a negated class
REGEX_EDGE_PATTERNS = [r"\w+", "s", "k+", "zzz(a|b)", ".*", "", "[^a]*b", "w1.*"]


def regex_layouts(words):
    """``words`` lowercased as a sweep matrix (``[32, N]`` u16, code points
    past 0xFFFF as U+FFFD, each row cut at 32) and as int32 row-major codes
    (``[N, 254]``, -1 past each row's end), with their lengths."""
    n = len(words)
    chars = np.zeros((32, n), dtype=np.uint16)
    codes = np.full((n, 254), -1, dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    for i, w in enumerate(words):
        cps = [ord(c) for c in w.lower()]
        lens[i] = len(cps)
        codes[i, : min(len(cps), 254)] = cps[:254]
        for j, cp in enumerate(cps[:32]):
            chars[j, i] = cp if cp <= 0xFFFF else 0xFFFD
    t = {k: torch.from_numpy(v).cuda() for k, v in (("chars", chars), ("codes", codes), ("lens", lens))}
    return (t["chars"], t["lens"].clamp(max=32).contiguous()), (t["codes"].T, t["lens"])


def pair_bound(regex_dfa, parts, dfa, prefix: bool):
    """(ms, "bytes" | "operations") of one launch of the two-matrix entry:
    the bytes and the operations of ``regex_bound`` for each of its
    matrices, added."""
    moved = ops = 0
    ops_a_step = int(np.ceil(np.log2(len(dfa.boundaries) + 1))) + 2
    for chars_t, lengths in parts:
        steps = walk_steps(regex_dfa, chars_t, lengths, dfa, prefix)
        moved += 5 * lengths.shape[0] + chars_t.element_size() * steps
        ops += ops_a_step * steps
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def fresh_dfas(regex_dfa, dfa):
    """Copies of ``dfa`` without their kernel argument, enough for one
    ``time_ms(..., iters=20)``: a call on each builds it, as a leaf whose
    pattern is not in ``cached_dfa`` yet does."""
    return iter([regex_dfa.CompiledDfa(dfa.boundaries, dfa.trans, dfa.accept, dfa.dead) for _ in range(102)])


def regex_phase(regex_dfa, index, patterns, report):
    """B8 against its plain walk, bit for bit, in full and prefix mode, on
    each shape (see the module's note); the kernel's and the plain walk's
    ms and the bound with the shape's first pattern in full mode; then the
    two-matrix entry on each field and edge set, timed on the fields.
    Returns the rows, the pair rows and each timed shape's arguments, for
    the profile phase."""
    erng = np.random.default_rng(81)
    title, ent = index.fields["title"], index.fields["ent_seq"]
    title_long, ent_long = index.long_terms["title"], index.long_terms["ent_seq"]
    alphabet = list("abcdefghw0123456789_ -.") + ["\u00e9", "\u212a", "\u0130", "\u0131", "\u017f",
                                                  "\u65e5", "\U0001F600"]
    edge = ["".join(erng.choice(alphabet, size=int(k))) for k in erng.integers(0, 40, 20000)]
    edge[:9] = ["", "a" * 32, "a" * 33, "b" * 254, "w1" * 200, "caf\u00e9", "\u212a", "\u0130x", "\u017f"]
    edge_u16, edge_i32 = regex_layouts(edge)
    # every warp of rows mixes ASCII rows with rows holding non-ASCII chars
    ascii_only, wide = list("abcdefghw0123456789_"), ["\u00e9", "\u00ff", "\u0101", "\u65e5", "\U0001F600"]
    mixed = ["".join(erng.choice(ascii_only + (wide if i % 2 else []), size=int(k)))
             for i, k in enumerate(erng.integers(1, 60, 65536))]
    mixed_u16, mixed_i32 = regex_layouts(mixed)
    # long rows whose lengths within a warp run from 33 to 254 chars
    unequal = ["".join(erng.choice(ascii_only, size=33 + (i * 37) % 222)) for i in range(32768)]
    _unequal_u16, unequal_i32 = regex_layouts(unequal)
    s_lens = np.sort(erng.integers(1, 33, REGEX_SYNTH_TERMS)).astype(np.int32)  # sorted, as a field's rows
    s_chars = erng.choice(np.frombuffer("w0123456789abcdefgh".encode(), np.uint8), size=(32, REGEX_SYNTH_TERMS))
    s_chars = s_chars.astype(np.uint16)
    s_chars[np.arange(32)[:, None] >= s_lens[None, :]] = 0
    # the last two have class boundaries in (127, 0xFFFF]: the kernel's search path
    mixed_patterns = [*patterns, *REGEX_EDGE_PATTERNS, "[\u00e0-\u00ff]+x*",
                      "[\u00e0-\u00e4]x*|[\u00e8-\u00eb]|[\u00ec-\u00ef]+"]
    shapes = {
        "title sweep rows": (title.chars_t, title.lengths, patterns),
        "title long rows": (title_long.codes.T, title_long.lengths, patterns),
        "ent_seq sweep rows": (ent.chars_t, ent.lengths, patterns),
        "synthetic 1M": (torch.from_numpy(s_chars).cuda(), torch.from_numpy(s_lens).cuda(), patterns),
        "edge set u16": (*edge_u16, REGEX_EDGE_PATTERNS),
        "edge set int32": (*edge_i32, REGEX_EDGE_PATTERNS),
        "mixed chars u16": (*mixed_u16, mixed_patterns),
        "mixed chars int32": (*mixed_i32, mixed_patterns),
        "unequal long rows int32": (*unequal_i32, mixed_patterns),
    }
    rows, timed = {}, {}
    dead_seen = False
    for name, (chars_t, lens, pats) in shapes.items():
        dfas = [regex_dfa.compile_dfa(p, ignore_case=True) for p in pats]
        if any(d is None for d in dfas):
            raise AssertionError(f"a regex phase pattern does not compile: {pats}")
        dead_seen |= any(d.dead >= 0 for d in dfas)
        matched, errs = [], []
        for dfa in dfas:
            for prefix in (False, True):
                got = regex_dfa.regex_match(chars_t, lens, dfa, prefix)
                want = regex_dfa.regex_match_plain(chars_t, lens, dfa, prefix)
                torch.cuda.synchronize()
                if got.dtype != torch.bool or got.shape != want.shape:
                    raise AssertionError(f"B8 gave {got.dtype} {tuple(got.shape)} on {name}")
                errs.append(int((got.to(torch.int8) - want.to(torch.int8)).abs().max()) if got.numel() else 0)
                if not torch.equal(got, want):
                    raise AssertionError(f"B8 != plain walk on {name}, pattern {pats[dfas.index(dfa)]!r}, "
                                         f"prefix {prefix}")
                matched.append(int(got.sum()))
        dfa0 = dfas[0]
        k_ms = time_ms(lambda: regex_dfa.regex_match(chars_t, lens, dfa0, False), iters=20)
        fresh = fresh_dfas(regex_dfa, dfa0)
        fresh_ms = time_ms(lambda: regex_dfa.regex_match(chars_t, lens, next(fresh), False), iters=20)
        p_ms = time_ms(lambda: regex_dfa.regex_match_plain(chars_t, lens, dfa0, False), warmup=1, iters=1, reps=3)
        bound_ms, bound_by, steps = regex_bound(regex_dfa, chars_t, lens, dfa0, False)
        rows[name] = dict(shape=name, rows=int(lens.shape[0]), width=int(chars_t.shape[0]),
                          elem_bytes=chars_t.element_size(), patterns=list(pats), timed_pattern=pats[0],
                          classes=len(dfa0.boundaries) + 1, states=int(dfa0.trans.shape[1]),
                          chars_walked=steps, matched=matched, equal=True, max_abs_err=max(errs), kernel_ms=k_ms,
                          fresh_dfa_ms=fresh_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        timed[name] = ((chars_t, lens), dfa0)
        log(f"kernel regex_match {name}: N={rows[name]['rows']}, W={rows[name]['width']}, "
            f"{len(pats)} patterns x full/prefix equal to the plain walk; {pats[0]!r} full: kernel "
            f"{k_ms:.4f} ms (a new DFA each call: {fresh_ms:.4f} ms), plain {p_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}, {steps} chars walked)")
    if not dead_seen:
        raise AssertionError("no regex phase pattern has a dead state")
    # the two-matrix entry, as a regex leaf calls it: a field's sweep rows and long rows in one launch
    pairs = {
        "title field": ((title.chars_t, title.lengths), (title_long.codes.T, title_long.lengths), patterns),
        "ent_seq field": ((ent.chars_t, ent.lengths), (ent_long.codes.T, ent_long.lengths), patterns),
        "edge set": (edge_u16, edge_i32, REGEX_EDGE_PATTERNS),
        "mixed chars": (mixed_u16, mixed_i32, mixed_patterns),
    }
    pair_rows = {}
    for name, (a, b, pats) in pairs.items():
        dfas = [regex_dfa.compile_dfa(p, ignore_case=True) for p in pats]
        errs = []
        for dfa in dfas:
            for prefix in (False, True):
                got = regex_dfa.regex_match_pair(*a, *b, dfa, prefix)
                want = regex_dfa.regex_match_pair_plain(*a, *b, dfa, prefix)
                torch.cuda.synchronize()
                if got.dtype == torch.bool and got.shape == want.shape and got.numel():
                    errs.append(int((got.to(torch.int8) - want.to(torch.int8)).abs().max()))
                if got.dtype != torch.bool or not torch.equal(got, want):
                    raise AssertionError(f"B8's pair entry != its plain version on {name}, pattern "
                                         f"{pats[dfas.index(dfa)]!r}, prefix {prefix}")
        if not name.endswith("field"):
            continue
        dfa0 = dfas[0]
        k_ms = time_ms(lambda: regex_dfa.regex_match_pair(*a, *b, dfa0, False), iters=20)
        fresh = fresh_dfas(regex_dfa, dfa0)
        fresh_ms = time_ms(lambda: regex_dfa.regex_match_pair(*a, *b, next(fresh), False), iters=20)
        p_ms = time_ms(lambda: regex_dfa.regex_match_pair_plain(*a, *b, dfa0, False), warmup=1, iters=1, reps=3)
        bound_ms, bound_by = pair_bound(regex_dfa, (a, b), dfa0, False)
        pair_rows[name] = dict(shape=name, rows=[int(a[1].shape[0]), int(b[1].shape[0])], patterns=list(pats),
                               timed_pattern=pats[0], equal=True, max_abs_err=max(errs), kernel_ms=k_ms,
                               fresh_dfa_ms=fresh_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        timed[name] = ((*a, *b), dfa0)
        log(f"kernel regex_match_pair {name}: {pair_rows[name]['rows']} rows, {len(pats)} patterns x full/prefix "
            f"equal to its plain version; {pats[0]!r} full: call {k_ms:.4f} ms (a new DFA each call: "
            f"{fresh_ms:.4f} ms), plain {p_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by})")
    report["regex_rows"] = list(rows.values())
    report["regex_pair_rows"] = list(pair_rows.values())
    return rows, pair_rows, timed


def record_select_calls(field_search, index, calls):
    """Route the field search's fused-select calls through a recorder that
    keeps each call's inputs and calls the kernel's wrapper."""
    real = field_search.levenshtein_select_banded
    names = {fs.chars_t.data_ptr(): f for f, fs in index.fields.items()}

    def recording(chars_t, lens, sweep_ids, query, query_len, band, distance):
        calls.append((names.get(chars_t.data_ptr(), "?"), chars_t, lens, sweep_ids, np.array(query),
                      int(query_len), band, distance))
        return real(chars_t, lens, sweep_ids, query, query_len, band, distance)

    field_search.levenshtein_select_banded = recording
    return real


def select_bound(lens, qlen, band, distance, matches):
    """(ms, "bytes" | "operations", passing terms) of one fused select: what
    the function needs, 4 bytes read a term (its length decides a term
    that fails the test |len - qlen| <= d), 64 more a term that passes
    (its chars), 4 read (its term id) and 12 written a match, and the
    count; 3 operations a band cell for the passing terms."""
    q = min(qlen, 32)
    passing = int(((lens > 0) & ((lens - q).abs() <= distance)).sum())
    moved = 4 * lens.shape[0] + 64 * passing + 16 * matches + 4
    ops = BAND_CELL_OPS * (2 * band + 1) * q * passing
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes", passing


def sweep_select(sweep, levenshtein, fs, item):
    """The single-item select the fused one replaced: the single-query banded sweep (three [N]
    outputs), select_matches over them, four readbacks."""
    lower_term, distance, _sw = item
    query, qlen = levenshtein.encode_query(lower_term)
    dev = fs.chars_t.device
    q_t = torch.from_numpy(query[None]).to(dev)
    ql_t = torch.from_numpy(np.array([qlen], dtype=np.int32)).to(dev)
    band = 2 if distance <= 2 else 4
    dist, _pd, ispref = (o[None] for o in sweep.levenshtein_sweep_banded(
        fs.chars_t, fs.lengths, q_t[0], ql_t, band=band))
    distances = torch.tensor([distance], dtype=torch.int32, device=dev)
    _rows, ids, dists, prefs = (t.cpu().numpy() for t in levenshtein.select_matches(
        dist, ispref, dist, distances, remap=fs.sweep_ids))
    return ids, dists, prefs


def select_phase(sweep, levenshtein, field_search, calls, title, title_words, rng, report):
    """The fused select against its plain twin on every recorded main-path
    spec and at title x 1 for every distance up to bands 2 and 4; then, at
    title x 1, band 2, d 2 on the lone ~2 mix's first query, the times (see
    the module's note). Returns the kernels line's numbers."""
    errs = [0]  # the largest |got - want| of every comparison that passed

    def equal(got, want):
        if not all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)):
            return False
        errs.extend(int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max(initial=0)) for g, w in zip(got, want))
        return True

    specs = {}
    for call in calls:
        field, chars_t, lens, ids, query, qlen, band, distance = call
        specs.setdefault((field, query.tobytes(), qlen, band, distance), call)
    for field, chars_t, lens, ids, query, qlen, band, distance in specs.values():
        got = sweep.levenshtein_select_banded(chars_t, lens, ids, query, qlen, band, distance)
        want = sweep.levenshtein_select_banded_plain(chars_t, lens, ids, query, qlen, band, distance)
        if not equal(got, want):
            raise AssertionError(f"fused select != plain on a main-path spec: {field}, {query[:qlen]}, "
                                 f"band {band}, d {distance}")
    log(f"select: {len(calls)} main-path calls, {len(specs)} distinct specs: equal to the plain twin")
    words = [mutate(str(w), int(rng.integers(3)), rng) for w in rng.choice(title_words, size=8)]
    for word in words:
        query, qlen = levenshtein.encode_query(word)
        for band in (2, 4):
            for distance in range(band + 1):
                args = (title.chars_t, title.lengths, title.sweep_ids, query, qlen, band, distance)
                if not equal(sweep.levenshtein_select_banded(*args),
                             sweep.levenshtein_select_banded_plain(*args)):
                    raise AssertionError(f"fused select != plain at title x 1: {word}, band {band}, d {distance}")
    log(f"select at title x 1: {len(words)} queries x every distance of bands 2 and 4: equal")

    # the timed query: the lone ~2 mix's first title spec
    first = next(c for c in calls if c[1] is title.chars_t and c[7] == 2)
    word = "".join(chr(c) for c in first[4][: first[5]])
    item = (word, 2, False)
    query, qlen = levenshtein.encode_query(word)
    args = (title.chars_t, title.lengths, title.sweep_ids, query, qlen, 2, 2)
    got = field_search._select(title, [item])[0]
    if not equal(got, sweep_select(sweep, levenshtein, title, item)):
        raise AssertionError("the fused select != the sweep path at title x 1")
    turns = []
    for fn in ("sweep", "fused", "fused", "sweep"):
        if fn == "sweep":
            turns.append(wall_ms(lambda: sweep_select(sweep, levenshtein, title, item)))
        else:
            turns.append(wall_ms(lambda: field_search._select(title, [item])))
    call_ms = wall_ms(lambda: sweep.levenshtein_select_banded(*args))
    p_ms = wall_ms(lambda: sweep.levenshtein_select_banded_plain(*args), warmup=1, iters=5)
    bound_ms, bound_by, passing = select_bound(title.lengths, qlen, 2, 2, len(got[0]))
    row = dict(word=word, qlen=qlen, band=2, distance=2, matches=len(got[0]), passing_terms=passing,
               terms=int(title.chars_t.shape[1]), select_sweep_fused_fused_sweep_ms=turns,
               call_ms=call_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by, max_abs_err=max(errs))
    report["select"] = dict(main_path_calls=len(calls), distinct_specs=len(specs), title=row)
    log(f"select at title x 1, band 2, d 2 ({qlen} chars, {row['matches']} matches, {passing} of "
        f"{row['terms']} terms pass the length test): single-item _select, sweep / fused / fused / sweep "
        f"{' / '.join(f'{t:.4f}' for t in turns)} ms; fused call {call_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
    return row, args


def device_ms(fn, calls: int = 20) -> dict:
    """Device time per call of ``fn`` under torch.profiler, by event name
    (kernels, memsets, copies): what the card spent, without the host
    launch path a CUDA event pair around the call also holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total}


def kernel_only_ms(fn, kernel: str, calls: int = 20):
    """Mean device time of ``kernel``'s own events per call of ``fn``: the
    kernel alone. If the profiler saw no event of it, once more over 5 times
    the calls; if it still saw none, None (null in the report), logged."""
    for n in (calls, 5 * calls):
        total = sum(ms for key, ms in device_ms(fn, n).items() if kernel in key)
        if total:
            return total
        log(f"profiler: no device event of {kernel} in {n} calls"
            + ("; once more over 5x the calls" if n == calls else "; its time is recorded as null"))
    return None


def ms_text(ms) -> str:
    """A time in ms for the log, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.4f} ms"


def profile_phase(profiled, report):
    """Each mix's profiled requests under torch.profiler: the share of the
    wall time the device was busy, and the kernels that took it (the
    profiler's own overhead inflates the wall time, so the share is a lower
    bound). ``profiled``: name -> (requests, a function that answers them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, (reqs, answer) in profiled.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            answer(reqs)
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
    top = req.get("top", 10) if isinstance(req, dict) else 10
    assert 0 <= len(res.data) <= top and res.num_hits >= len(res.data), res
    scores = np.array([h.score for h in res.data], dtype=np.float64)
    ids = np.array([h.id for h in res.data], dtype=np.int64)
    assert np.all(np.isfinite(scores)) and np.all(scores > 0), res
    order = np.lexsort((-ids, -scores))
    assert np.array_equal(order, np.arange(len(ids))), res  # (score desc, id desc)
    assert np.all((ids >= 0) & (ids < N_DOCS)), res


def result_key(res):
    if isinstance(res, list):  # suggestions
        return res
    return (res.num_hits, [(h.id, np.float32(h.score).view(np.int32).item()) for h in res.data],
            res.facets, res.why_found_terms, res.why_found_info)


def record_full_launches(field_search, index, calls):
    """Route the field search's full-width sweep calls through a recorder
    that keeps each launch's inputs and calls the kernel's wrapper."""
    real = field_search.levenshtein_sweep_full_batch
    names = {fs.chars_t.data_ptr(): f for f, fs in index.fields.items()}
    names.update({lt.prefixes.chars_t.data_ptr(): f"{f} (long-term prefixes)"
                  for f, lt in index.long_terms.items()})

    def recording(chars_t, lens, queries, qlens):
        calls.append((names.get(chars_t.data_ptr(), "?"), chars_t, lens, queries.clone(),
                      qlens.clone()))
        return real(chars_t, lens, queries, qlens)

    field_search.levenshtein_sweep_full_batch = recording
    return real


def main_path_shape(sweep, calls, baseline, report):
    """Log the main path's full-width launches, then check and time the
    kernel on each field's launch at its median Q, on that launch's own
    inputs. Each field's dictionary is swept once a batch, with Q the
    batch's distinct full-width specs; the field with the most (query,
    term) pairs over the run is the main path's shape (returned, with its
    launch's arguments)."""
    shapes = {}
    for call in calls:
        field, chars_t, _lens, queries, qlens = call
        shapes.setdefault((field, chars_t.shape[1]), []).append(call)
        log(f"  full-width launch: field {field}, N={chars_t.shape[1]}, Q={queries.shape[0]}, "
            f"mean query length {float(qlens.float().mean()):.2f}")
    log(f"main path full-width launches: {len(calls)}")
    report["slice"]["full_launches"] = [
        dict(field=c[0], terms=c[1].shape[1], queries=c[3].shape[0],
             mean_qlen=float(c[4].float().mean())) for c in calls
    ]
    rows, args = {}, {}
    for (field, n), group in shapes.items():
        group = sorted(group, key=lambda c: c[3].shape[0])
        _f, chars_t, lens, queries, qlens = group[len(group) // 2]
        q = queries.shape[0]
        got = sweep.levenshtein_sweep_full_batch(chars_t, lens, queries, qlens)
        want = sweep.levenshtein_sweep_full_batch_plain(chars_t, lens, queries, qlens)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"full-width kernel != plain on the main path's launch {field} N={n} Q={q}")
        k_ms = time_ms(lambda: sweep.levenshtein_sweep_full_batch(chars_t, lens, queries, qlens),
                       iters=10)
        p_ms = time_ms(lambda: sweep.levenshtein_sweep_full_batch_plain(chars_t, lens, queries, qlens),
                       warmup=1, iters=1, reps=3)
        bound_ms, bound_by = sweep_bound(chars_t, lens, queries, qlens, None)
        row = dict(field=field, terms=n, queries=q, mean_qlen=float(qlens.float().mean()),
                   mean_term_len=float(lens.float().mean()), launches=len(group),
                   pairs=sum(c[1].shape[1] * c[3].shape[0] for c in group), equal=True,
                   kernel_ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=bound_by)
        cmp = ""
        if baseline is not None:
            row["compare"] = compare_full(sweep, baseline, chars_t, lens, queries, qlens, False)
            cmp = (f"; old / new / new / old "
                   f"{' / '.join(f'{t:.4f}' for t in row['compare']['old_new_new_old_ms'])} ms")
        rows[(field, n)] = row
        args[(field, n)] = (chars_t, lens, queries, qlens)
        log(f"kernel on the main path's launch ({field}, N={n}, median Q={q}, mean qlen "
            f"{row['mean_qlen']:.2f}, mean term length {row['mean_term_len']:.2f}): equal, "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}){cmp}")
    report["main_full_shapes"] = list(rows.values())
    key = max(rows, key=lambda k: rows[k]["pairs"])
    main = rows[key]
    log(f"main path's full-width shape: {main['field']}, N={main['terms']}, Q={main['queries']}")
    return main, args[key]


# ---------------------------------------------------------------- server path
BASELINE_RUNS = 5  # interleaved timed runs of each CPU baseline and of the card's batch
BASELINE_REL_TOL = 1e-5  # scores, relative (tests/test_native.py's tolerance)


def cpu_model() -> str:
    """The host CPU's model name from /proc/cpuinfo (its first processor);
    where that says "unknown" (a virtualised host may hide it), the vendor, family,
    model number and clock it gives instead."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    name = info.get("model name", "unknown")
    if name != "unknown":
        return name
    return (f"{info.get('vendor_id', 'unknown vendor')} family {info.get('cpu family', '?')} model "
            f"{info.get('model', '?')} at {info.get('cpu MHz', '?')} MHz (/proc/cpuinfo gives no model name)")


def baseline_mismatches(name, ids, scores, hits, results, specs):
    """Each baseline answer against the card's result for the same request:
    the ids (up to 10, in order), num_hits, and the scores within
    BASELINE_REL_TOL relative. Returns (equal answers, the first mismatch's
    text or None)."""
    equal, first = 0, None
    for q, (res, spec) in enumerate(zip(results, specs)):
        n = len(res.data)
        want_ids = [h.id for h in res.data]
        want_scores = np.array([h.score for h in res.data], np.float64)
        got_scores = scores[q, :n].astype(np.float64)
        ok = (int(hits[q]) == res.num_hits and n == min(10, res.num_hits)
              and ids[q, :n].tolist() == want_ids
              and bool(np.all(np.abs(got_scores - want_scores) <= BASELINE_REL_TOL * np.abs(want_scores))))
        equal += ok
        if not ok and first is None:
            first = (f"{name}: {spec}: baseline ids {ids[q, :n].tolist()} scores {got_scores.tolist()} "
                     f"num_hits {int(hits[q])}; card ids {want_ids} scores {want_scores.tolist()} "
                     f"num_hits {res.num_hits}")
    return equal, first


def baselines_phase(vt, index, index_dir, mixes, answers, make, report):
    """The ``baselines`` path: the native single-core CPU baselines
    (``native/baseline.cpp`` through ``veloci_tpu_torch.native``) on the
    saved index's ``title`` host arrays, on the single-leaf path's first
    batch of each mix, each answer held to the card's ``search_batch``
    answer for the same request (ids up to 10 in order, num_hits, scores
    within BASELINE_REL_TOL relative): the exact mix through
    ``baseline_exact_topk`` and ``baseline_exact_topk_vint`` (bit-equal to
    each other), the ``~1`` and ``~2`` mixes through ``baseline_fuzzy_topk``
    (the distance clamped to the term's length - 1, as the search does).
    Then BASELINE_RUNS interleaved timed runs of each baseline and of the
    card's batch on the same requests: requests/s, median and spread. Fails
    if the baselines do not build or any answer differs."""
    from veloci_tpu_torch import native
    from veloci_tpu_torch.ops.levenshtein import encode_query
    from veloci_tpu_torch.search.field_search import get_default_score_for_distance

    t_phase = time.perf_counter()
    if not native.baseline_available():
        raise AssertionError("the native CPU baselines did not build (g++, native/indexer.cpp and baseline.cpp)")
    pers = vt.Persistence.load(str(index_dir))
    store = pers.anchor_scores["title.textindex.to_anchor_id_score"]
    dictionary = pers.get_dictionary("title")
    csr = (store.offsets, store.anchors, store.scores)
    top = 10

    specs = {name: mixes[name][0] for name in ("exact", "fuzzy_d1", "fuzzy_d2")}
    leaves = {name: [d["search_req"]["search"] for d in batch] for name, batch in specs.items()}
    # exact: every case variant of the term in one slot, at distance 0's score
    term_ids = [dictionary.get_ignore_case(leaf["terms"][0]) for leaf in leaves["exact"]]
    tids = np.full((len(term_ids), max(1, max(map(len, term_ids)))), -1, np.int32)
    for q, ids in enumerate(term_ids):
        tids[q, : len(ids)] = ids
    tscores = np.full(tids.shape, float(get_default_score_for_distance(0, False)), np.float32)
    tslots = np.zeros(tids.shape, np.int32)
    t0 = time.perf_counter()
    vint = native.baseline_encode_vint(*csr)
    fuzzy_index = native.baseline_fuzzy_index(dictionary)
    prep_s = time.perf_counter() - t0
    fuzzy_args = {}
    for name in ("fuzzy_d1", "fuzzy_d2"):
        queries = np.zeros((len(leaves[name]), 32), np.uint16)
        qlens, dists = np.zeros(len(queries), np.int32), np.zeros(len(queries), np.int32)
        for q, leaf in enumerate(leaves[name]):
            term = leaf["terms"][0].lower()
            queries[q], qlens[q] = encode_query(term)
            dists[q] = min(leaf["levenshtein_distance"], max(len(term) - 1, 0))
        fuzzy_args[name] = (fuzzy_index, queries, qlens, dists, *csr, top)
    runs = {
        "exact_raw": lambda: native.baseline_exact_topk(*csr, tids, tscores, tslots, top),
        "exact_vint": lambda: native.baseline_exact_topk_vint(vint, tids, tscores, top),
        "fuzzy_d1": lambda: native.baseline_fuzzy_topk(*fuzzy_args["fuzzy_d1"]),
        "fuzzy_d2": lambda: native.baseline_fuzzy_topk(*fuzzy_args["fuzzy_d2"]),
    }
    outs = {name: run() for name, run in runs.items()}  # also the page-warming run
    raw, vint_out = outs["exact_raw"], outs["exact_vint"]
    if not (np.array_equal(raw[0], vint_out[0]) and np.array_equal(raw[1].view(np.uint32), vint_out[1].view(np.uint32))
            and np.array_equal(raw[2], vint_out[2])):
        raise AssertionError("baseline_exact_topk_vint's answers are not bit-equal to baseline_exact_topk's")
    checks = {"exact_raw": "exact", "exact_vint": "exact", "fuzzy_d1": "fuzzy_d1", "fuzzy_d2": "fuzzy_d2"}
    equal, mismatches = {}, []
    for name, mix in checks.items():
        ids, scores, hits = outs[name][:3]
        equal[name], first = baseline_mismatches(name, ids, scores, hits, answers[mix][0], specs[mix])
        if first:
            mismatches.append(first)
    matches = {name: int(outs[name][3].sum()) for name in ("fuzzy_d1", "fuzzy_d2")}
    total = sum(len(answers[mix][0]) for mix in checks.values())
    log(f"baselines: {sum(equal.values())} of {total} answers equal to the card's search_batch answers "
        f"({', '.join(f'{k} {v}' for k, v in equal.items())}); raw and vint bit-equal; fuzzy dictionary "
        f"matches {matches}; vint blob {vint.blob.nbytes} bytes, fuzzy index {len(fuzzy_index.lens)} rows, "
        f"built in {prep_s:.3f} s")
    if mismatches:
        raise AssertionError("a native baseline's answer differs from the card's: " + "; ".join(mismatches[:4]))

    # timing: each baseline and the card's batch of the same requests, in turns
    card_reqs = {mix: [make(d, index) for d in batch] for mix, batch in specs.items()}
    card = {f"card_{mix}": (lambda reqs=reqs: vt.search_batch(reqs, index)) for mix, reqs in card_reqs.items()}
    for fn in card.values():
        fn()
    torch.cuda.synchronize()
    samples = {name: [] for name in (*runs, *card)}
    for _ in range(BASELINE_RUNS):
        for name, fn in (*runs.items(), *card.items()):
            t0 = time.perf_counter()
            fn()
            if name.startswith("card_"):
                torch.cuda.synchronize()
            samples[name].append(time.perf_counter() - t0)
    cpu = cpu_model()
    rows = {}
    for name, secs in samples.items():
        n = len(specs[checks.get(name, name.removeprefix("card_"))])
        rps = sorted(n / s for s in secs)
        rows[name] = dict(requests=n, runs=len(secs), rps_median=float(statistics.median(rps)),
                          rps_min=rps[0], rps_max=rps[-1], seconds=secs,
                          on=f"GPU {report['card']}" if name.startswith("card_") else f"CPU {cpu}, one core")
    for name, row in rows.items():
        log(f"baselines {name:>13}: {row['requests']} requests x {row['runs']}: {row['rps_median']:.1f} "
            f"requests/s median (spread {row['rps_min']:.1f} .. {row['rps_max']:.1f}); on {row['on']}")
    seconds = time.perf_counter() - t_phase
    log(f"baselines path: {seconds:.2f} s")
    return dict(cpu=cpu, card=report["card"], equal=equal, total=total, fuzzy_matches=matches, rows=rows,
                seconds=seconds)


SERVER_DB = "smoke_index"  # the saved index's directory name, under build/
SERVER_DEVICE = "cuda"  # the child server's --device
SERVER_THREADS = 32  # client threads of the concurrent bursts
SERVER_EXPLAIN_REQUESTS = 64
SERVER_PLANS = 16
SERVER_DOC_READS = 32
SERVER_START_S = 240  # the child's import, CUDA start, load and warmup
SERVER_REQUEST_S = 120


def regex_mix_child(tree: Path, index_dir: Path, queries: Path) -> dict:
    """``--regex-mix-child``: with the ``veloci_tpu_torch`` of ``tree``, load
    the saved index onto the card, warm it up, and send the regex mix's
    query strings through ``search`` one at a time (the first four once
    before), each timed on the host clock around the call, as the main
    path times them. Returns the tree, the card, p50 / p99 / mean ms and
    the B8 launches by entry point."""
    sys.path.insert(0, str(tree))
    import veloci_tpu_torch as vt
    from veloci_tpu_torch.ops import regex_dfa

    if not Path(vt.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {vt.__file__}, not the package of {tree}")
    index = vt.load_index(str(index_dir))
    index.warmup()
    reqs = [vt.search_query(index, vt.SearchQueryGeneratorParameters(search_term=q))
            for q in json.loads(queries.read_text())]
    for req in reqs[:4]:
        vt.search(req, index)
    entries = [getattr(regex_dfa, n) for n in ("regex_match", "regex_match_pair") if hasattr(regex_dfa, n)]
    before = [fn.launches for fn in entries]
    ms = []
    for req in reqs:
        t0 = time.perf_counter()
        vt.search(req, index)
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return dict(tree=str(tree), card=torch.cuda.get_device_name(0), requests=len(ms),
                p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                mean_ms=statistics.fmean(ms),
                b8_launches={fn.__name__: fn.launches - b for fn, b in zip(entries, before)})


def compare_regex(other: Path, index_dir: Path, query_strings, report) -> None:
    """``--compare-regex``: the regex mix answered by ``other``'s package
    and by this tree's, each in a child process of its own
    (:func:`regex_mix_child`), in REGEX_AB_ROUNDS rounds of (other, this,
    this, other); every child's line printed, then each tree's median p50."""
    queries = ROOT / "build" / "regex_mix_queries.json"
    queries.write_text(json.dumps(query_strings))
    runs = []
    for _ in range(REGEX_AB_ROUNDS):
        for tree in (other, ROOT, ROOT, other):
            proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--regex-mix-child", str(tree),
                                   str(index_dir), str(queries)], capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"regex mix child on {tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            log(f"compare-regex: {json.dumps(runs[-1])}")
    medians = {str(t): statistics.median(r["p50_ms"] for r in runs if r["tree"] == str(t)) for t in (other, ROOT)}
    log(f"compare-regex: median p50 over {2 * REGEX_AB_ROUNDS} runs each: "
        + ", ".join(f"{t} {m:.3f} ms" for t, m in medians.items()))
    report["compare_regex"] = dict(runs=runs, median_p50_ms=medians)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(base: str, method: str, path: str, body=None):
    """One request -> (status, body text, seconds on the client's clock)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode("utf-8")
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=SERVER_REQUEST_S) as resp:
            status, text = resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        status, text = e.code, e.read().decode("utf-8")
    return status, text, time.perf_counter() - t0


def burst(base: str, calls, threads: int = SERVER_THREADS):
    """``calls`` [(method, path, body)] from ``threads`` client threads at
    once -> (their (status, text, seconds) in order, wall seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        out = list(pool.map(lambda c: http(base, *c), calls))
    return out, time.perf_counter() - t0


def request_json(req) -> dict:
    """A port ``Request`` as the JSON ``Request.from_dict`` reads."""
    import dataclasses

    def fields(obj):
        return {k: v for k, v in dataclasses.asdict(obj).items() if v is not None and k != "explain"}

    def node(n):
        if n.kind == "search":
            return {"search": fields(n.part)}
        out = {"queries": [node(q) for q in n.queries]}
        if n.options:
            out["options"] = n.options
        return {n.kind: out}

    out = {"top": req.top, "skip": req.skip, "why_found": req.why_found,
           "text_locality": req.text_locality, "explain": req.explain, "select": req.select}
    if req.search_req is not None:
        out["search_req"] = node(req.search_req)
    if req.filter is not None:
        out["filter"] = node(req.filter)
    for key in ("suggest", "boost_term", "boost"):
        if getattr(req, key):
            out[key] = [fields(p) for p in getattr(req, key)]
    if req.facets:
        out["facets"] = [{"field": f.field, "top": f.top} for f in req.facets]
    if req.phrase_boosts:
        out["phrase_boosts"] = [{"search1": fields(pb.search1), "search2": fields(pb.search2)}
                                for pb in req.phrase_boosts]
    return out


def body_of(obj):
    """A JSON value without ``execution_time_ns``, as a server sends it."""
    obj = json.loads(json.dumps(obj, ensure_ascii=False))

    def strip(o):
        if isinstance(o, dict):
            return {k: strip(v) for k, v in o.items() if k != "execution_time_ns"}
        if isinstance(o, list):
            return [strip(v) for v in o]
        return o
    return strip(obj)


def server_traffic(vt, index, query_strings, generic, suggest_specs, deep_trees, make):
    """The server path's requests, by phase, as (method, path, body)."""
    from urllib.parse import quote

    db = f"/{SERVER_DB}"
    searches = [("GET", f"{db}/search?query={quote(s)}", None) for s in query_strings]
    suggests = []
    for spec in suggest_specs:
        if "suggest_query" in spec:
            suggests.append(("GET", f"{db}/suggest?query={quote(spec['suggest_query'])}&levenshtein=1", None))
        else:
            suggests.append(("GET", f"{db}/suggest?query={quote(spec['suggest'][0]['terms'][0])}", None))
    batch = [request_json(make(d, index)) for d in generic]
    explained = [("POST", f"{db}/search", dict(d, explain=True, select=["title"]))
                 for d in deep_trees[:SERVER_EXPLAIN_REQUESTS]]
    plans = [("POST", f"{db}/search_query_params/explain_plan", d["generator"]) for d in generic[:SERVER_PLANS]]
    return {"search_sequential": searches, "search_concurrent": searches,
            "search_batch": [("POST", f"{db}/search_batch", batch)], "suggest_concurrent": suggests,
            "explain": explained, "explain_plan": plans}


def direct_answer(vt, index, method, path, body):
    """What the server must answer for one request, from the port's direct
    calls on ``index``: a JSON value, or the plan's text."""
    from urllib.parse import parse_qs, unquote, urlparse

    from veloci_tpu_torch.search.read_document import read_data

    url = urlparse(path)
    route = url.path.split("/", 2)[2]
    qs = {k: v[0] for k, v in parse_qs(url.query).items()}
    if route == "search" and method == "GET":
        req = vt.search_query(index, vt.SearchQueryGeneratorParameters(search_term=qs["query"]))
        return body_of(vt.search_to_result_with_doc(index, vt.search(req, index), req.select).to_dict())
    if route == "search":
        req = vt.Request.from_dict(body)
        return body_of(vt.search_to_result_with_doc(index, vt.search(req, index), req.select).to_dict())
    if route == "search_batch":
        reqs = [vt.Request.from_dict(b) for b in body]
        return body_of([vt.search_to_result_with_doc(index, r, q.select).to_dict()
                        for r, q in zip(vt.search_batch(reqs, index), reqs)])
    if route == "suggest":
        lev = int(qs["levenshtein"]) if "levenshtein" in qs else None
        return body_of(vt.suggest(index, vt.suggest_query(qs["query"], index, None, None, lev, None, None)))
    if route == "search_query_params/explain_plan":
        return vt.explain_plan(vt.search_query(index, vt.SearchQueryGeneratorParameters.from_dict(body)), index)
    if route.startswith("_id/"):
        return body_of(json.loads(index.doc_loader.get_doc(int(unquote(route[4:])))))
    if route.startswith("_idtree/"):
        return body_of(read_data(index, int(route[8:]), index.get_all_fields()))
    raise AssertionError(f"no direct answer for {path}")


def plan_graph(text: str):
    """A plan's graph with each node named by its label: the sorted node
    labels, the sorted (source label, target label) edges, and the line
    count. The query generator takes a query's phrase pairs from a set, so
    two processes (two string hash seeds) list one request's phrase boosts,
    and so number the plan's field-search and phrase nodes, in other
    orders; the answers do not depend on it (every pair's factor is 5)."""
    lines = text.split("\n")
    label = {}
    for line in lines:
        if " [label=" in line:
            name, rest = line.strip().split(" [label=", 1)
            label[name] = rest
    edges = []
    for line in lines:
        if " -> " in line and " [label=" not in line:
            src, dst = line.strip().rstrip(";").split(" -> ")
            edges.append((label.get(src, src), label.get(dst, dst)))
    return sorted(label.values()), sorted(edges), len(lines)


def check_answers(name, calls, replies, want):
    """Each reply 200 and equal to its direct answer (a plan: the same
    graph, :func:`plan_graph`)."""
    for (method, path, _body), (status, text, _s), expect in zip(calls, replies, want):
        if status != 200:
            raise AssertionError(f"server {name}: {method} {path} answered {status}: {text[:300]}")
        if isinstance(expect, str):
            same = plan_graph(text) == plan_graph(expect)
        else:
            same = body_of(json.loads(text)) == expect
        if not same:
            raise AssertionError(f"server {name}: {method} {path} differs from the direct call")


def drive_server(base, traffic, stats=True):
    """The server path's traffic against one server, in order: the
    sequential searches, the concurrent search burst, the batch, the
    concurrent suggest burst, the explained searches, the plans, then the
    document reads of the sequential answers' top hits. -> (replies by
    phase, the calls by phase, wall seconds by phase, fold counters)."""
    replies, walls, folds = {}, {}, {}
    calls = dict(traffic)
    for name in ("search_sequential", "explain", "explain_plan", "search_batch"):
        t0 = time.perf_counter()
        replies[name] = [http(base, *c) for c in calls[name]]
        walls[name] = time.perf_counter() - t0
    for name in ("search_concurrent", "suggest_concurrent"):
        before = json.loads(http(base, "GET", "/stats")[1])["paths"] if stats else {}
        replies[name], walls[name] = burst(base, calls[name])
        after = json.loads(http(base, "GET", "/stats")[1])["paths"] if stats else {}
        folds[name] = {k: after.get(k, 0) - before.get(k, 0) for k in ("fold_dispatches", "fold_folded_requests",
                                                                    "fold_retried_alone")}
    ids = []
    for status, text, _s in replies["search_sequential"]:
        data = json.loads(text)["data"] if status == 200 else []
        if data and data[0]["hit"]["id"] not in ids:
            ids.append(data[0]["hit"]["id"])
    ids = ids[:SERVER_DOC_READS]
    calls["documents"] = [("GET", f"/{SERVER_DB}/{kind}/{i}", None) for i in ids for kind in ("_id", "_idtree")]
    t0 = time.perf_counter()
    replies["documents"] = [http(base, *c) for c in calls["documents"]]
    walls["documents"] = time.perf_counter() - t0
    return replies, calls, walls, folds


def start_server(index_dir):
    """``python -m veloci_tpu_torch.cli serve`` on the saved index, on the
    card, on a free loopback port -> (process, base url, its load line,
    seconds until it answered)."""
    import os

    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "veloci_tpu_torch.cli", "serve", SERVER_DB, "--device", SERVER_DEVICE,
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=str(index_dir.parent), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    threading_reader(proc, lines)
    base = f"http://127.0.0.1:{port}"
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode}: {''.join(lines)[-2000:]}")
        if time.perf_counter() - t0 > SERVER_START_S:
            proc.kill()
            raise AssertionError(f"the server did not answer within {SERVER_START_S} s: {''.join(lines)[-2000:]}")
        try:
            if http(base, "GET", "/version")[0] == 200:
                break
        except OSError:
            time.sleep(0.2)
    ready_s = time.perf_counter() - t0
    load_line = next((line for line in lines if line.startswith("database ")), "")
    return proc, base, load_line.strip(), ready_s


def threading_reader(proc, lines):
    """Collect the child's output lines on a thread of their own."""
    import threading

    def read():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=read, daemon=True).start()


def stop_server(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)


def latency_row(replies, wall=None):
    ms = np.array([s for _st, _t, s in replies]) * 1e3
    row = dict(requests=len(ms), p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
               samples_ms=ms.tolist())
    if wall is not None:
        row.update(wall_s=wall, requests_per_s=len(ms) / wall)
    return row


def server_phase(vt, index, index_dir, cpu_index, traffic, kernel_fns, postings, report):
    """The ``server`` path: the port's server in a child process on the
    card, over HTTP; every answer equal to the direct call's, the explained
    entries equal to the CPU plain path's; then the same traffic against an
    in-process server on this process's index, the kernels' launch counters
    set to 0 just before and read just after. Returns the launches and the
    in-process server's base url (for the profile phase) and server."""
    from veloci_tpu_torch import server as port_server

    t_phase = time.perf_counter()
    proc, base, load_line, ready_s = start_server(index_dir)
    try:
        replies, calls, walls, folds = drive_server(base, traffic)
    finally:
        stop_server(proc)
    log(f"server (child process, cli serve --device {SERVER_DEVICE}): answering after {ready_s:.2f} s; {load_line}")
    row = {"ready_s": ready_s, "load_line": load_line, "folds": folds}
    for name in replies:
        row[name] = latency_row(replies[name], walls[name] if name.endswith("concurrent") else None)
    row["search_batch"]["batch_ms"] = walls["search_batch"] * 1e3
    row["explain_plan"]["total_ms"] = walls["explain_plan"] * 1e3
    # the direct calls on this process's index, after the child's traffic
    t0 = time.perf_counter()
    want = {name: [direct_answer(vt, index, *c) for c in calls[name]] for name in calls}
    direct_s = time.perf_counter() - t0
    for name in calls:
        check_answers(name, calls[name], replies[name], want[name])
    explained = 0
    for (_m, _p, body), (_st, text, _s) in zip(calls["explain"], replies["explain"]):
        req = vt.Request.from_dict(body)
        cpu = vt.search_to_result_with_doc(cpu_index, vt.search(req, cpu_index), req.select)
        got = body_of(json.loads(text))
        if got != body_of(cpu.to_dict()):
            raise AssertionError(f"server explain != the CPU plain path for {body}")
        explained += sum(bool(d.get("explain")) for d in got["data"])
    if not explained:
        raise AssertionError("no explained hit came back")
    n_calls = sum(len(v) for v in calls.values())
    log(f"server: {n_calls} requests, every answer equal to the direct call on the card "
        f"({direct_s:.1f} s); {explained} explained hits equal to the CPU plain path")
    # the same traffic against an in-process server on this index, counted
    port_server.PERSISTENCES[SERVER_DB] = index
    srv = port_server.make_server("127.0.0.1", 0, device=SERVER_DEVICE)
    import threading

    threading.Thread(target=srv.serve_forever, daemon=True).start()
    local = f"http://127.0.0.1:{srv.server_address[1]}"
    for fn in kernel_fns.values():
        fn.launches = 0
    postings.dense_resolve.direct_launches = 0
    routes0 = dict(index.path_counts)
    local_replies, local_calls, _w, _f = drive_server(local, traffic)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    launches["dense_resolve_direct"] = postings.dense_resolve.direct_launches
    routes = {k: v - routes0.get(k, 0) for k, v in index.path_counts.items() if v != routes0.get(k, 0)}
    for name in local_calls:
        expect = (want[name] if local_calls[name] == calls[name]
                  else [direct_answer(vt, index, *c) for c in local_calls[name]])
        check_answers(f"in-process {name}", local_calls[name], local_replies[name], expect)
    row.update(launches=launches, routes=routes, phase_s=time.perf_counter() - t_phase)
    report["slice"]["server"] = row
    log(f"main path server launches (in-process server, same traffic): {launches}; routes: {routes}")
    for name in ("search_sequential", "search_concurrent", "suggest_concurrent", "explain", "documents"):
        r = row[name]
        extra = f", wall {r['wall_s']:.3f} s, {r['requests_per_s']:.1f} requests/s" if "wall_s" in r else ""
        log(f"server {name:>18}: x {r['requests']}: p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms{extra}")
    log(f"server search_batch of {len(traffic['search_batch'][0][2])}: {row['search_batch']['batch_ms']:.3f} ms; "
        f"explain_plan x {len(traffic['explain_plan'])}: {row['explain_plan']['total_ms']:.3f} ms in all; "
        f"folds {folds}; phase {row['phase_s']:.1f} s")
    for k in ("levenshtein_sweep_banded_batch", "levenshtein_select_banded", "levenshtein_sweep_full_batch",
              "dense_resolve"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path server")
    if not folds["search_concurrent"].get("fold_folded_requests"):
        raise AssertionError("the concurrent search burst folded no requests")
    for name, counts in folds.items():
        if counts.get("fold_retried_alone"):
            raise AssertionError(f"server {name}: {counts['fold_retried_alone']} folded requests were answered "
                                 "again alone after their batch raised")
    return launches, local, srv


# ---------------------------------------------------------------- api path
API_CLI_DOCS = 100_000  # test_large_search's corpus in the CLI child
API_CLI_S = 600  # the child's import, CUDA start, build, upload and six searches
API_DEVICE = "cuda"  # the default device the path must upload onto; a CPU rehearsal sets "cpu"
API_CLI_ARGS = ()  # a CPU rehearsal adds ("--device", "cpu"); on the card the child names no device


def api_phase(vt, index, index_dir, query_strings, suggest_spec, generic_spec, make, kernel_fns, postings,
              report):
    """The ``api`` path: the JAX package's own call on the port. The saved
    index read back as a ``Persistence`` (no device named anywhere), its
    upload counted: ``vt.search(req, pers)`` for each query string alone,
    ``vt.search_batch`` of them all, ``search_to_result_with_doc``,
    ``suggest`` and ``explain_plan`` once each, the launch counters set to
    0 just before and read just after. Then the same calls on the loaded
    ``TorchIndex``: every answer bit-equal. The first call's seconds (the
    upload) and the lone p50 / p99 of the other requests beside the
    TorchIndex's on the same requests. Then ``cli test_large_search`` in a
    child process with ``VELOCI_LOG=info``: one ``search took`` line a
    search. Returns the path's launches."""
    import os

    from veloci_tpu_torch.persistence import TorchIndex, default_device

    t_phase = time.perf_counter()
    pers = vt.Persistence.load(str(index_dir))
    reqs = [make(q, index) for q in query_strings]  # the trees equal those made from pers; no upload here
    sugg, plan_req = make(suggest_spec, index), make(generic_spec, index)
    uploads = []
    real_upload = TorchIndex.from_persistence.__func__

    def counted(cls, p, device=None):
        uploads.append(device)
        return real_upload(cls, p, device)

    TorchIndex.from_persistence = classmethod(counted)
    for fn in kernel_fns.values():
        fn.launches = 0
    postings.dense_resolve.direct_launches = 0
    try:
        lone, samples = [], []
        for req in reqs:
            t0 = time.perf_counter()
            lone.append(vt.search(req, pers))
            samples.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        batch = vt.search_batch(reqs, pers)
        batch_s = time.perf_counter() - t0
        docs = vt.search_to_result_with_doc(pers, lone[0], ["title", "cat"])
        suggested = vt.suggest(pers, sugg)
        plan = vt.explain_plan(plan_req, pers)
        torch.cuda.synchronize()
    finally:
        TorchIndex.from_persistence = classmethod(real_upload)
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    launches["dense_resolve_direct"] = postings.dense_resolve.direct_launches
    upload = pers.index()
    if len(uploads) != 1 or uploads[0] is not None or upload.device.type != API_DEVICE \
            or default_device().type != API_DEVICE:
        raise AssertionError(f"the Persistence uploaded {len(uploads)} times ({uploads}), onto {upload.device}")
    index_samples, index_lone = [], []
    for req in reqs:
        t0 = time.perf_counter()
        index_lone.append(vt.search(req, index))
        index_samples.append(time.perf_counter() - t0)
    same = [result_key(a) == result_key(b) for a, b in zip(lone, index_lone)]
    same += [result_key(a) == result_key(b) for a, b in zip(batch, vt.search_batch(reqs, index))]
    same.append(json.dumps([d.to_dict() for d in docs.data]) == json.dumps(
        [d.to_dict() for d in vt.search_to_result_with_doc(index, index_lone[0], ["title", "cat"]).data]))
    same.append(suggested == vt.suggest(index, sugg))
    same.append(plan_graph(plan) == plan_graph(vt.explain_plan(plan_req, index)))
    if not all(same):
        raise AssertionError(f"{same.count(False)} answers on the Persistence differ from the TorchIndex's")
    for r, q in zip(lone, query_strings):
        check_result(r, q)
    if not any(r.data for r in lone) or not suggested:
        raise AssertionError("the api path found nothing")
    log(f"main path api launches: {launches}")
    for k in ("levenshtein_sweep_banded_batch", "levenshtein_select_banded", "levenshtein_sweep_full_batch"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path api")
    row = {"upload_s": samples[0], "persistence": lat_row(samples[1:]), "torch_index": lat_row(index_samples[1:]),
           "search_batch_ms": batch_s * 1e3, "answers": len(same), "launches": launches}
    log(f"api: vt.search(req, Persistence) x {len(reqs)}: the first call (the upload onto {upload.device}, once) "
        f"{samples[0]:.3f} s; the other {len(reqs) - 1}: p50 {row['persistence']['p50_ms']:.3f} ms, "
        f"p99 {row['persistence']['p99_ms']:.3f} ms; the TorchIndex on them: p50 "
        f"{row['torch_index']['p50_ms']:.3f} ms, p99 {row['torch_index']['p99_ms']:.3f} ms; search_batch of "
        f"{len(reqs)}: {row['search_batch_ms']:.3f} ms; {len(same)} answers bit-equal to the TorchIndex's")
    # the CLI's test_large_search on the card, its searches logged
    env = dict(os.environ, PYTHONPATH=str(ROOT), VELOCI_LOG="info")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "veloci_tpu_torch.cli", "test_large_search", "--num-docs",
                           str(API_CLI_DOCS), *API_CLI_ARGS], cwd=str(ROOT), env=env, capture_output=True,
                          text=True, timeout=API_CLI_S)
    cli_s = time.perf_counter() - t0
    took = [line for line in proc.stderr.splitlines() if "search took" in line]
    if proc.returncode != 0 or API_DEVICE not in proc.stdout or "6 searches" not in proc.stdout or len(took) != 6:
        raise AssertionError(f"cli test_large_search (rc {proc.returncode}, {len(took)} 'search took' lines): "
                             f"{proc.stdout[-1500:]} {proc.stderr[-1500:]}")
    for line in proc.stdout.strip().splitlines():
        log(f"api cli: {line}")
    log(f"api cli: {len(took)} 'search took' lines, one a search: {[line.split('] ')[-1] for line in took]}; "
        f"{cli_s:.1f} s in all")
    row.update(cli_stdout=proc.stdout, cli_search_took=took, cli_s=cli_s, phase_s=time.perf_counter() - t_phase)
    report["slice"]["api"] = row
    return launches


# ---------------------------------------------------------------- mesh path
MESH_SHARDS = 8  # document shards, all on the one card (the reference's multichip battery: 8 devices)
MESH_GRID = (2, 4)  # the second batch's [q, d] mesh
MESH_LONE = 32  # lone requests of each of the battery's seven shapes
MESH_BATCH = 256
MESH_DEVICE = "cuda"  # every cell of the meshes; a CPU rehearsal sets "cpu"
MESH_PROFILED = 4  # lone requests of each shape under the profiler, in phase 8


def mesh_shapes(index, vocab, probs, rng):
    """The reference's multichip battery (``__graft_entry__.py:213-372``):
    seven request shapes, MESH_LONE of each, terms drawn from the corpus's
    zipfian vocabulary, with its ``cat`` facet and ``pop`` boost. A pair of
    AND terms is two words of one document's title."""
    boost = [{"path": "pop", "boost_fun": "Log10", "param": 1}]
    half = {"or": {"queries": [{"search": {"terms": [f"c{i}"], "path": "cat"}} for i in range(8)]}}

    def word():
        return str(rng.choice(vocab, p=probs))

    def leaf(term, **kw):
        return {"search": dict({"terms": [term], "path": "title"}, **kw)}

    def cat():
        return {"search": {"terms": [f"c{int(rng.integers(16))}"], "path": "cat"}}

    def pair():
        while True:
            doc = json.loads(index.doc_loader.get_doc(int(rng.integers(index.num_docs))))
            words = sorted(set(doc["title"].split()))
            if len(words) >= 2:
                a, b = rng.choice(words, size=2, replace=False)
                return leaf(str(a)), leaf(str(b))

    shapes = {
        "single_term": lambda: {"search_req": leaf(word())},
        "or_filter_boost_facet": lambda: {"search_req": {"or": {"queries": [leaf(word()), leaf(word())]}},
                                          "filter": cat(), "boost": boost, "facets": [{"field": "cat"}]},
        "fuzzy_d1": lambda: {"search_req": leaf(mutate(word(), 1, rng), levenshtein_distance=1)},
        "and_pair": lambda: {"search_req": {"and": {"queries": list(pair())}}},
        "term_half_filter": lambda: {"search_req": leaf(word()), "filter": half},
        "fuzzy_filter_boost": lambda: {"search_req": leaf(mutate(word(), 1, rng), levenshtein_distance=1),
                                       "filter": cat(), "boost": boost},
        "deep_or_of_ands": lambda: {"search_req": {"or": {"queries": [
            {"and": {"queries": list(pair())}}, {"and": {"queries": list(pair())}}, leaf(word())]}}},
    }
    return {name: [dict(make(), top=10) for _ in range(MESH_LONE)] for name, make in shapes.items()}


def with_mesh(index, ctx, fn):
    """``fn()`` with the mesh context ``ctx`` attached to ``index`` (None:
    the unsharded index), the index's own context restored after."""
    old, index.mesh_ctx = index.mesh_ctx, ctx
    try:
        return fn()
    finally:
        index.mesh_ctx = old


def lat_row(samples_s):
    ms = np.array(samples_s) * 1e3
    return dict(n=len(ms), p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
                samples_ms=ms.tolist())


def mesh_phase(vt, index, shapes, riders, make, kernel_fns, postings, report):
    """The eighth main path, ``mesh``: the index attached to a mesh of
    MESH_SHARDS document shards on the card (and a MESH_GRID [q, d] mesh
    for one batch). MESH_LONE lone requests of each shape through
    ``search`` and one ``search_batch`` of MESH_BATCH, first on the
    unsharded index, then, with the launch counters set to 0 just before
    and read just after, on the mesh, with the riders (a regex request, a
    ``boost_term`` and a ``text_locality`` request, which the mesh answers
    on its per-request executor); every mesh answer must equal the
    unsharded one (ids, order, num_hits, facets, f32 score bits). Returns
    the path's launches, the two mesh contexts and the requests."""
    from veloci_tpu_torch.parallel.mesh_executor import MeshContext, build_doc_mesh
    from veloci_tpu_torch.parallel.sharding import build_mesh

    t_path = t0 = time.perf_counter()
    ctx = MeshContext(index, build_doc_mesh(MESH_SHARDS, [MESH_DEVICE] * MESH_SHARDS))
    q, d = MESH_GRID
    grid = MeshContext(index, build_mesh(d, q, [MESH_DEVICE] * (q * d)))
    torch.cuda.synchronize()
    attach_s = time.perf_counter() - t0
    lone = {name: [make(spec, index) for spec in specs] for name, specs in shapes.items()}
    rider_reqs = {name: make(spec, index) for name, spec in riders.items()}
    flat = [r for reqs in lone.values() for r in reqs]
    batch = [flat[i % len(flat)] for i in range(MESH_BATCH)]
    for c in (None, ctx, grid):  # first touches: the sharded dictionaries, filter masks, boost factors
        with_mesh(index, c, lambda: [vt.search(reqs[0], index) for reqs in lone.values()])
        with_mesh(index, c, lambda: vt.search_batch(batch[:8], index))
    torch.cuda.synchronize()

    def run(c):
        lat, ans = {}, {}
        for name, reqs in lone.items():
            lat[name], ans[name] = [], []
            for r in reqs:
                t1 = time.perf_counter()
                ans[name].append(with_mesh(index, c, lambda r=r: vt.search(r, index)))
                lat[name].append(time.perf_counter() - t1)
        for name, r in rider_reqs.items():
            ans[name] = [with_mesh(index, c, lambda r=r: vt.search(r, index))]
        return lat, ans

    def run_batch(c):
        t1 = time.perf_counter()
        res = with_mesh(index, c, lambda: vt.search_batch(batch, index))
        return (time.perf_counter() - t1) * 1e3, res

    want_lat, want = run(None)
    want_batch_ms, want_batch = run_batch(None)
    torch.cuda.synchronize()
    for fn in kernel_fns.values():
        fn.launches = 0
    postings.dense_resolve.direct_launches = 0
    routes0 = dict(index.path_counts)
    got_lat, got = run(ctx)
    batch_ms, got_batch = run_batch(ctx)
    grid_ms, got_grid = run_batch(grid)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in kernel_fns.items()}
    launches["dense_resolve_direct"] = postings.dense_resolve.direct_launches
    routes = {k: v - routes0.get(k, 0) for k, v in index.path_counts.items() if v != routes0.get(k, 0)}
    for name in got:
        for a, b, r in zip(got[name], want[name], lone.get(name, [rider_reqs.get(name)])):
            check_result(a, {"top": r.top if r.top is not None else 10})
            if result_key(a) != result_key(b):
                raise AssertionError(f"mesh answer != the unsharded index's for {name}: {r}")
    for label, res in (("[1, 8]", got_batch), (f"{list(MESH_GRID)}", got_grid)):
        if [result_key(a) for a in res] != [result_key(b) for b in want_batch]:
            raise AssertionError(f"the mesh {label} search_batch != the unsharded search_batch")
    if sum(bool(a.data) for name in lone for a in got[name]) < len(flat) // 2:
        raise AssertionError("the mesh path's requests found too little")
    per_request = routes.get("mesh_executor", 0)
    log(f"mesh: {MESH_SHARDS} document shards on {MESH_DEVICE} ({ctx.dps} docs a shard), and a "
        f"{list(MESH_GRID)} [q, d] mesh, built in {attach_s:.2f} s (the combined postings cut at the shard "
        f"bounds); every shard on the one card: this path measures the per-shard work and the merges, "
        f"not collectives across cards")
    rows = {}
    for name in lone:
        rows[name] = dict(mesh=lat_row(got_lat[name]), unsharded=lat_row(want_lat[name]))
        m, u = rows[name]["mesh"], rows[name]["unsharded"]
        log(f"mesh lone {name:>22} x {m['n']}: p50 {m['p50_ms']:.3f} ms, p99 {m['p99_ms']:.3f} ms; "
            f"unsharded p50 {u['p50_ms']:.3f} ms, p99 {u['p99_ms']:.3f} ms")
    log(f"mesh search_batch of {MESH_BATCH}: [1, {MESH_SHARDS}] {batch_ms:.1f} ms, {list(MESH_GRID)} "
        f"{grid_ms:.1f} ms; unsharded {want_batch_ms:.1f} ms (wall, host clock)")
    log(f"mesh riders on the per-request mesh executor: {sorted(rider_reqs)}; mesh_executor requests "
        f"{per_request}")
    log(f"mesh path launches: {launches}; routes: {routes}")
    log(f"checked: {len(flat) + len(rider_reqs)} lone mesh answers and {2 * MESH_BATCH} batched ones "
        f"identical to the unsharded index's; the mesh path took {time.perf_counter() - t_path:.1f} s")
    for k in ("dense_resolve", "levenshtein_select_banded"):
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched by the main path mesh")
    if per_request < len(rider_reqs):
        raise AssertionError("the riders did not take the mesh's per-request executor")
    report["mesh"] = dict(shards=MESH_SHARDS, grid=list(MESH_GRID), docs_per_shard=ctx.dps, attach_s=attach_s,
                          lone=rows, batch_ms=batch_ms, grid_batch_ms=grid_ms, unsharded_batch_ms=want_batch_ms,
                          launches=launches, routes=routes)
    return launches, ctx, lone, batch


def mesh_kernel_phase(postings, sweep, levenshtein, field_search, ctx, lone, report):
    """B7 and the fused select on one shard's shapes (the mesh's first
    shard, its docs), against their plain versions, bit for bit: B7 at the
    mesh path's single term with the most rows in shard 0 (and at that
    leaf on every shard), the select over each shard's length window of the
    fuzzy_d1 shape's word with the most matches in shard 0, at band 2, d 1. ms (CUDA events for B7, the
    host clock for the select, which reads its matches back), the plain
    versions', the bounds."""
    index = ctx.index
    shards = ctx.combined()
    base = index.key_base["title"][0]
    ho0 = shards.shards[0].host_offsets
    best = None
    for r in lone["single_term"] + lone["term_half_filter"]:
        ids, scores = field_search.term_ids_and_scores(index, r.search_req.part, {})
        if len(ids):
            g = ids.astype(np.int64) + base
            rows = int((ho0[g + 1] - ho0[g]).sum())
            if best is None or rows > best[0]:
                best = (rows, g, scores)
    _rows, gtids, scores = best
    errs = []
    for i in range(ctx.d):
        csr, n = shards.csr(i), ctx.shard_docs(i)
        *args, direct = postings.csr_resolve_args(csr, gtids, scores, n)
        want = postings.dense_resolve_plain(*args)
        for path in {direct, False}:
            got = postings.dense_resolve(*args, path)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"dense_resolve != plain on shard {i}")
            errs.append(float((got - want).abs().max()))
        if i == 0:
            args0, direct0 = args, direct
    b7 = dict(terms=len(gtids), rows=int(args0[5]), docs=int(args0[6]), direct=bool(direct0),
              ms=time_ms(lambda: postings.dense_resolve(*args0, direct0), iters=50),
              plain_ms=time_ms(lambda: postings.dense_resolve_plain(*args0), warmup=1, iters=3),
              max_abs_err=max(errs))
    b7["bound_ms"], b7["bound_by"] = dense_bound(args0)
    log(f"mesh kernel dense_resolve at one shard's leaf (T={b7['terms']}, rows={b7['rows']}, docs={b7['docs']}, "
        f"direct path {b7['direct']}): equal to plain on all {ctx.d} shards; {b7['ms']:.4f} ms, plain "
        f"{b7['plain_ms']:.4f} ms, bound {b7['bound_ms']:.6f} ms ({b7['bound_by']})")
    dictionary = ctx.sharded_dict("title")
    dist = 1

    def shard0_matches(word):
        w = dictionary.window(0, len(word) - dist, len(word) + dist)
        q, n = levenshtein.encode_query(word)
        return len(sweep.levenshtein_select_banded(w.chars_t, w.lengths, w.sweep_ids, q, n, 2, dist)[0])

    # the fuzzy_d1 shape's word with the most matches in shard 0's window
    word = max((r.search_req.part.terms[0].lower() for r in lone["fuzzy_d1"]), key=shard0_matches)
    query, qlen = levenshtein.encode_query(word)
    checked = 0
    for i in range(ctx.d):
        w = dictionary.window(i, len(word) - dist, len(word) + dist)
        if not w.lengths.shape[0]:
            continue
        args = (w.chars_t, w.lengths, w.sweep_ids, query, qlen, 2, dist)
        got, want = sweep.levenshtein_select_banded(*args), sweep.levenshtein_select_banded_plain(*args)
        if not all(g.dtype == v.dtype and np.array_equal(g, v) for g, v in zip(got, want)):
            raise AssertionError(f"fused select != plain on shard {i}'s window")
        checked += 1
        if i == 0:
            sel_args, matches = args, len(got[0])
    sel = dict(word=word, window_rows=int(sel_args[1].shape[0]), shard_rows=int(dictionary.shards[0].lengths.shape[0]),
               matches=matches, shards_checked=checked, ms=wall_ms(lambda: sweep.levenshtein_select_banded(*sel_args)),
               plain_ms=wall_ms(lambda: sweep.levenshtein_select_banded_plain(*sel_args), warmup=1, iters=5),
               max_abs_err=0)
    sel["bound_ms"], sel["bound_by"], _passing = select_bound(sel_args[1], qlen, 2, dist, matches)
    log(f"mesh kernel levenshtein_select_banded over shard 0's window ({sel['window_rows']} of "
        f"{sel['shard_rows']} rows, {matches} matches): equal to plain on {checked} shards' windows; "
        f"{sel['ms']:.4f} ms, plain {sel['plain_ms']:.4f} ms, bound {sel['bound_ms']:.6f} ms ({sel['bound_by']})")
    report["mesh"]["kernels"] = dict(dense_resolve=b7, levenshtein_select_banded=sel)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--compare-full", type=Path, default=None,
                        help="another full_levenshtein.cu to time against the tree's")
    parser.add_argument("--compare-regex", type=Path, default=None,
                        help="another tree whose veloci_tpu_torch answers the regex mix in turns with this one's")
    parser.add_argument("--regex-mix-child", type=Path, nargs=3, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    if args.regex_mix_child is not None:
        print(json.dumps(regex_mix_child(*(p.resolve() for p in args.regex_mix_child))), flush=True)
        return
    sys.path.insert(0, str(ROOT))
    import veloci_tpu_torch as vt
    from veloci_tpu_torch.ops import _build
    from veloci_tpu_torch.ops import levenshtein, levenshtein_sweep, postings, regex_dfa, search_step
    from veloci_tpu_torch.search import boost, executor, field_search

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    report = {"card": card, "kind": kind, "kernel_rows": [], "slice": {}}
    rng = np.random.default_rng(2024)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build (the baseline, if any, compiles beside the tree's sources)
    t0 = time.perf_counter()
    baseline = None
    if args.compare_full is not None:
        baseline = BaselineFull(_build, levenshtein_sweep, args.compare_full.resolve())
    libs = _build.build_all()
    ptxas_logs = {src: Path(f"{lib}.ptxas.txt").read_text() for src, lib in libs.items()
                  if Path(f"{lib}.ptxas.txt").exists()}
    if baseline is not None:
        ptxas_logs[f"baseline {args.compare_full}"] = baseline.wait()
    build_s = time.perf_counter() - t0
    log(f"build: {len(libs)} CUDA source(s) in {build_s:.2f} s")
    for src, text in ptxas_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    report["build_s"] = build_s

    # ---- corpus, index build, save, read + upload
    t0 = time.perf_counter()
    from veloci_tpu_torch.synthetic import build_corpus, zipf_probs

    data, vocab = build_corpus(N_DOCS)
    probs = zipf_probs(len(vocab))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pers = vt.Persistence.from_built(vt.create_indices_from_str(data, BENCH_CONFIG))
    index_build_s = time.perf_counter() - t0
    index_dir = ROOT / "build" / "smoke_index"
    t0 = time.perf_counter()
    pers.save(str(index_dir))
    save_s = time.perf_counter() - t0
    del pers, data
    t0 = time.perf_counter()
    index = vt.load_index(str(index_dir))
    torch.cuda.synchronize()
    load_upload_s = time.perf_counter() - t0
    title = index.fields["title"]
    from veloci_tpu_torch import native

    log(f"slice: {N_DOCS} docs, generated in {gen_s:.2f} s, index built in "
        f"{index_build_s:.2f} s (native indexer: {native.native_available()}), "
        f"saved in {save_s:.2f} s, read + uploaded in "
        f"{load_upload_s:.2f} s; title dictionary {title.chars_t.shape[1]} sweep rows, "
        f"{index.packed.shape[0]} postings")
    report["slice"].update(gen_s=gen_s, index_build_s=index_build_s, save_s=save_s,
                           load_upload_s=load_upload_s,
                           title_sweep_rows=int(title.chars_t.shape[1]),
                           postings=int(index.packed.shape[0]))
    warmup_s = index.warmup()
    log(f"warmup: {warmup_s:.3f} s; breakdown (s): "
        f"{ {k: round(v, 3) for k, v in index.last_warmup_breakdown.items()} }")
    report["slice"].update(warmup_s=warmup_s, warmup_breakdown=dict(index.last_warmup_breakdown))

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
    edge_phase(levenshtein_sweep, levenshtein.encode_query, rng)
    kernel_err, kernel_times, title_args = kernel_phase(
        levenshtein_sweep, levenshtein.encode_query, dictionaries, rng, report, baseline
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

    ex_mixes = executor_mixes(vocab, probs, mixes["generic"][0])
    regex_specs = regex_mix(vocab, probs)
    feat_mixes = feature_mixes(vocab, probs)

    def make(spec, idx):
        """A request dict, or a query string or generator parameters through
        the query generator."""
        if isinstance(spec, str):
            return vt.search_query(idx, vt.SearchQueryGeneratorParameters(search_term=spec))
        if "suggest_query" in spec:
            return vt.suggest_query(spec["suggest_query"], idx, levenshtein=spec["levenshtein"],
                                    fields=["title"])
        if "regex" in spec:
            req = vt.search_query(idx, vt.SearchQueryGeneratorParameters(search_term=spec["regex"]))
            req.select = spec["select"]
            return req
        if "generator" in spec:
            return vt.search_query(idx, vt.SearchQueryGeneratorParameters.from_dict(spec["generator"]))
        return vt.Request.from_dict(spec)

    def answer(name, reqs, idx):
        """A batched mix's batch through search_batch; an executor mix's
        requests one by one through search; the suggest mix's through
        suggest_batch."""
        if name in DENSE_ONLY:
            return [vt.search(r, idx, dense_only=DENSE_ONLY[name]) for r in reqs]
        if name == "suggest":
            return vt.suggest_batch(idx, reqs)
        return vt.search_batch(reqs, idx)

    for name, batches in mixes.items():  # warm-up: first-touch allocations
        vt.search_batch([make(d, index) for d in batches[0]], index)
    vt.search_batch([make(singles[0], index)], index)
    for name, reqs in ex_mixes.items():  # the executor's first requests, timed again below
        answer(name, [make(d, index) for d in reqs[:4]], index)
    answer("regex", [make(d, index) for d in regex_specs[:4]], index)
    for name, reqs in feat_mixes.items():  # the boost_term parts of these 4 are cached from here on
        answer(name, [make(d, index) for d in reqs[:4]], index)
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
                     "levenshtein_select_banded", "levenshtein_sweep_full_batch")
    }
    kernel_fns["dense_resolve"] = postings.dense_resolve
    kernel_fns["regex_match"] = regex_dfa.regex_match
    kernel_fns["regex_match_pair"] = regex_dfa.regex_match_pair
    requests_of = dict(mixes, single_fuzzy_d2=[[d] for d in singles])
    requests_of.update({name: [[d] for d in reqs] for name, reqs in ex_mixes.items()})
    requests_of["regex"] = [[d] for d in regex_specs]
    requests_of.update({name: [[d] for d in feat_mixes[name]] for name in FEATURE_LONE})
    requests_of.update({name: [feat_mixes[name]] for name in ("why_found", "suggest")})
    # the main paths, each with the kernels it must launch: the single-leaf
    # requests, then the query-string trees
    paths = (
        ("single_leaf", ("exact", "fuzzy_d1", "fuzzy_d2", "single_fuzzy_d2"),
         ("levenshtein_sweep_banded_batch", "levenshtein_select_banded")),
        ("query_trees", ("query_string", "and_of_ors_fuzzy"),
         ("levenshtein_sweep_banded_batch", "levenshtein_sweep_full_batch")),
        ("generic", ("generic",),
         ("levenshtein_sweep_banded_batch", "levenshtein_sweep_full_batch")),
        ("executor", tuple(ex_mixes), ("dense_resolve", "levenshtein_select_banded")),
        ("regex", ("regex",), ("regex_match_pair", "dense_resolve")),
        ("features", (*FEATURE_LONE, "why_found", "suggest"),
         ("dense_resolve", "levenshtein_sweep_banded_batch", "levenshtein_select_banded",
          "levenshtein_sweep_full_batch")),
    )
    answers = {}
    lat = {}
    rows_per_batch = {}  # posting rows gathered per batch, by mix
    path_launches = {}
    path_routes = {}
    full_calls = []  # the query_string mix's full-width launches
    dense_calls = []  # the multi_term mix's leaves
    regex_dense_calls = []  # the regex mix's leaves
    regex_docs, doc_lat = [], []  # the regex mix's documents, and each read's seconds
    wf_docs, wf_doc_lat = [], []  # the why_found mix's documents, and each request's read seconds
    expected_b8 = 0  # B8 launches the regex mix must make: one a regex leaf whose field has rows
    select_calls = []  # the fused selects of the lone ~2 and executor mixes
    gc.callbacks.append(on_gc)
    for path, names, needed in paths:
        for fn in kernel_fns.values():
            fn.launches = 0
        postings.dense_resolve.direct_launches = 0
        routes0 = dict(index.path_counts)
        dfa_cache0 = regex_dfa.cached_dfa.cache_info()
        for name in names:
            lat[name], answers[name], rows_per_batch[name] = [], [], []
            if name == "query_string":
                real_full = record_full_launches(field_search, index, full_calls)
            if name in ("multi_term", "regex"):
                real_dense = record_dense_leaves(executor, dense_calls if name == "multi_term"
                                                 else regex_dense_calls)
            if name == "single_fuzzy_d2" or name in DENSE_ONLY:
                real_select = record_select_calls(field_search, index, select_calls)
            for batch in requests_of[name]:
                reqs = [make(d, index) for d in batch]
                rows0 = sum(index.gathered_rows.values())
                t0 = time.perf_counter()
                res = answer(name, reqs, index)
                lat[name].append(time.perf_counter() - t0)
                if name == "regex":
                    t0 = time.perf_counter()
                    regex_docs.append([vt.search_to_result_with_doc(index, r, q.select)
                                       for r, q in zip(res, reqs)])
                    doc_lat.append(time.perf_counter() - t0)
                    for q in reqs:
                        for field, _key in regex_leaf_keys(q):
                            expected_b8 += int(index.fields[field].lengths.shape[0] + len(index.long_terms[field].ids)
                                               > 0)
                if name == "why_found":
                    docs = []
                    for r, q in zip(res, reqs):
                        t0 = time.perf_counter()
                        docs.append(vt.search_to_result_with_doc(index, r, q.select))
                        wf_doc_lat.append(time.perf_counter() - t0)
                    wf_docs.append(docs)
                rows_per_batch[name].append(sum(index.gathered_rows.values()) - rows0)
                answers[name].append(res)
            if name == "query_string":
                field_search.levenshtein_sweep_full_batch = real_full
            if name in ("multi_term", "regex"):
                executor.resolve_to_anchor_dense = real_dense
            if name == "single_fuzzy_d2" or name in DENSE_ONLY:
                field_search.levenshtein_select_banded = real_select
        torch.cuda.synchronize()
        path_launches[path] = {name: fn.launches for name, fn in kernel_fns.items()}
        path_launches[path]["dense_resolve_direct"] = postings.dense_resolve.direct_launches
        path_routes[path] = {k: v - routes0.get(k, 0) for k, v in index.path_counts.items()
                             if v != routes0.get(k, 0)}
        dfa_cache = regex_dfa.cached_dfa.cache_info()
        path_routes[path].update(dfa_cache_hit=dfa_cache.hits - dfa_cache0.hits,
                                 dfa_cache_miss=dfa_cache.misses - dfa_cache0.misses)
        log(f"main path {path} launches: {path_launches[path]}; routes: {path_routes[path]}")
        for k in needed:
            if path_launches[path][k] <= 0:
                raise AssertionError(f"kernel {k} was not launched by the main path {path}")
        if path == "single_leaf":  # the baselines path, on this path's requests and answers
            gc.callbacks.remove(on_gc)
            report["baselines"] = baselines_phase(vt, index, index_dir, mixes, answers, make, report)
            gc.callbacks.append(on_gc)
    gc.callbacks.remove(on_gc)
    if path_routes["executor"].get("executor", 0) <= 0:
        raise AssertionError("the executor path answered no request on the dense executor")
    host_scans = path_routes["regex"].get("regex_host_scan", 0)
    b8_launches = path_launches["regex"]["regex_match_pair"]
    log(f"regex path: {path_routes['regex'].get('regex_dfa', 0)} regex leaves prefiltered by B8, "
        f"{host_scans} host scans; B8 launches {b8_launches} (expected {expected_b8}: one a regex leaf "
        f"over both matrices of its field); single-matrix launches {path_launches['regex']['regex_match']}; "
        f"DFA cache {path_routes['regex']['dfa_cache_hit']} hits, {path_routes['regex']['dfa_cache_miss']} "
        f"misses (a miss compiles a pattern)")
    if host_scans or b8_launches != expected_b8 or not expected_b8 or path_launches["regex"]["regex_match"]:
        raise AssertionError("the regex path did not launch B8 once for every regex leaf over its field's "
                             "matrices, or scanned a dictionary on the host")
    feat = path_routes["features"]
    log(f"features path: term-boost cache {feat.get('term_boost_cache_hit', 0)} hits, "
        f"{feat.get('term_boost_cache_miss', 0)} misses (the warm-up's 4 requests cached their parts); "
        f"suggest {feat.get('suggest_fast', 0)} on the vectorised path, "
        f"{feat.get('suggest_general', 0)} on the general path; executor {feat.get('executor', 0)}")
    if feat.get("executor", 0) < 2 * FEATURE_REQUESTS or not feat.get("suggest_fast") \
            or not feat.get("suggest_general"):
        raise AssertionError("the features path did not take the executor and both suggest paths")
    gen = path_launches["generic"]
    log(f"generic mix launches: B1 (banded, batch) {gen['levenshtein_sweep_banded_batch']}, "
        f"B3 (full-width) {gen['levenshtein_sweep_full_batch']}")
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in [*kernel_fns, "dense_resolve_direct"]}
    log(f"main path launches: {launches}; routes: {dict(index.path_counts)}")
    log(f"main path: {len(gc_full_ms)} full garbage collections, "
        f"ms each: {[round(t, 1) for t in gc_full_ms]}")
    for name, rows in rows_per_batch.items():
        if name in DENSE_ONLY:
            continue
        log(f"rows gathered per batch {name:>16}: median {int(np.median(rows))}, "
            f"max {max(rows)}")
    report["slice"]["gc_full_ms"] = gc_full_ms
    report["slice"]["rows_per_batch"] = rows_per_batch
    report["slice"]["path_launches"] = path_launches
    report["slice"]["path_routes"] = path_routes
    main_full, main_full_args = main_path_shape(levenshtein_sweep, full_calls, baseline, report)
    del full_calls

    # ---- checks: shape and order, then the CPU plain path on the same index
    hits = 0
    for name, results in answers.items():
        for batch, res in zip(requests_of[name], results):
            assert len(res) == len(batch)
            for r, d in zip(res, batch):
                if name == "suggest":
                    check_suggestions(r)
                    hits += bool(r)
                    continue
                check_result(r, d)
                hits += bool(r.data)
    if hits < len(singles):
        raise AssertionError(f"only {hits} requests found anything")
    cpu_index = vt.load_index(str(index_dir), "cpu")
    checked = 0
    for name, results in answers.items():
        if name not in mixes:
            n_check = len(results)
        elif name in ("query_string", "and_of_ors_fuzzy", "generic"):
            n_check = CPU_CHECKED_TREE_BATCHES
        else:
            n_check = CPU_CHECKED_BATCHES
        t0 = time.perf_counter()
        for k, (batch, res) in enumerate(list(zip(requests_of[name], results))[:n_check]):
            cpu_reqs = [make(d, cpu_index) for d in batch]
            cpu = answer(name, cpu_reqs, cpu_index)
            for a, b, d in zip(res, cpu, batch):
                if result_key(a) != result_key(b):
                    raise AssertionError(f"GPU != CPU plain path for {d}")
            if name in ("regex", "why_found"):
                for docs, b, q in zip((regex_docs if name == "regex" else wf_docs)[k], cpu, cpu_reqs):
                    cpu_docs = vt.search_to_result_with_doc(cpu_index, b, q.select)
                    if json.dumps([d.to_dict() for d in docs.data]) != json.dumps(
                            [d.to_dict() for d in cpu_docs.data]):
                        raise AssertionError(f"GPU != CPU plain path for the documents of {q}")
            checked += len(batch)
        log(f"checked on the CPU: {name}, {n_check} batch(es) in {time.perf_counter() - t0:.1f} s")
    log(f"checked: every answer finite, <= top, (score desc, id desc); {checked} "
        f"requests identical to the CPU plain path")

    for name, samples in lat.items():
        n_req = 1 if name.startswith("single") or name in DENSE_ONLY else len(requests_of[name][0])
        ms = np.array(samples) * 1e3
        row = dict(batch=n_req, batches=len(ms), p50_ms=float(np.percentile(ms, 50)),
                   p99_ms=float(np.percentile(ms, 99)),
                   qps=n_req * len(ms) / float(ms.sum() / 1e3), samples_ms=ms.tolist())
        report["slice"][name] = row
        log(f"slice {name:>16}: batch {n_req:>3} x {len(ms)}: p50 {row['p50_ms']:.3f} ms, "
            f"p99 {row['p99_ms']:.3f} ms, {row['qps']:.1f} QPS")
    ms = np.array(doc_lat) * 1e3
    report["slice"]["regex_documents"] = dict(
        reads=len(ms), p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
        samples_ms=ms.tolist(), host_scans=host_scans, b8_launches=b8_launches)
    log(f"slice regex document reads (top 10, half select {REGEX_SELECT}, half whole): x {len(ms)}: "
        f"p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms")
    ms = np.array(wf_doc_lat) * 1e3
    report["slice"]["why_found_documents"] = dict(
        reads=len(ms), p50_ms=float(np.percentile(ms, 50)), p99_ms=float(np.percentile(ms, 99)),
        samples_ms=ms.tolist())
    log(f"slice why_found document reads (top 10, half select {FEATURE_SELECT}, half whole): "
        f"x {len(ms)}: p50 {np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms")
    if args.compare_regex is not None:
        compare_regex(args.compare_regex.resolve(), index_dir, [d["regex"] for d in regex_specs], report)

    # ---- the server path: the port's server in a child process, over HTTP
    traffic = server_traffic(vt, index, mixes["query_string"][0], mixes["generic"][0], feat_mixes["suggest"],
                             ex_mixes["deep_tree"], make)
    path_launches["server"], server_url, local_server = server_phase(
        vt, index, index_dir, cpu_index, traffic, kernel_fns, postings, report)
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in [*kernel_fns, "dense_resolve_direct"]}
    log(f"main path launches, the server path's included: {launches}")
    del cpu_index

    # ---- the api path: the reference's own call, on a Persistence
    path_launches["api"] = api_phase(vt, index, index_dir, mixes["query_string"][0], feat_mixes["suggest"][-1],
                                     mixes["generic"][0][0], make, kernel_fns, postings, report)

    # ---- the mesh path: 8 document shards on the card, against the unsharded index
    riders = {"regex": regex_specs[0], "boost_term": feat_mixes["boost_term"][0],
              "text_locality": feat_mixes["text_locality"][0]}
    path_launches["mesh"], mesh_ctx, mesh_lone, mesh_batch = mesh_phase(
        vt, index, mesh_shapes(index, vocab, probs, np.random.default_rng(13)), riders, make, kernel_fns,
        postings, report)
    launches = {k: sum(p[k] for p in path_launches.values())
                for k in [*kernel_fns, "dense_resolve_direct"]}
    log(f"main path launches, the server and mesh paths' included: {launches}")
    mesh_kernel_phase(postings, levenshtein_sweep, levenshtein, field_search, mesh_ctx, mesh_lone, report)

    # ---- kernel B7 at the main path's largest multi-term leaf and on a 6M-document plane
    def leaf_rows(call):
        leaf = postings.dense_resolve_args(index, *call)
        return -1 if leaf is None else leaf[5]

    largest = max(dense_calls, key=leaf_rows)
    regex_largest = max(regex_dense_calls, key=lambda call: len(call[1]))
    del dense_calls, regex_dense_calls
    if len(regex_largest[1]) <= 1024:
        raise AssertionError("the regex path's largest leaf does not take B7's unstaged path")
    dense_rows, dense_args = dense_phase(postings, search_step, {
        "title multi-term leaf": (index, *largest),
        "regex leaf (unstaged)": (index, *regex_largest),
        "synthetic 6M docs": synthetic_dense_leaf(postings),
    }, report)
    torch.cuda.empty_cache()

    # ---- kernel B8 on the regex path's fields, a synthetic dictionary and the edge set
    first_of_kind = []
    for spec in regex_specs[:3]:
        part = next(p for p in make(spec, index).search_req.walk_parts() if p.is_regex)
        first_of_kind.append(part.terms[0])
    regex_rows, regex_pair_rows, regex_timed = regex_phase(regex_dfa, index, first_of_kind, report)
    torch.cuda.empty_cache()

    # ---- B10 at the boost_term mix's first request
    term_boost_call = term_boost_phase(boost, index,
                                       make(feat_mixes["boost_term"][0], index).boost_term, report)

    # ---- the fused select (B2) on the main path's specs and at title x 1
    select_row, select_args = select_phase(levenshtein_sweep, levenshtein, field_search, select_calls,
                                           title, title_words, rng, report)
    del select_calls

    # ---- profiler measurements, after every CUDA-event and host-clock timing
    dense_device_phase(postings, dense_rows, dense_args)
    del dense_args
    report["term_boost"]["device_ms"] = sum(device_ms(term_boost_call).values())
    log(f"B10 term-boost factor: device time (profiler) {report['term_boost']['device_ms']:.4f} ms")
    for name, (args, dfa) in regex_timed.items():
        pair = name in regex_pair_rows
        row = regex_pair_rows[name] if pair else regex_rows[name]
        entry = regex_dfa.regex_match_pair if pair else regex_dfa.regex_match
        row["kernel_alone_ms"] = kernel_only_ms(lambda: entry(*args, dfa, False), "dfa_walk_kernel")
        log(f"kernel {entry.__name__} {name}: kernel alone (profiler device events) "
            f"{ms_text(row['kernel_alone_ms'])}")
    del regex_timed
    select_row["kernel_ms"] = kernel_only_ms(
        lambda: levenshtein_sweep.levenshtein_select_banded(*select_args), "banded_select_kernel")
    log(f"select at title x 1, band 2, d 2: fused kernel alone (profiler device events) "
        f"{ms_text(select_row['kernel_ms'])}")

    profiled = {name: ([make(d, index) for d in batches[1]], lambda reqs: vt.search_batch(reqs, index))
                for name, batches in requests_of.items()
                if name not in DENSE_ONLY and name not in ("why_found", "suggest")}
    profiled.update({
        name: ([make(d, index) for d in reqs[:PROFILED_EXECUTOR_REQUESTS]],
               lambda reqs, name=name: answer(name, reqs, index))
        for name, reqs in (*ex_mixes.items(), ("regex", regex_specs),
                           *((n, feat_mixes[n]) for n in FEATURE_LONE))
    })
    profiled.update({  # the why_found batch and the suggest batch, whole
        name: ([make(d, index) for d in feat_mixes[name]], lambda reqs, name=name: answer(name, reqs, index))
        for name in ("why_found", "suggest")
    })
    profiled["server_concurrent"] = (traffic["search_concurrent"], lambda calls: burst(server_url, calls))
    profiled["mesh_lone"] = ([r for reqs in mesh_lone.values() for r in reqs[:MESH_PROFILED]],
                             lambda reqs: with_mesh(index, mesh_ctx, lambda: [vt.search(r, index) for r in reqs]))
    profiled["mesh_batch"] = (mesh_batch, lambda reqs: with_mesh(index, mesh_ctx, lambda: vt.search_batch(reqs, index)))
    profile_phase(profiled, report)
    local_server.shutdown()
    enc, n_chars = levenshtein.encode_query(mutate(str(title_words[len(title_words) // 3]), 1, rng))
    b2_query = torch.from_numpy(enc).cuda()
    b2_qlen = torch.tensor([n_chars], dtype=torch.int32, device="cuda")
    b2_kernel_ms = kernel_only_ms(
        lambda: levenshtein_sweep.levenshtein_sweep_banded(
            title.chars_t, title.lengths, b2_query, b2_qlen, band=2),
        "banded_sweep_kernel",
    )
    report["b2_kernel_only_ms"] = b2_kernel_ms
    log(f"B2 (old single-query entry) at title x 1, band 2: kernel alone (profiler device events) "
        f"{ms_text(b2_kernel_ms)}, "
        f"call (CUDA events) {kernel_times[('title', 1, 2)][0]:.4f} ms")
    # B1 at title x 256, band 2, and B3 at the main path's shape and at
    # title x 256, each kernel alone
    alone = {
        "B1 title x 256, band 2": (lambda: levenshtein_sweep.levenshtein_sweep_banded_batch(
            *title_args[2], band=2), "banded_sweep_kernel", kernel_times[("title", 256, 2)][0]),
        f"B3 main path ({main_full['field']}, N={main_full['terms']}, Q={main_full['queries']})": (
            lambda: levenshtein_sweep.levenshtein_sweep_full_batch(*main_full_args), "full_sweep_kernel",
            main_full["kernel_ms"]),
        "B3 title x 256": (lambda: levenshtein_sweep.levenshtein_sweep_full_batch(*title_args[None]),
                           "full_sweep_kernel", kernel_times[("title", 256, None)][0]),
    }
    report["sweep_kernel_only_ms"] = {}
    for name, (fn, kernel, call_ms) in alone.items():
        report["sweep_kernel_only_ms"][name] = kernel_only_ms(fn, kernel)
        log(f"{name}: kernel alone (profiler device events) {ms_text(report['sweep_kernel_only_ms'][name])}, "
            f"call (CUDA events) {call_ms:.4f} ms")
    del title_args, main_full_args

    # B1 and B2's old single-query entry at the kernel phase's title shapes
    # (band 2, Q 256 and 1; the old entry is no longer on the main path);
    # the fused select at title x 1, band 2, d 2; B3 at the main path's most
    # frequent full-width shape, on its own inputs. No single PyTorch call
    # computes a Levenshtein sweep: library_ms is null.
    b1, b2 = kernel_times[("title", 256, 2)], kernel_times[("title", 1, 2)]
    kernels = [
        {"name": "levenshtein_sweep_banded_batch", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/banded_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:341",
         "launches": launches["levenshtein_sweep_banded_batch"],
         "max_abs_err": kernel_err["batch"], "ms": b1[0], "plain_ms": b1[1],
         "bound_ms": b1[2], "bound_by": b1[3], "library_ms": None},
        {"name": "levenshtein_sweep_banded", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/banded_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:412",
         "launches": launches["levenshtein_sweep_banded"],
         "max_abs_err": kernel_err["single"], "ms": b2[0], "plain_ms": b2[1],
         "bound_ms": b2[2], "bound_by": b2[3], "library_ms": None},
        {"name": "levenshtein_select_banded", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/banded_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:412",
         "launches": launches["levenshtein_select_banded"], "max_abs_err": select_row["max_abs_err"],
         "ms": select_row["call_ms"], "plain_ms": select_row["plain_ms"],
         "bound_ms": select_row["bound_ms"], "bound_by": select_row["bound_by"], "library_ms": None},
        {"name": "levenshtein_sweep_full_batch", "route": "cuda",
         "source": "veloci_tpu_torch/csrc/full_levenshtein.cu",
         "replaces": "veloci_tpu/ops/pallas_levenshtein.py:72",
         "launches": launches["levenshtein_sweep_full_batch"],
         "max_abs_err": kernel_err["full"], "ms": main_full["kernel_ms"],
         "plain_ms": main_full["plain_ms"], "bound_ms": main_full["bound_ms"],
         "bound_by": main_full["bound_by"], "library_ms": None},
    ]
    # B7 at the main path's largest multi-term leaf, its direct path (the
    # main path's); the library call is one scatter_reduce_ "amax" over the
    # rows the plain version gathers
    b7 = dense_rows["title multi-term leaf"]
    kernels.append(
        {"name": "dense_resolve", "route": "cuda", "source": "veloci_tpu_torch/csrc/dense_resolve.cu",
         "replaces": "veloci_tpu/ops/postings.py:83", "launches": launches["dense_resolve"],
         "max_abs_err": max(r["max_abs_err"] for r in dense_rows.values()), "ms": b7["kernel_ms"],
         "plain_ms": b7["plain_ms"], "bound_ms": b7["bound_ms"], "bound_by": b7["bound_by"],
         "library_ms": b7["library_ms"]})
    # B8: its single-matrix entry at the regex phase's largest launch shape
    # of the index (the most chars walked), and its two-matrix entry, the
    # main path's, at the title field's leaf; their first pattern, full
    # mode; no PyTorch call walks a DFA: library_ms is null
    b8 = max((regex_rows[k] for k in ("title sweep rows", "title long rows", "ent_seq sweep rows")),
             key=lambda r: r["chars_walked"])
    b8_pair = regex_pair_rows["title field"]
    for name, row in (("regex_match", b8), ("regex_match_pair", b8_pair)):
        kernels.append(
            {"name": name, "route": "cuda", "source": "veloci_tpu_torch/csrc/regex_dfa.cu",
             "replaces": "veloci_tpu/ops/regex_dfa.py:339", "launches": launches[name],
             "max_abs_err": max(r["max_abs_err"] for r in (*regex_rows.values(), *regex_pair_rows.values())),
             "ms": row["kernel_ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": None})
    for row in kernels:  # each kernel's launches on the mesh path, of those in "launches"
        row["mesh_launches"] = path_launches["mesh"][row["name"]]
    report["kernels"] = kernels
    report["launches"] = launches
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_report.json").write_text(json.dumps(report, indent=1))

    log(f"chip_smoke.py: {time.perf_counter() - t_start:.1f} s in all")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
