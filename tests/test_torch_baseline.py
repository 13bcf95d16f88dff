"""The port's single-core CPU baselines against the JAX package's.

``veloci_tpu_torch.native``'s ``baseline_exact_topk``,
``baseline_encode_vint`` / ``baseline_exact_topk_vint`` and
``baseline_fuzzy_index`` / ``baseline_fuzzy_topk`` run beside
``veloci_tpu.native``'s on the same inputs: anchor-score CSRs made with
numpy from a seed (keys with no postings among them) and the
``meanings.ger[]`` field of ``tests/corpus``'s index, queries of 1 to 3
terms in distinct and shared slots with -1 pads, ``top_n`` below and above
the hits, fuzzy queries of 1 and 32 chars at distances 0 to 3 over a
dictionary with terms longer than 32 chars. The exact baseline is also held
to a plain numpy version of its semantics, and the fuzzy one's match counts
to the host distance.

Tolerance: exact, everywhere (ids, f32 score bits, hit and match counts,
the vint blob's bytes and the fuzzy index's arrays)."""

import numpy as np
import pytest

from corpus import TEST_CONFIG, data_ndjson
from veloci_tpu import Persistence as RefPersistence
from veloci_tpu import native as ref_native
from veloci_tpu.indices import TermDictionary as RefTermDictionary
from veloci_tpu_torch import Persistence, create_indices_from_str, native
from veloci_tpu_torch.indices import TermDictionary
from veloci_tpu_torch.ops.levenshtein import encode_query, levenshtein_distance_host
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

pytestmark = pytest.mark.skipif(not native.baseline_available(), reason="native library unavailable (no g++)")

FIELD = "meanings.ger[]"


def _synthetic_csr(seed: int, num_keys: int = 300, num_docs: int = 5000):
    """A CSR with ascending anchors a key, about one key in five empty."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, size=num_keys)
    counts[rng.random(num_keys) < 0.2] = 0
    counts[int(rng.integers(num_keys))] = 2000  # one dense key
    offsets = np.zeros(num_keys + 1, dtype=np.uint64)
    np.cumsum(counts, out=offsets[1:])
    anchors = np.concatenate([np.sort(rng.choice(num_docs, size=int(c), replace=False)) for c in counts])
    scores = rng.integers(1, 65535, size=len(anchors), dtype=np.uint16)
    return offsets, anchors.astype(np.uint32), scores


def _queries(seed: int, num_keys: int, nq: int, t_per_q: int, slots: str):
    """Term ids (some -1 pads, some keys out of range), term scores and
    slots: ``distinct`` (one a term), ``shared`` (all in slot 0) or
    ``mixed`` (two slots for three terms)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num_keys, size=(nq, t_per_q)).astype(np.int32)
    if t_per_q > 1:
        ids[rng.random((nq, t_per_q)) < 0.2] = -1
    ids[0, 0] = -1  # a query whose first term is a pad
    ids[-1, 0] = num_keys  # a key out of range: skipped as a pad
    tscores = rng.choice(np.array([10.0, 7.5, 3.0, 0.25], dtype=np.float32), size=(nq, t_per_q))
    if slots == "distinct":
        tslots = np.broadcast_to(np.arange(t_per_q, dtype=np.int32), (nq, t_per_q)).copy()
    elif slots == "shared":
        tslots = np.zeros((nq, t_per_q), dtype=np.int32)
    else:
        tslots = np.broadcast_to(np.array([0, 1, 0], dtype=np.int32)[:t_per_q], (nq, t_per_q)).copy()
    return ids, tscores.astype(np.float32), tslots


def _plain_exact(offsets, anchors, scores, ids, tscores, tslots, top_n):
    """The exact baseline's semantics in numpy: max a (slot, anchor); over
    two slots or more, the slots' f32 sum in slot order times the square of
    the slots that scored at least 1e-5; top_n by (score, id) descending."""
    out_ids = np.zeros((len(ids), top_n), np.uint32)
    out_scores = np.zeros((len(ids), top_n), np.float32)
    out_hits = np.zeros(len(ids), np.int32)
    num_keys = len(offsets) - 1
    for q in range(len(ids)):
        valid = [t for t in range(ids.shape[1]) if 0 <= ids[q, t] < num_keys]
        n_slots = max((int(tslots[q, t]) + 1 for t in range(ids.shape[1]) if ids[q, t] >= 0), default=0)
        per_slot = [dict() for _ in range(n_slots)]
        for t in valid:
            s, e = int(offsets[ids[q, t]]), int(offsets[ids[q, t] + 1])
            hit = tscores[q, t] * (scores[s:e].astype(np.float32) / np.float32(100.0))
            best = per_slot[tslots[q, t]]
            for a, sc in zip(anchors[s:e].tolist(), hit):
                best[a] = max(best.get(a, np.float32(-np.inf)), sc)
        if n_slots <= 1:
            merged = per_slot[0] if n_slots else {}
        else:
            merged = {}
            for a in sorted(set().union(*per_slot)):
                total, scored = np.float32(0.0), 0
                for best in per_slot:
                    if a in best:
                        total = np.float32(total + best[a])
                        scored += best[a] >= np.float32(1e-5)
                merged[a] = np.float32(total * np.float32(scored) * np.float32(scored))
        ranked = sorted(merged.items(), key=lambda kv: (-kv[1], -kv[0]))[:top_n]
        out_hits[q] = len(merged)
        for i, (a, sc) in enumerate(ranked):
            out_ids[q, i], out_scores[q, i] = a, sc
    return out_ids, out_scores, out_hits


def _assert_same(got, want):
    """Outputs equal: ids and counts, scores to the f32 bit."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == np.float32:
            assert np.array_equal(g.view(np.uint32), w.view(np.uint32))
        else:
            assert np.array_equal(g, w)


@pytest.fixture(scope="module")
def corpus_stores():
    """``meanings.ger[]``'s CSR and dictionary, built by each package."""
    ref = RefPersistence.create_from_str(data_ndjson(), TEST_CONFIG)
    port = Persistence.from_built(create_indices_from_str(data_ndjson(), TEST_CONFIG))
    path = f"{FIELD}.textindex.to_anchor_id_score"
    return ((ref.anchor_scores[path], ref.get_dictionary(FIELD)),
            (port.anchor_scores[path], port.get_dictionary(FIELD)))


@pytest.mark.parametrize("top_n", [1, 10, 10_000], ids=["top1", "top10", "top_above_hits"])
@pytest.mark.parametrize("t_per_q, slots", [(1, "distinct"), (2, "distinct"), (2, "shared"), (3, "distinct"),
                                            (3, "shared"), (3, "mixed")])
def test_exact_topk_equals_the_reference(t_per_q, slots, top_n):
    offsets, anchors, scores = _synthetic_csr(t_per_q * 7 + len(slots))
    ids, tscores, tslots = _queries(t_per_q, len(offsets) - 1, 64, t_per_q, slots)
    got = native.baseline_exact_topk(offsets, anchors, scores, ids, tscores, tslots, top_n)
    want = ref_native.baseline_exact_topk(offsets, anchors, scores, ids, tscores, tslots, top_n)
    _assert_same(got, want)
    assert (got[2] > 0).any() and (got[2] == 0).any()  # hits, and a query of pads / empty keys only
    if top_n == 10_000:
        assert (got[2] < top_n).all()
    if top_n <= 10:
        _assert_same(got, _plain_exact(offsets, anchors, scores, ids, tscores, tslots, top_n))


@pytest.mark.parametrize("t_per_q", [1, 2, 3])
def test_vint_equals_the_reference(t_per_q):
    offsets, anchors, scores = _synthetic_csr(40 + t_per_q)
    vint, ref_vint = native.baseline_encode_vint(offsets, anchors, scores), ref_native.baseline_encode_vint(
        offsets, anchors, scores)
    assert isinstance(vint, native.VintBaselineIndex) and vint.num_keys == ref_vint.num_keys == len(offsets) - 1
    assert vint.blob.tobytes() == ref_vint.blob.tobytes()
    assert vint.blob_offsets.tobytes() == ref_vint.blob_offsets.tobytes()
    ids, tscores, tslots = _queries(50 + t_per_q, len(offsets) - 1, 64, t_per_q, "shared")
    for top_n in (10, 10_000):
        got = native.baseline_exact_topk_vint(vint, ids, tscores, top_n)
        _assert_same(got, ref_native.baseline_exact_topk_vint(ref_vint, ids, tscores, top_n))
        # the vint loop is the raw loop with every term in one slot
        _assert_same(got, native.baseline_exact_topk(offsets, anchors, scores, ids, tscores, tslots, top_n))


def test_exact_on_the_corpus_index(corpus_stores):
    (ref_store, _), (store, dictionary) = corpus_stores
    for name in ("offsets", "anchors", "scores"):
        assert np.array_equal(getattr(store, name), getattr(ref_store, name))
    n = store.num_keys
    ids = np.arange(-1, n + 1, dtype=np.int32).reshape(-1, 1)  # every key, a pad and one past the end
    tscores = np.full(ids.shape, 10.0, np.float32)
    tslots = np.zeros(ids.shape, np.int32)
    for top_n in (3, 10_000):
        got = native.baseline_exact_topk(store.offsets, store.anchors, store.scores, ids, tscores, tslots, top_n)
        _assert_same(got, ref_native.baseline_exact_topk(ref_store.offsets, ref_store.anchors, ref_store.scores,
                                                         ids, tscores, tslots, top_n))
        empty = np.diff(store.offsets.astype(np.int64)) == 0
        assert (got[2][1:-1][empty] == 0).all() and got[2][0] == got[2][-1] == 0
    vint = native.baseline_encode_vint(store.offsets, store.anchors, store.scores)
    ref_vint = ref_native.baseline_encode_vint(ref_store.offsets, ref_store.anchors, ref_store.scores)
    assert vint.blob.tobytes() == ref_vint.blob.tobytes()
    _assert_same(native.baseline_exact_topk_vint(vint, ids, tscores, 10),
                 ref_native.baseline_exact_topk_vint(ref_vint, ids, tscores, 10))


def _fuzzy_terms(seed: int):
    """Lowercase and mixed-case words over a small alphabet, of 1-12 chars,
    one of exactly 32, two past 32, a non-ASCII one."""
    rng = np.random.default_rng(seed)
    letters = list("abcdeéx")
    words = {"".join(rng.choice(letters, size=int(rng.integers(1, 13)))) for _ in range(400)}
    words |= {"Abc", "ABCD", "a" * 32, "ab" * 17, "b" * 40, "größe"}
    return sorted(words)


def _fuzzy_queries(terms, seed: int):
    rng = np.random.default_rng(seed)
    picked = [t.lower() for t in rng.choice(terms, size=40)]
    texts = ["a", "x", "a" * 32, "ab" * 16, "b" * 32, *picked]
    queries = np.zeros((len(texts) * 4, 32), np.uint16)
    qlens = np.zeros(len(texts) * 4, np.int32)
    dists = np.zeros(len(texts) * 4, np.int32)
    for i, text in enumerate(texts):
        for d in range(4):
            queries[4 * i + d], qlens[4 * i + d] = encode_query(text)
            dists[4 * i + d] = d
    return texts, queries, qlens, dists


def test_fuzzy_index_equals_the_reference():
    terms = _fuzzy_terms(3)
    got, want = native.baseline_fuzzy_index(TermDictionary(terms)), ref_native.baseline_fuzzy_index(
        RefTermDictionary(terms))
    assert isinstance(got, native.FuzzyBaselineIndex)
    for name in ("chars", "lens", "row_tid"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    long_ids = {i for i, t in enumerate(terms) if len(t) > 32}
    assert long_ids and not long_ids & set(got.row_tid.tolist())  # terms past 32 chars are not in the walk
    rows = [tuple(r) for r in got.chars.tolist()]
    assert rows == sorted(rows)


@pytest.mark.parametrize("top_n", [10, 10_000], ids=["top10", "top_above_hits"])
def test_fuzzy_topk_equals_the_reference(top_n):
    terms = _fuzzy_terms(3)
    offsets, anchors, scores = _synthetic_csr(5, num_keys=len(terms))
    index, ref_index = native.baseline_fuzzy_index(TermDictionary(terms)), ref_native.baseline_fuzzy_index(
        RefTermDictionary(terms))
    texts, queries, qlens, dists = _fuzzy_queries(terms, 4)
    got = native.baseline_fuzzy_topk(index, queries, qlens, dists, offsets, anchors, scores, top_n)
    _assert_same(got, ref_native.baseline_fuzzy_topk(ref_index, queries, qlens, dists, offsets, anchors,
                                                     scores, top_n))
    for row in range(len(queries)):
        text, d = texts[row // 4], int(dists[row])
        brute = sum(1 for t in terms if len(t) <= 32 and levenshtein_distance_host(text, t.lower()) <= d)
        assert int(got[3][row]) == brute, (text, d)
    assert (got[3][0::4] > 0).any() and (got[2] > 0).any()


def test_fuzzy_on_the_corpus_index(corpus_stores):
    (ref_store, ref_dictionary), (store, dictionary) = corpus_stores
    index, ref_index = native.baseline_fuzzy_index(dictionary), ref_native.baseline_fuzzy_index(ref_dictionary)
    for name in ("chars", "lens", "row_tid"):
        assert np.array_equal(getattr(index, name), getattr(ref_index, name))
    texts = ["majestät", "majestätischer", "anblik", "ausehen", "urkunde", "zz", "a"]
    queries = np.zeros((len(texts) * 4, 32), np.uint16)
    qlens, dists = np.zeros(len(texts) * 4, np.int32), np.tile(np.arange(4, dtype=np.int32), len(texts))
    for i, text in enumerate(texts):
        for d in range(4):
            queries[4 * i + d], qlens[4 * i + d] = encode_query(text)
    got = native.baseline_fuzzy_topk(index, queries, qlens, dists, store.offsets, store.anchors, store.scores, 10)
    _assert_same(got, ref_native.baseline_fuzzy_topk(ref_index, queries, qlens, dists, ref_store.offsets,
                                                     ref_store.anchors, ref_store.scores, 10))
    assert (got[2] > 0).any()


def test_baselines_return_none_without_the_library(monkeypatch):
    offsets, anchors, scores = _synthetic_csr(1)
    ids, tscores, tslots = _queries(1, len(offsets) - 1, 4, 1, "distinct")
    monkeypatch.setenv("VELOCI_TPU_NO_NATIVE", "1")
    for module in (native, ref_native):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_LIB_TRIED", False)
        assert not module.baseline_available()
        assert module.baseline_exact_topk(offsets, anchors, scores, ids, tscores, tslots, 10) is None
        assert module.baseline_encode_vint(offsets, anchors, scores) is None
        assert module.baseline_fuzzy_index(TermDictionary(["a", "b"])) is None
