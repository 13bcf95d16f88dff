"""Port tests that need a CUDA device: the hand-written sweep kernels (banded
and full-width, the fused lone-request select), the dense resolve (both
its paths) and the regex DFA walk (B8) against their plain PyTorch versions
on the card, the ``boost_term`` factor (B10) on the card against the CPU's,
and the slice (``search_batch`` and ``search``, regex leaves, document
reads, ``boost_term``, ``text_locality``, ``why_found``, suggest and
``TorchIndex.warmup`` included) on the card against the same index on the
CPU. Tolerance: exact equality (integer
outputs; the same f32 products, maxima order-free, and sums taken in the
same order, on both devices).

They carry the ``cuda`` marker and skip where no card is present. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import concurrent.futures

import numpy as np
import pytest

import torch

from veloci_tpu_torch import (
    Persistence,
    Request,
    SearchQueryGeneratorParameters,
    TorchIndex,
    create_indices_from_str,
    search,
    search_batch,
    search_query,
    search_to_result_with_doc,
    suggest_batch,
    suggest_query,
)
from veloci_tpu_torch.ops.postings import (
    dense_fast_path,
    dense_max_row_score,
    dense_resolve,
    dense_resolve_args,
    dense_resolve_plain,
)
from veloci_tpu_torch.ops.levenshtein import encode_query
from veloci_tpu_torch.ops.regex_dfa import (
    CompiledDfa,
    compile_dfa,
    regex_match,
    regex_match_pair,
    regex_match_pair_plain,
    regex_match_plain,
)
from veloci_tpu_torch.ops.levenshtein_sweep import (
    levenshtein_select_banded,
    levenshtein_select_banded_plain,
    levenshtein_sweep_banded,
    levenshtein_sweep_banded_batch,
    levenshtein_sweep_banded_batch_plain,
    levenshtein_sweep_full_batch,
    levenshtein_sweep_full_batch_plain,
)
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _dictionary(n, rng):
    lens = rng.integers(0, 33, size=n).astype(np.int32)
    chars = rng.integers(97, 103, size=(32, n)).astype(np.uint16)
    chars[np.arange(32)[:, None] >= lens[None, :]] = 0
    return chars, lens


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 4])
def test_kernel_equals_plain_on_card(card, band):
    rng = np.random.default_rng(band)
    chars, lens = _dictionary(5003, rng)
    words = ["", "a", "abc", "fedcba" * 5 + "a", "b" * 32] + [
        "".join(rng.choice(list("abcdef"), size=int(k))) for k in rng.integers(1, 14, 65)
    ]
    enc = [encode_query(w) for w in words]  # 70 queries: crosses a 64-query chunk
    queries = torch.from_numpy(np.stack([q for q, _n in enc])).to(card)
    qlens = torch.tensor([n for _q, n in enc], dtype=torch.int32, device=card)
    chars_t, lens_t = torch.from_numpy(chars).to(card), torch.from_numpy(lens).to(card)

    before = levenshtein_sweep_banded_batch.launches
    got = levenshtein_sweep_banded_batch(chars_t, lens_t, queries, qlens, band=band)
    want = levenshtein_sweep_banded_batch_plain(chars_t, lens_t, queries, qlens, band=band)
    torch.cuda.synchronize()
    assert levenshtein_sweep_banded_batch.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)

    before = levenshtein_sweep_banded.launches
    one = levenshtein_sweep_banded(chars_t, lens_t, queries[3], qlens[3:4], band=band)
    assert levenshtein_sweep_banded.launches == before + 1
    for g, w in zip(one, want):
        assert torch.equal(g, w[3])


@pytest.mark.cuda
def test_full_kernel_equals_plain_on_card(card):
    rng = np.random.default_rng(5)
    chars, lens = _dictionary(5003, rng)
    words = ["", "a", "abc", "fedcba" * 5 + "a", "b" * 32, "é日"] + [
        "".join(rng.choice(list("abcdef"), size=int(k))) for k in rng.integers(1, 33, 64)
    ]
    enc = [encode_query(w) for w in words]  # 70 queries: crosses a 64-query chunk
    queries = torch.from_numpy(np.stack([q for q, _n in enc])).to(card)
    qlens = torch.tensor([n for _q, n in enc], dtype=torch.int32, device=card)
    chars_t, lens_t = torch.from_numpy(chars).to(card), torch.from_numpy(lens).to(card)

    before = levenshtein_sweep_full_batch.launches
    got = levenshtein_sweep_full_batch(chars_t, lens_t, queries, qlens)
    want = levenshtein_sweep_full_batch_plain(chars_t, lens_t, queries, qlens)
    torch.cuda.synchronize()
    assert levenshtein_sweep_full_batch.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0][:, lens > 0].max()) > 4  # true distances beyond any band


@pytest.mark.cuda
def test_search_on_card_equals_cpu(card):
    rng = np.random.default_rng(11)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)] + ["Apple", "apple"]
    docs = "\n".join(
        '{"title": "%s"}' % " ".join(rng.choice(vocab, size=5)) for _ in range(3000)
    )
    pers = Persistence.from_built(create_indices_from_str(docs, "{}"))
    on_cpu = TorchIndex.from_persistence(pers, "cpu")
    on_card = TorchIndex.from_persistence(pers, card)
    dicts = [
        {"search_req": {"search": {"terms": [t], "path": "title", **kw}}, "top": 20}
        for t, kw in [
            ("w1bb", {}), ("apple", {}), ("w1ab", {"levenshtein_distance": 1}),
            ("w2ccc", {"levenshtein_distance": 2}), ("w3dddd", {"levenshtein_distance": 3}),
        ]
    ]
    leaf = {"search": {"terms": ["w1bb"], "path": "title"}}
    dicts += [
        {"search_req": {"search": {"terms": ["w1a"], "path": "title", "starts_with": True,
                                   "levenshtein_distance": 1}}},
        {"search_req": {"search": {"terms": ["w1bbbbb"], "path": "title", "levenshtein_distance": 5}}},
        {"search_req": {"and": {"queries": [leaf, {"or": {"queries": [
            {"search": {"terms": ["w2ccc"], "path": "title"}},
            {"search": {"terms": ["w3dddd"], "path": "title", "levenshtein_distance": 1}},
            {"search": {"terms": ["w10"], "path": "title"}}]}}]}}},
        {"search_req": {"or": {"queries": [leaf, {"and": {"queries": [
            {"search": {"terms": ["w2ccc"], "path": "title"}},
            {"search": {"terms": ["w1b"], "path": "title", "starts_with": True}}]}}]}}},
    ]
    reqs = [Request.from_dict(d) for d in dicts]
    reqs += [search_query(on_card, SearchQueryGeneratorParameters(search_term=q))
             for q in ("w1ab*", "w2ccc AND w1bb*", "w10 OR w1bb AND w2ccc")]
    for batch in (reqs, reqs[3:4], reqs[5:6]):  # batched sweeps, then single queries
        for a, b in zip(search_batch(batch, on_card), search_batch(batch, on_cpu)):
            assert a.num_hits == b.num_hits
            assert [(h.id, h.score) for h in a.data] == [(h.id, h.score) for h in b.data]
    assert on_card.path_counts["batched_tree_deep"] > 0


@pytest.mark.cuda
def test_generic_route_on_card_equals_cpu(card):
    """Filters, boost columns, facets and phrase boosts on the card against
    the CPU plain path: ids, scores, num_hits and facet lists identical."""
    rng = np.random.default_rng(12)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)]
    docs = "\n".join(
        '{"title": "pa pb %s", "cat": "c%d", "pop": %d}'
        % (" ".join(rng.choice(vocab, size=5)), rng.integers(16), rng.integers(0, 1000))
        for _ in range(3000)
    )
    config = '["*GLOBAL*"]\nfeatures = ["All"]\n["cat"]\nfacet = true\n["pop".boost]\nboost_type = "f32"\n'
    pers = Persistence.from_built(create_indices_from_str(docs, config))
    on_cpu = TorchIndex.from_persistence(pers, "cpu")
    on_card = TorchIndex.from_persistence(pers, card)
    leaf = {"search": {"terms": ["w1bb"], "path": "title"}}
    cat3 = {"search": {"terms": ["c3"], "path": "cat"}}
    extras = {"facets": [{"field": "cat", "top": 5}], "boost": [{"path": "pop", "boost_fun": "Log10", "param": 1}],
              "phrase_boosts": [{"search1": {"terms": ["pa"], "path": "title"},
                                 "search2": {"terms": ["pb"], "path": "title"}}]}
    dicts = [
        dict({"search_req": leaf}, filter=cat3),
        dict({"search_req": {"search": {"terms": ["w2ccc"], "path": "title", "levenshtein_distance": 2}}},
             **extras),
        dict({"search_req": {"and": {"queries": [{"search": {"terms": ["pa"], "path": "title"}}, {"or": {
            "queries": [leaf, {"search": {"terms": ["w1a"], "path": "title", "starts_with": True,
                                          "levenshtein_distance": 1}}]}}]}}},
             filter={"or": {"queries": [cat3, {"search": {"terms": ["c13"], "path": "cat",
                                                          "levenshtein_distance": 1}}]}}, **extras),
    ]
    reqs = [Request.from_dict(d) for d in dicts]
    reqs += [search_query(on_card, SearchQueryGeneratorParameters(
        search_term="pa pb w1a*", facets=["cat"], phrase_pairs=True, filter="cat:c3 OR cat:c7"))]
    for batch in (reqs, reqs[1:2]):
        for a, b in zip(search_batch(batch, on_card), search_batch(batch, on_cpu)):
            assert a.num_hits == b.num_hits and a.facets == b.facets
            assert [(h.id, h.score) for h in a.data] == [(h.id, h.score) for h in b.data]
    assert on_card.path_counts["batched_generic"] == len(reqs) + 1


@pytest.mark.cuda
def test_dense_resolve_equals_plain_on_card(card):
    """Kernel B7 against its plain version: repeated anchors across terms,
    empty runs, a repeated term, anchors past num_docs; bit-equal."""
    rng = np.random.default_rng(13)
    num_keys, num_docs = 4000, 50_000
    counts = rng.integers(0, 3000, num_keys)
    counts[rng.random(num_keys) < 0.2] = 0
    offsets = np.zeros(num_keys + 2, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:-1])
    offsets[-1] = offsets[-2]
    anchors = np.concatenate([np.sort(rng.choice(num_docs + 50, size=c, replace=False)) for c in counts])
    scores01 = rng.integers(0, 60000, len(anchors)).astype(np.float32) / np.float32(100.0)
    packed = torch.from_numpy(np.stack([anchors.astype(np.int32), scores01.view(np.int32)], axis=1)).to(card)
    offsets_t = torch.from_numpy(offsets).to(card)
    for t in (0, 1, 7, 600):
        tids = rng.integers(0, num_keys, t)
        if t > 1:
            tids[1] = tids[0]
        starts = np.zeros(t + 1, dtype=np.int64)
        np.cumsum(offsets[tids + 1] - offsets[tids], out=starts[1:])
        args = (offsets_t, packed, torch.from_numpy(tids.astype(np.int32)).to(card),
                torch.from_numpy((rng.integers(1, 400, t) / np.float32(37.0)).astype(np.float32)).to(card),
                torch.from_numpy(starts).to(card), int(starts[-1]), num_docs)
        before = dense_resolve.launches
        got = dense_resolve(*args)
        want = dense_resolve_plain(*args)
        torch.cuda.synchronize()
        assert dense_resolve.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert t == 0 or int((got > 0).sum()) > 0


@pytest.mark.cuda
def test_executor_on_card_equals_cpu(card):
    """``search`` on the card against the CPU plain path: deep trees,
    leaves with several terms, a 1:n boost, facets past the batched gate
    and the executor's extras; ids, scores, num_hits and facets identical."""
    rng = np.random.default_rng(14)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)]
    docs = "\n".join(
        '{"title": "pa pb %s", "cat": "c%d", "pop": %d, "nr": "%d", "parts": [{"name": "%s", "rank": %d}, '
        '{"name": "%s", "rank": %d}]}'
        % (" ".join(rng.choice(vocab, size=5)), rng.integers(16), rng.integers(0, 1000), i,
           rng.choice(vocab[:50]), rng.integers(0, 9), rng.choice(vocab[:50]), rng.integers(0, 9))
        for i in range(3000)
    )
    config = ('["*GLOBAL*"]\nfeatures = ["All"]\n["cat"]\nfacet = true\n["pop".boost]\nboost_type = "f32"\n'
              '["parts[].rank".boost]\nboost_type = "f32"\n')
    pers = Persistence.from_built(create_indices_from_str(docs, config))
    on_cpu = TorchIndex.from_persistence(pers, "cpu")
    on_card = TorchIndex.from_persistence(pers, card)

    def leaf(t, path="title", **kw):
        return {"search": dict({"terms": t if isinstance(t, list) else [t], "path": path}, **kw)}

    def node(kind, *qs):
        return {kind: {"queries": list(qs)}}

    dicts = [
        {"search_req": node("and", node("or", node("and", leaf("w1bb"), leaf("w2ccc", levenshtein_distance=1)),
                                        leaf("w1", starts_with=True)), leaf("pa"))},
        {"search_req": leaf(["w1bb", "w2ccc"], levenshtein_distance=1), "facets": [{"field": "nr", "top": 3}]},
        {"search_req": leaf(vocab[3], "parts[].name"),
         "boost": [{"path": "parts[].rank", "boost_fun": "Log10", "param": 1}]},
        {"search_req": node("or", leaf("w10"), leaf("w1bb")), "facets": [{"field": "cat"}],
         "filter": leaf("c3", "cat"), "boost": [{"path": "pop", "boost_fun": "Log10", "param": 1}],
         "phrase_boosts": [{"search1": leaf("pa")["search"], "search2": leaf("pb")["search"]}]},
    ]
    reqs = [Request.from_dict(d) for d in dicts]
    before = dense_resolve.launches
    for dense_only in (False, True):
        for req in reqs:
            a, b = search(req, on_card, dense_only=dense_only), search(req, on_cpu, dense_only=dense_only)
            assert a.num_hits == b.num_hits > 0 and a.facets == b.facets
            assert [(h.id, h.score) for h in a.data] == [(h.id, h.score) for h in b.data]
    assert on_card.path_counts["executor"] == len(reqs) + 3 and dense_resolve.launches > before


@pytest.mark.cuda
def test_mesh_on_card_equals_unsharded(card):
    """An 8-shard mesh and a [2, 4] mesh on the card answer ``search``,
    ``search(dense_only=True)`` and ``search_batch`` as the unsharded index
    on the card does, bit for bit, launching B7 and the fused select."""
    from veloci_tpu_torch.parallel.mesh_executor import build_doc_mesh
    from veloci_tpu_torch.parallel.sharding import build_mesh

    rng = np.random.default_rng(15)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)]
    docs = "\n".join('{"title": "%s", "cat": "c%d", "pop": %d}' % (" ".join(rng.choice(vocab, size=5)),
                                                                  rng.integers(16), rng.integers(0, 1000))
                     for _ in range(3000))
    config = '["*GLOBAL*"]\nfeatures = ["All"]\n["cat"]\nfacet = true\n["pop".boost]\nboost_type = "f32"\n'
    index = TorchIndex.from_persistence(Persistence.from_built(create_indices_from_str(docs, config)), card)

    def leaf(t, **kw):
        return {"search": dict({"terms": [t], "path": "title"}, **kw)}

    boost = [{"path": "pop", "boost_fun": "Log10", "param": 1}]
    dicts = [
        {"search_req": leaf(vocab[1])},
        {"search_req": {"or": {"queries": [leaf(vocab[2]), leaf(vocab[9])]}}, "facets": [{"field": "cat"}],
         "filter": {"search": {"terms": ["c3"], "path": "cat"}}, "boost": boost},
        {"search_req": leaf(vocab[5] + "x", levenshtein_distance=1)},
        {"search_req": {"and": {"queries": [leaf(vocab[1]), leaf(vocab[4])]}}, "boost": boost},
        {"search_req": {"or": {"queries": [{"and": {"queries": [leaf(vocab[1]), leaf(vocab[2])]}},
                                           {"and": {"queries": [leaf(vocab[3]), leaf(vocab[7])]}}, leaf(vocab[8])]}}},
        {"search_req": leaf(vocab[6]), "boost_term": [{"terms": [vocab[7]], "path": "title"}], "text_locality": True},
    ]
    reqs = [Request.from_dict(d) for d in dicts]

    def answers():
        out = [search(r, index) for r in reqs] + [search(r, index, dense_only=True) for r in reqs]
        out += search_batch(reqs, index)
        return [(a.num_hits, [(h.id, np.float32(h.score).view(np.int32).item()) for h in a.data], a.facets)
                for a in out]

    want = answers()
    assert sum(w[0] > 0 for w in want) >= len(want) - 3
    b7, sel = dense_resolve.launches, levenshtein_select_banded.launches
    for mesh in (build_doc_mesh(8), build_mesh(4, 2)):
        index.attach_mesh(mesh)
        try:
            assert answers() == want
        finally:
            index.detach_mesh()
    assert dense_resolve.launches > b7 and levenshtein_select_banded.launches > sel


def _card_csr(rng, card, num_keys, num_docs, scores01=None):
    """A CSR of runs (20% empty, anchors up to num_docs + 50) on the card
    and its host offsets; ``scores01`` the row scores, else seeded."""
    counts = rng.integers(0, 3000, num_keys)
    counts[rng.random(num_keys) < 0.2] = 0
    offsets = np.zeros(num_keys + 2, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:-1])
    offsets[-1] = offsets[-2]
    anchors = np.concatenate([np.sort(rng.choice(num_docs + 50, size=c, replace=False)) for c in counts])
    if scores01 is None:
        scores01 = rng.integers(0, 60000, len(anchors)).astype(np.float32) / np.float32(100.0)
    packed = np.stack([anchors.astype(np.int32), scores01[: len(anchors)].view(np.int32)], axis=1)
    return offsets, torch.from_numpy(offsets).to(card), torch.from_numpy(packed).to(card), scores01


def _leaf_args(rng, offsets, offsets_t, packed, t, num_docs, term_scores, card):
    tids = rng.integers(0, len(offsets) - 2, t)
    starts = np.zeros(t + 1, dtype=np.int64)
    np.cumsum(offsets[tids + 1] - offsets[tids], out=starts[1:])
    return (offsets_t, packed, torch.from_numpy(tids.astype(np.int32)).to(card),
            torch.from_numpy(np.asarray(term_scores, np.float32)).to(card), torch.from_numpy(starts).to(card),
            int(starts[-1]), num_docs)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 3, 600, 1500])  # 1500 > the kernel's 1,024 staged terms
def test_dense_resolve_both_paths_equal_plain_on_card(card, t):
    """B7's direct path (where dense_fast_path holds) and its keys path,
    on the same leaves: bit-equal to the plain version. Term scores of
    +0.0 and subnormals (on leaves of three terms or more) ride the direct
    path."""
    rng = np.random.default_rng(30 + t)
    num_docs = 50_000
    offsets, offsets_t, packed, scores01 = _card_csr(rng, card, 4000, num_docs)
    max_row = dense_max_row_score(scores01)
    term_scores = (rng.integers(1, 400, t) / np.float32(37.0)).astype(np.float32)
    if t >= 3:
        term_scores[-2:] = [0.0, np.uint32(1).view(np.float32)]
    assert dense_fast_path(max_row, term_scores)
    args = _leaf_args(rng, offsets, offsets_t, packed, t, num_docs, term_scores, card)
    want = dense_resolve_plain(*args)
    for direct in (True, False):
        before = dense_resolve.launches, dense_resolve.direct_launches
        got = dense_resolve(*args, direct)
        torch.cuda.synchronize()
        assert (dense_resolve.launches, dense_resolve.direct_launches) == (before[0] + 1, before[1] + direct)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), direct
    assert int((want > 0).sum()) > 0


# leaves the direct path must refuse: (row scores of the index, term
# scores). No case mixes +0.0 and -0.0 products, nor makes a NaN: the plain
# maximum over those depends on the order of the rows.
_POSITIVE = [0.01, 1.5, 600.0]
KEYS_ONLY = {
    "negative zero term": (_POSITIVE, [1.5, -0.0, 2.0]),
    "negative term": (_POSITIVE, [1.5, -0.25, 2.0]),
    "infinite terms": (_POSITIVE, [np.inf, -np.inf, 1.0]),
    "overflowing product": ([3e38, 1.0], [2.0, 1.0, 0.5]),
    "negative zero and negative rows": ([-0.0, -1.5, 2.0], [1.0, 2.0, 3.0]),
    "infinite rows": ([np.inf, -np.inf, 2.0], [1.0, 2.0, 3.0]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(KEYS_ONLY))
def test_dense_resolve_keys_path_on_leaves_the_direct_path_refuses(card, case):
    rng = np.random.default_rng(len(case))
    num_docs = 20_000
    rows, terms = KEYS_ONLY[case]
    scores01 = np.resize(np.asarray(rows, dtype=np.float32), 4000 * 3000)
    rng.shuffle(scores01)
    offsets, offsets_t, packed, scores01 = _card_csr(rng, card, 4000, num_docs, scores01)
    term_scores = np.resize(np.asarray(terms, dtype=np.float32), 9)
    assert not dense_fast_path(dense_max_row_score(scores01[: int(offsets[-1])]), term_scores)
    args = _leaf_args(rng, offsets, offsets_t, packed, 9, num_docs, term_scores, card)
    got, want = dense_resolve(*args), dense_resolve_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_leaf_resolve_on_card_takes_the_direct_path(card):
    """A card index's leaves carry the direct path in their arguments; a
    negative leaf boost turns it off; both planes equal the CPU index's."""
    rng = np.random.default_rng(31)
    vocab = [f"w{i:x}" for i in range(300)]
    docs = "\n".join('{"title": "%s"}' % " ".join(rng.choice(vocab, size=6)) for _ in range(3000))
    pers = Persistence.from_built(create_indices_from_str(docs, "{}"))
    on_cpu, on_card = TorchIndex.from_persistence(pers, "cpu"), TorchIndex.from_persistence(pers, card)
    assert on_card.max_row_score is not None and on_card.max_row_score == on_cpu.max_row_score
    tids = np.arange(0, 60, 3)
    for scores, direct in ((np.full(20, 1.25, np.float32), True), (np.full(20, -1.25, np.float32), False)):
        args = dense_resolve_args(on_card, "title", tids, scores)
        assert args[7] is direct
        before = dense_resolve.direct_launches
        got = dense_resolve(*args).cpu()
        assert dense_resolve.direct_launches == before + direct
        cpu_args = dense_resolve_args(on_cpu, "title", tids, scores)
        assert cpu_args[7] is False
        assert torch.equal(got.view(torch.int32), dense_resolve(*cpu_args).view(torch.int32))


def _select_sweep(words, n, rng, card):
    """A field sweep matrix on the card: ``words`` sorted by length, pad
    rows (length 0, term id -1) behind them, a permutation as term ids."""
    words = sorted(words, key=len)
    chars = np.zeros((32, n), np.uint16)
    lens = np.zeros(n, np.int32)
    for i, w in enumerate(words):
        chars[: len(w), i] = [ord(c) for c in w]
        lens[i] = len(w)
    ids = np.full(n, -1, np.int32)
    ids[: len(words)] = rng.permutation(len(words)) + 5
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in (chars, lens, ids))


@pytest.mark.cuda
@pytest.mark.parametrize("band", [2, 4])
def test_select_banded_equals_plain_on_card(card, band):
    """The fused lone-request select against its plain twin, for every
    distance up to the band: query lengths 1 and 31, a query with no
    match, pad rows, and a field whose every real row matches (600 rows,
    past the first readback's 256)."""
    rng = np.random.default_rng(40 + band)
    words = ([f"w{i:03d}" for i in range(300)] + ["a", "b", "ab", "hello", "help", "x" * 31, "x" * 32]
             + ["".join(rng.choice(list("helowx"), size=int(k))) for k in rng.integers(1, 33, 3000)])
    near = ["ab", "a", "b", "abc", "xab", "ac", "bb", "aab", "abb", "cb"]
    fields = {"main": _select_sweep(words, 4096, rng, card), "all match": _select_sweep(near * 60, 1024, rng, card)}
    cases = [("main", w) for w in ("a", "x" * 31, "helo", "w0015", "\u65e5\u672c" * 6)] + [("all match", "ab")]
    for name, word in cases:
        chars_t, lens, ids = fields[name]
        query, qlen = encode_query(word)
        for distance in range(band + 1):
            before = levenshtein_select_banded.launches
            got = levenshtein_select_banded(chars_t, lens, ids, query, qlen, band, distance)
            assert levenshtein_select_banded.launches == before + 1
            want = levenshtein_select_banded_plain(chars_t, lens, ids, query, qlen, band, distance)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), (name, word, distance)
            if name == "all match" and distance >= 1:
                assert len(got[0]) == 600


@pytest.mark.cuda
def test_select_calls_apart_across_threads_and_fields_of_different_sizes(card):
    """Each call writes its own output: threads selecting at once on fields
    of three sizes, on one stream, each get their own field's matches,
    equal to the plain twin, as the server's handler threads would."""
    rng = np.random.default_rng(50)
    fields = [_select_sweep(["".join(rng.choice(list("abcd"), size=int(k))) for k in rng.integers(1, 9, n)],
                            n, rng, card) for n in (3000, 700, 9000)]
    query, qlen = encode_query("abca")
    wants = [levenshtein_select_banded_plain(*f, query, qlen, 2, 2) for f in fields]
    assert len({len(w[0]) for w in wants}) == 3 and all(len(w[0]) for w in wants)

    def worker(k):
        bad = 0
        for _ in range(50):
            got = levenshtein_select_banded(*fields[k], query, qlen, 2, 2)
            bad += not all(np.array_equal(g, w) for g, w in zip(got, wants[k]))
        return bad

    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        assert list(pool.map(worker, [0, 1, 2, 0, 1, 2])) == [0] * 6


# ---------------------------------------------------------------- B8, the regex DFA walk

REGEX_PATTERNS = ["abc", "a*b", "(ab|ba)", "[^a-c]+", r"\d+", r"\w+", "x.*", ".*e.*", "[a-f]+[0-9]?",
                  "(a|b)*c", "zzz", ""]


def _walk_rows(words):
    """``words`` as a sweep matrix ``[32, N]`` u16 (lowercased, cut at 32,
    as the index stores them) and as int32 row-major codes ``[N, 254]``."""
    n = len(words)
    chars = np.zeros((32, n), dtype=np.uint16)
    codes = np.full((n, 254), -1, dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    for i, w in enumerate(words):
        cps = [ord(c) for c in w.lower()]
        lens[i] = len(cps)
        codes[i, : min(len(cps), 254)] = cps[:254]
        for j, c in enumerate(cps[:32]):
            chars[j, i] = c if c <= 0xFFFF else 0xFFFD
    return chars, codes, lens


def _edge_words(rng):
    alphabet = list("abcdefxyz019_ -.") + ["\u00e9", "\u212a", "\u0130", "\u017f", "\u65e5", "\U0001F600"]
    words = ["".join(rng.choice(alphabet, size=int(k))) for k in rng.integers(0, 40, 4000)]
    words[:8] = ["", "a" * 32, "a" * 33, "b" * 254, "x" * 300, "caf\u00e9", "\u212a", "abc"]
    return words


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("pattern", REGEX_PATTERNS)
def test_regex_match_equals_plain_on_card(card, pattern, prefix):
    """B8 against its plain version, bit for bit: the sweep layout (u16,
    transposed) and the long-row layout (int32 codes through a transposed
    view), on the edge set and a random dictionary."""
    rng = np.random.default_rng(21)
    dfa = compile_dfa(pattern, ignore_case=True)
    assert dfa is not None
    chars, codes, lens = _walk_rows(_edge_words(rng))
    c16, c32, ln = (torch.from_numpy(a).to(card) for a in (chars, codes, lens))
    for view, lengths in ((c16, ln.clamp(max=32).contiguous()), (c32.T, ln)):
        got = regex_match(view, lengths, dfa, prefix)
        want = regex_match_plain(view, lengths, dfa, prefix)
        torch.cuda.synchronize()
        assert got.dtype == torch.bool and torch.equal(got, want), pattern


@pytest.mark.cuda
def test_regex_match_random_patterns_on_card(card):
    """Random patterns of the DFA parser's grammar, full and prefix mode,
    each with its dead state and again with none named (the walk then
    never stops early; the answer is the same)."""
    rng = np.random.default_rng(22)
    atoms = ["a", "b", "c", ".", "[a-c]", "[^b]", r"\d", r"\w", "x"]
    chars, codes, lens = _walk_rows(_edge_words(rng))
    c16, ln = torch.from_numpy(chars).to(card), torch.from_numpy(lens).to(card).clamp(max=32).contiguous()
    before, walked = regex_match.launches, 0
    for _ in range(60):
        parts = [str(rng.choice(atoms)) + str(rng.choice(["", "*", "+", "?"])) for _ in range(int(rng.integers(1, 5)))]
        dfa = compile_dfa("".join(parts), ignore_case=True)
        if dfa is None:
            continue
        assert dfa.dead >= 0
        no_dead = CompiledDfa(dfa.boundaries, dfa.trans, dfa.accept, -1)
        for prefix in (False, True):
            want = regex_match_plain(c16, ln, dfa, prefix)
            assert torch.equal(regex_match(c16, ln, dfa, prefix), want)
            assert torch.equal(regex_match(c16, ln, no_dead, prefix), want)
        walked += 1
    assert walked > 30 and regex_match.launches == before + 4 * walked


@pytest.mark.cuda
def test_regex_search_and_documents_on_card(card):
    """Regex leaves through ``search`` (the dense executor, B8 then B3 for
    the distances, B7 for the planes) and the documents read back: the card
    and the CPU give the same answers."""
    rng = np.random.default_rng(23)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)] + ["x" * 40 + "bbb"]
    docs = "\n".join('{"title": "%s", "cat": "c%d"}' % (" ".join(rng.choice(vocab, size=5)), i % 16)
                     for i in range(3000))
    config = '["*GLOBAL*"]\nfeatures = ["All"]\n'
    pers = Persistence.from_built(create_indices_from_str(docs, config))
    on_cpu = TorchIndex.from_persistence(pers, "cpu")
    on_card = TorchIndex.from_persistence(pers, card)
    before = regex_match_pair.launches
    for q in ("*bbb", "*1a*", "w1*aa", "*bbb AND w2*", "*c* w10"):
        a_req = search_query(on_card, SearchQueryGeneratorParameters(search_term=q))
        b_req = search_query(on_cpu, SearchQueryGeneratorParameters(search_term=q))
        a, b = search(a_req, on_card), search(b_req, on_cpu)
        assert a.num_hits == b.num_hits > 0, q
        assert [(h.id, h.score) for h in a.data] == [(h.id, h.score) for h in b.data], q
        for select in (None, ["title", "cat"]):
            da, db = search_to_result_with_doc(on_card, a, select), search_to_result_with_doc(on_cpu, b, select)
            assert [d.doc for d in da.data] == [d.doc for d in db.data]
    assert regex_match_pair.launches > before and not on_card.path_counts["regex_host_scan"]



@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
def test_regex_match_pair_equals_plain_on_card(card, prefix):
    """B8's two-matrix entry, one launch over a sweep matrix and long rows
    (either may be empty), against its plain version, bit for bit; one
    launch a call with rows, none without."""
    rng = np.random.default_rng(24)
    chars, codes, lens = _walk_rows(_edge_words(rng))
    c16, c32, ln = (torch.from_numpy(a).to(card) for a in (chars, codes, lens))
    sweep, long = (c16, ln.clamp(max=32).contiguous()), (c32.T, ln)
    empty = (torch.zeros((32, 0), dtype=torch.uint16, device=card), torch.zeros(0, dtype=torch.int32, device=card))
    before = regex_match_pair.launches
    for pattern in REGEX_PATTERNS:
        dfa = compile_dfa(pattern, ignore_case=True)
        for a, b in ((sweep, long), (long, sweep), (sweep, empty), (empty, long)):
            got = regex_match_pair(*a, *b, dfa, prefix)
            want = regex_match_pair_plain(*a, *b, dfa, prefix)
            torch.cuda.synchronize()
            assert got.dtype == torch.bool and torch.equal(got, want), pattern
    assert regex_match_pair(*empty, *empty, dfa, prefix).shape == (0,)
    assert regex_match_pair.launches == before + 4 * len(REGEX_PATTERNS)


@pytest.mark.cuda
@pytest.mark.parametrize("prefix", [False, True])
def test_regex_match_mixed_warps_on_card(card, prefix):
    """Warps whose rows mix ASCII and non-ASCII chars, and row-major long
    rows of unequal lengths in every warp (33 to 254 chars, the staged
    path), in both layouts, against the plain walk."""
    rng = np.random.default_rng(25)
    ascii_only = list("abcxyz019_")
    wide = ["\u00e9", "\u00ff", "\u0101", "\u65e5", "\U0001F600"]
    mixed = ["".join(rng.choice(ascii_only + (wide if i % 2 else []), size=int(k)))
             for i, k in enumerate(rng.integers(1, 60, 4096))]
    unequal = ["".join(rng.choice(ascii_only, size=33 + (i * 37) % 222)) for i in range(4096)]
    for words in (mixed, unequal):
        chars, codes, lens = _walk_rows(words)
        c16, c32, ln = (torch.from_numpy(a).to(card) for a in (chars, codes, lens))
        for pattern in REGEX_PATTERNS + ["[à-ÿ]+x*", ".*日.*", "[^a]*é", "[à-ä]x*|[è-ë]|[ì-ï]+"]:
            dfa = compile_dfa(pattern, ignore_case=True)
            for view, lengths in ((c16, ln.clamp(max=32).contiguous()), (c32.T, ln)):
                got = regex_match(view, lengths, dfa, prefix)
                assert torch.equal(got, regex_match_plain(view, lengths, dfa, prefix)), pattern

@pytest.mark.cuda
def test_term_boost_factor_on_card_equals_cpu(card):
    """B10 on the card: counts up to 40 at boosts whose powers the card's
    ``powf`` may round otherwise; the factor equals the CPU's bit for bit."""
    from collections import Counter
    from types import SimpleNamespace

    from veloci_tpu_torch.search.boost import resolve_part_anchors, term_boost_factor_device

    rng = np.random.default_rng(31)
    anchors = np.repeat(np.arange(41), np.arange(41))
    parts = {("f", j): (rng.permutation(anchors) + 41 * j, b)
             for j, b in enumerate((3.0, 5.0, 1.7, 0.3, 7.3, None))}
    boost_terms = [SimpleNamespace(path="f", terms=["t"], boost=b, key=lambda k=k: k)
                   for k, (_a, b) in parts.items()]

    def factor(device):
        index = SimpleNamespace(num_docs=41 * 6 + 3, device=torch.device(device), term_boost_cache={},
                                path_counts=Counter(), key_value_stores={},
                                is_anchor_identity_column=lambda _path: True)
        anchors = [resolve_part_anchors(index, bt, parts[bt.key()][0]) for bt in boost_terms]
        return term_boost_factor_device(index, boost_terms, anchors)

    got, want = factor(card), factor("cpu")
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_features_on_card_equal_cpu(card):
    """``boost_term``, ``text_locality`` and ``why_found`` requests through
    ``search`` and ``search_batch``, their documents, and suggest requests,
    on the card after ``warmup`` and on the CPU: identical answers."""
    rng = np.random.default_rng(37)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)]
    docs = "\n".join('{"title": "%s", "cat": "c%d"}' % (" ".join(rng.choice(vocab, size=5)), i % 16)
                     for i in range(3000))
    pers = Persistence.from_built(create_indices_from_str(docs, '["*GLOBAL*"]\nfeatures = ["All"]\n'))
    on_cpu = TorchIndex.from_persistence(pers, "cpu")
    on_card = TorchIndex.from_persistence(pers, card)
    assert on_card.warmup() > 0 and on_card.last_warmup_breakdown["build_s"] >= 0

    def leaf(t, **kw):
        return {"search": dict({"terms": [t], "path": "title"}, **kw)}

    dicts = [
        {"search_req": leaf("w1bb", levenshtein_distance=1),
         "boost_term": [{"terms": ["w2ccc"], "path": "title"},
                        {"terms": ["w3dddd"], "path": "title", "levenshtein_distance": 1, "boost": 3.0}]},
        {"search_req": {"or": {"queries": [leaf("w1bb"), leaf("w10"), leaf("w2ccc")]}}, "text_locality": True},
        {"search_req": {"or": {"queries": [leaf("w1bb"), leaf("w10")]}}, "why_found": True,
         "select": ["title", "cat"]},
        {"search_req": leaf("w2ccc"), "why_found": True},
    ]
    for d in dicts:
        for answer in (lambda r, ix: search(r, ix), lambda r, ix: search_batch([r], ix)[0]):
            a, b = answer(Request.from_dict(d), on_card), answer(Request.from_dict(d), on_cpu)
            assert a.num_hits == b.num_hits > 0, d
            assert [(h.id, h.score) for h in a.data] == [(h.id, h.score) for h in b.data], d
            assert (a.why_found_terms, a.why_found_info) == (b.why_found_terms, b.why_found_info), d
            da = search_to_result_with_doc(on_card, a, d.get("select"))
            db = search_to_result_with_doc(on_cpu, b, d.get("select"))
            assert [x.to_dict() for x in da.data] == [x.to_dict() for x in db.data], d
    sugg = [suggest_query(p, on_card, levenshtein=lev, fields=["title"])
            for p, lev in (("w1", 0), ("w2c", 1), ("w3dd", 1))]
    sugg.append(Request.from_dict({"suggest": [{"terms": ["w1b"], "path": "title", "starts_with": True}],
                                   "top": 10}))
    got = suggest_batch(on_card, sugg)
    assert all(got) and got == suggest_batch(on_cpu, sugg)


@pytest.mark.cuda
def test_explain_and_server_on_card_equal_cpu(card, tmp_path):
    """Explained requests (trees, a 1:n Log10 boost, a Log10 column, a
    filter) and ``explain_plan`` on the card and on the CPU: identical
    entries and plans; then the port's server on the card, 32 requests from
    8 threads at once (explained searches, query strings, suggests, a
    batch), each body equal to the CPU server's but ``execution_time_ns``.
    The plans' ``path`` nodes differ only where the CPU's says that the
    kernels' plain versions ran."""
    import json
    import threading
    import urllib.request

    from veloci_tpu_torch import explain_plan
    from veloci_tpu_torch import server as port_server

    rng = np.random.default_rng(41)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(800)]
    docs = "\n".join(
        '{"title": "%s", "cat": "c%d", "pop": %d, "parts": [{"name": "%s", "rank": %d}]}'
        % (" ".join(rng.choice(vocab, size=5)), i % 16, rng.integers(0, 1000), rng.choice(vocab[:50]),
           rng.integers(0, 9))
        for i in range(3000)
    )
    config = ('["*GLOBAL*"]\nfeatures = ["All"]\n["cat"]\nfacet = true\n["pop".boost]\nboost_type = "f32"\n'
              '["parts[].rank".boost]\nboost_type = "f32"\n')
    pers = Persistence.from_built(create_indices_from_str(docs, config))
    on_cpu = TorchIndex.from_persistence(pers, "cpu")
    on_card = TorchIndex.from_persistence(pers, card)

    def leaf(t, path="title", **kw):
        return {"search": dict({"terms": [t], "path": path}, **kw)}

    dicts = [
        {"search_req": {"or": {"queries": [leaf("w1bb"), leaf("w2ccc", levenshtein_distance=1), leaf("w1bb")]}},
         "explain": True},
        {"search_req": {"or": {"queries": [{"and": {"queries": [leaf("w1", starts_with=True),
                                                                 leaf("w2", starts_with=True)]}}, leaf("w10")]}},
         "explain": True, "boost": [{"path": "pop", "boost_fun": "Log10", "param": 1}]},
        {"search_req": leaf(vocab[3], "parts[].name", options={"explain": True}),
         "boost": [{"path": "parts[].rank", "boost_fun": "Log10", "param": 1}]},
        {"search_req": leaf("w1", starts_with=True, levenshtein_distance=1), "explain": True,
         "filter": leaf("c3", "cat"), "top": 5, "skip": 2},
    ]
    for d in dicts:
        for answer in (lambda r, ix: search(r, ix), lambda r, ix: search_batch([r], ix)[0]):
            a, b = answer(Request.from_dict(d), on_card), answer(Request.from_dict(d), on_cpu)
            assert a.data and [(h.id, h.score) for h in a.data] == [(h.id, h.score) for h in b.data], d
            assert json.dumps(a.explain) == json.dumps(b.explain) and a.explain, d
        plan_cpu = explain_plan(Request.from_dict(d), on_cpu)  # its path says the plain versions ran
        assert "kernels (plain versions on cpu): " in plan_cpu
        assert explain_plan(Request.from_dict(d), on_card) == plan_cpu.replace(
            "kernels (plain versions on cpu): ", "kernels: ")

    pers.save(str(tmp_path / "db"))
    bodies = {}
    for device in ("cpu", "cuda"):
        port_server.PERSISTENCES.clear()
        port_server.BASE_DIR = str(tmp_path)
        srv = port_server.make_server("127.0.0.1", 0, device=device)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}/db"

        def call(c):
            method, path, body = c
            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(base + path, data=data, method=method)
            with urllib.request.urlopen(req, timeout=120) as resp:
                out = json.loads(resp.read())
            drop = lambda o: ({k: drop(v) for k, v in o.items() if k != "execution_time_ns"}  # noqa: E731
                              if isinstance(o, dict) else [drop(v) for v in o] if isinstance(o, list) else o)
            return drop(out)

        calls = ([("POST", "/search", d) for d in dicts]
                 + [("GET", f"/search?query={w}%20{v}", None) for w, v in zip(vocab[:8], vocab[8:16])]
                 + [("GET", f"/suggest?query={w[:3]}", None) for w in vocab[16:24]]
                 + [("POST", "/search_batch", dicts + [{"search_req": leaf("w1bb")}])]) * 2
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as pool:
            bodies[device] = list(pool.map(call, calls))
        index = port_server.PERSISTENCES["db"]
        assert index.device.type == device
        srv.shutdown()
    port_server.PERSISTENCES.clear()
    assert bodies["cuda"] == bodies["cpu"]
