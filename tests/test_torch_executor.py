"""The port's ``search`` and its per-request dense executor against the JAX
package's ``search`` (``veloci_tpu/search/executor.py``), one jmdict-like
index (``tests/corpus.py``'s ``TEST_CONFIG`` data, one field without
postings added) built by each package; the dense executor against the
port's own tree routes on the corpora of ``test_torch_generic.py`` and
``test_torch_search.py``; the dense resolve's plain version (the CPU form of
kernel B7) against the reference's ``_resolve_kernel``; and the executor's
planes, which stay tensors on the index's device.

``SMALL_DOCS`` is set to 0 on the reference side, so that its executor takes
its device branch (on JAX-CPU) and not its numpy branch for small indices.

Tolerance: ids, order, ``num_hits``, facet lists and raised error types
exact. Scores are bit-equal where both sides take the same f32 steps in the
same order, which the dense executors do for unions, intersections, 1:n
boosts (their factors taken with numpy on both sides) and the phrase
factor. A boost column with Log10 or Log2 (numpy's f32 log against XLA's)
is held to a relative 1e-6 (``APPROX``). Against the tree route, scores
are held to a relative 1e-6 throughout: the two routes sum unions of three
or more values and apply the phrase factor in other orders (ROADMAP C2);
ids, order and ``num_hits`` must still be equal.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import test_torch_generic as tg
import test_torch_search as ts
from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens
from veloci_tpu_torch import Persistence as PortPersistence
from veloci_tpu_torch import Request as PortRequest
from veloci_tpu_torch import TorchIndex, create_indices_from_str, load_index, search, search_batch
from veloci_tpu_torch import add_token_values_to_tokens as port_add_token_values
from veloci_tpu_torch.ops.postings import dense_resolve, dense_resolve_plain, resolve_to_anchor_dense
from veloci_tpu_torch.search import boost as port_boost
from veloci_tpu_torch.search import executor as port_executor
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

ex_mod = importlib.import_module("veloci_tpu.search.executor")
batch_mod = importlib.import_module("veloci_tpu.search.batch")
ref_postings = importlib.import_module("veloci_tpu.ops.postings")
ref_boost = importlib.import_module("veloci_tpu.search.boost")

CONFIG = TEST_CONFIG + '\n["gender"]\n    disabled_features = ["Search"]\n'
GER, KANJI = "meanings.ger[]", "kanji[].text"


def _leaf(term, path=GER, **kw):
    terms = term if isinstance(term, list) else [term]
    return {"search": dict({"terms": terms, "path": path}, **kw)}


def _node(kind, *queries, **options):
    out = {"queries": list(queries)}
    if options:
        out["options"] = options
    return {kind: out}


def _or(*queries, **options):
    return _node("or", *queries, **options)


def _and(*queries, **options):
    return _node("and", *queries, **options)


def _req(tree, **extras):
    return dict({"search_req": tree}, **extras)


def _b(path, fun=None, **kw):
    out = dict({"path": path}, **kw)
    if fun:
        out["boost_fun"] = fun
    return out


KANJI_PREFIX = _leaf("意", KANJI, starts_with=True)  # 意欲 and 意慾: two kanji of one entry
ONE_N = {
    f"one_n_{name}": _req(KANJI_PREFIX, boost=[_b("kanji[].commonness", fun, **kw)])
    for name, fun, kw in (
        ("log10", "Log10", {"param": 1}),
        ("log2", "Log2", {"param": 2}),
        ("multiply", "Multiply", {"param": 0.5}),
        ("add", "Add", {"param": 2}),
        ("replace", "Replace", {"param": 1}),
        ("no_fun", None, {}),
        ("expression", None, {"expression": "$SCORE * 2"}),
        ("mul_expression", "Multiply", {"param": 1, "expression": "$SCORE / 4"}),
        ("add_expression", "Add", {"expression": "2 - $SCORE"}),
        ("skip_when_score", "Multiply", {"param": 1, "skip_when_score": [2.0]}),
    )
}

CASES = {
    # trees three and four levels deep
    "deep_and_or_and": _req(_and(_or(_and(_leaf("guter"), _leaf("treffer")), _leaf("text")), _leaf("alle"))),
    "deep_or_and_or": _req(_or(_and(_or(_leaf("guter"), _leaf("weich", levenshtein_distance=1)),
                                    _leaf("treffer")), _leaf("majestät"))),
    "deep_four_levels": _req(_or(_and(_or(_and(_leaf("guter"), _leaf("treffer")),
                                          _leaf("texx", levenshtein_distance=1)), _leaf("alle")),
                                 _leaf("welch"), _leaf("words"))),
    "deep_four_levels_and": _req(_and(_or(_and(_or(_leaf("guter"), _leaf("welch")), _leaf("treffer")),
                                          _leaf("text")), _or(_leaf("alle"), _leaf("localität")))),
    "and_not_flattened": _req(_and(_and(_leaf("guter"), _leaf("treffer")), _leaf("nicht"))),
    "or_same_term_repeated": _req(_or(_leaf("treffer"), _and(_leaf("treffer"), _leaf("guter")),
                                      _leaf("treffer", path="meanings.eng[]"))),
    "and_with_a_miss": _req(_and(_leaf("guter"), _leaf("nothere"))),
    # leaves with several terms: the first one is searched
    "multi_term": _req(_leaf(["majestät", "welch"])),
    "multi_term_fuzzy": _req(_leaf(["majestat", "guter"], levenshtein_distance=1)),
    "multi_term_in_or": _req(_or(_leaf(["treffer", "alle"]), _leaf("text"))),
    # leaf and node options
    "leaf_option_boost_1n": _req(_leaf("意欲", KANJI, options={"boost": [_b("kanji[].commonness", "Log10",
                                                                            param=1)]})),
    "node_option_boost_1n": _req(_or(_leaf("意欲", KANJI), _leaf("何の", KANJI),
                                     boost=[_b("kanji[].commonness", "Multiply", param=1)])),
    "node_option_boost_not_1n": _req(_or(_leaf("guter"), _leaf("text"), boost=[_b("commonness", "Multiply")])),
    "node_option_top": _req(_and(_leaf("guter"), _leaf("treffer"), top=3)),
    **ONE_N,
    "one_n_field1": _req(_leaf("awesome", "field1[].text"),
                         boost=[_b("commonness", "Log10", param=1),
                                _b("field1[].rank", expression="10 / $SCORE", skip_when_score=[0])]),
    "one_n_kana_on_or": _req(_or(_leaf("いよく", "kana[].text"), _leaf("どの", "kana[].text")),
                             boost=[_b("kana[].commonness", "Add", param=1)]),
    "one_n_no_match_on_leaf": _req(_leaf("majestät"), boost=[_b("kanji[].commonness", "Multiply")]),
    "one_n_two_matching": _req(KANJI_PREFIX, boost=[_b("kanji[].commonness", "Add"),
                                                    _b("kanji[].commonness", "Multiply")]),
    # extras on the executor
    "boost_column_on_deep": _req(_and(_or(_and(_leaf("guter"), _leaf("treffer")), _leaf("text")), _leaf("alle")),
                                 boost=[_b("commonness", "Log10", param=1)]),
    "boost_column_no_value": _req(_leaf("weich"), boost=[_b("commonness", "Multiply", param=1)]),
    "boost_no_column": _req(_leaf("majestät"), boost=[_b("ent_seq", "Multiply")]),
    "filter_on_multi_term": _req(_leaf(["treffer", "x"]), filter=_leaf("nice", "tags[]")),
    "filter_tree": _req(_or(_leaf("guter"), _leaf("weich")),
                        filter=_or(_leaf("cool", "tags[]"), _leaf("coolo", "tags[]", levenshtein_distance=1))),
    "facets_fast": _req(_leaf(["treffer", "x"]), facets=[{"field": "tags[]"}, {"field": "commonness", "top": 2}]),
    "facets_join": _req(_or(_leaf("guter"), _leaf("weich"), _leaf("welch")),
                        facets=[{"field": GER}, {"field": KANJI, "top": 1}]),
    "facets_no_hits": _req(_leaf(["nothere", "x"]), facets=[{"field": GER}, {"field": "tags[]"}]),
    "phrase_same_field": _req(_or(_leaf("guter"), _leaf(["treffer", "x"])),
                              phrase_boosts=[{"search1": _leaf("guter")["search"],
                                              "search2": _leaf("nicht")["search"]}]),
    "phrase_two_fields": _req(_leaf(["guter", "x"]),
                              phrase_boosts=[{"search1": _leaf("guter")["search"],
                                              "search2": _leaf("test", "meanings.eng[]")["search"]}]),
    # windows, fields
    "window_top_skip": _req(_or(_leaf("guter"), _leaf("text"), _leaf("alle"), _leaf("weich")), top=2, skip=1),
    "window_skip_past_hits": _req(_leaf(["treffer", "x"]), skip=100),
    "window_top_zero": _req(_leaf(["treffer", "x"]), top=0),
    "unknown_field": _req(_or(_leaf("x", "nothere"), _leaf(["guter", "x"]))),
    "field_without_postings": _req(_or(_leaf("male", "gender"), _leaf("majestät"))),
}
NAMES = list(CASES)
# a boost column with Log10 / Log2: numpy's f32 log against XLA's, within 1e-6
APPROX = {"one_n_field1", "boost_column_on_deep"}
# a flat tree with a node's 1:n boost option: the reference's fused tree
# route takes it and drops the option (its _node_groups reads no node
# options), its executor applies it; the port sends node options to its
# executor, so both port entry points are held to the reference's executor
# here (ROADMAP C5)
FUSED_DROPS_OPTIONS = {"node_option_boost_1n"}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data = data_ndjson()
    pers = Persistence.create_from_str(data, CONFIG)
    add_token_values_to_tokens(pers, *TOKEN_VALUES)
    directory = tmp_path_factory.mktemp("torch_executor_index")
    pers.save(str(directory))
    port_pers = PortPersistence.from_built(create_indices_from_str(data, CONFIG))
    port_add_token_values(port_pers, *TOKEN_VALUES)
    indexes = {"ref_disk": load_index(str(directory), "cpu"),
               "port_built": TorchIndex.from_persistence(port_pers, "cpu")}
    ref = {"dense": {}, "search": {}}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex_mod, "SMALL_DOCS", 0)
        mp.setattr(batch_mod, "SMALL_DOCS", 0)
        for name in NAMES:
            for mode, dense_only in (("dense", True), ("search", False)):
                ref[mode][name] = _outcome(lambda: ex_mod.search(Request.from_dict(CASES[name]), pers,
                                                                 dense_only=dense_only))
    return pers, indexes, ref


_outcome, _facets = tg._outcome, tg._facets


def _assert_same(got, want, approx: bool):
    if isinstance(want, str) or isinstance(got, str):
        assert got == want
        return
    assert got.num_hits == want.num_hits
    assert _facets(got) == _facets(want)
    assert [h.id for h in got.data] == [h.id for h in want.data]
    gs = np.array([h.score for h in got.data], np.float32)
    ws = np.array([h.score for h in want.data], np.float32)
    if approx:
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", NAMES)
def test_dense_executor_parity(built, index, name):
    """``search(..., dense_only=True)`` against the reference's executor."""
    _pers, indexes, ref = built
    idx = indexes[index]
    before = idx.path_counts["executor"]
    got = _outcome(lambda: search(PortRequest.from_dict(CASES[name]), idx, dense_only=True))
    _assert_same(got, ref["dense"][name], name in APPROX)
    if not isinstance(got, str):
        assert idx.path_counts["executor"] == before + 1


@pytest.mark.parametrize("name", NAMES)
def test_search_parity(built, name):
    """``search`` with its routing against the reference's ``search``."""
    _pers, indexes, ref = built
    got = _outcome(lambda: search(PortRequest.from_dict(CASES[name]), indexes["ref_disk"]))
    _assert_same(got, ref["dense" if name in FUSED_DROPS_OPTIONS else "search"][name], name in APPROX)


@pytest.mark.parametrize("name", NAMES)
def test_search_batch_hands_to_the_executor(built, name):
    """In a batch beside a request of the tree route, a request answers as
    it does alone; the executor's shapes are counted under "executor"."""
    _pers, indexes, ref = built
    idx = indexes["ref_disk"]
    before = idx.path_counts["executor"]
    ok = PortRequest.from_dict(_req(_leaf("guter")))
    got = _outcome(lambda: search_batch([ok, PortRequest.from_dict(CASES[name])], idx)[1])
    _assert_same(got, ref["dense" if name in FUSED_DROPS_OPTIONS else "search"][name], name in APPROX)
    if not isinstance(got, str) and _needs_executor(name):
        assert idx.path_counts["executor"] == before + 1


def _needs_executor(name):
    return name.startswith(("deep_and", "deep_four", "multi_term", "leaf_option", "node_option", "one_n",
                            "filter_on_multi", "facets_join", "facets_no_hits", "field_without"))


def test_cases_exercise_what_they_name(built):
    pers, indexes, ref = built
    dense = ref["dense"]
    errors = {"boost_no_column": "VelociError", "unknown_field": "FstNotFoundError",
              "phrase_two_fields": "InvalidRequestError", "one_n_two_matching": "InvalidRequestError"}
    for name in NAMES:
        if name.startswith(("deep", "multi_term", "one_n_", "node_option", "leaf_option", "facets_fast",
                            "facets_join", "phrase_same", "filter", "field_without", "window_top_skip")):
            assert name in errors or dense[name].num_hits > 0, name
    assert {name: dense[name] for name in errors} == errors
    for name in FUSED_DROPS_OPTIONS:  # the reference's fault this file pins
        assert [h.score for h in ref["search"][name].data] != [h.score for h in dense[name].data]
    # the 1:n chain names one anchor twice (two kanji of one entry)
    fsr = importlib.import_module("veloci_tpu.search.field_search").get_term_ids_in_field(
        pers, Request.from_dict(CASES["one_n_replace"]).search_req.part)
    part = Request.from_dict(CASES["one_n_replace"]).boost[0]
    anchors, _vals = ref_boost.boost_to_anchor_values(pers, fsr.path, part, fsr.term_ids)
    assert len(anchors) > len(np.unique(anchors))
    # the boosts change the scores, the join facets count
    plain = dense["deep_and_or_and"].data[0].score
    assert dense["boost_column_on_deep"].data[0].score != plain
    assert len({h.score for h in dense["one_n_replace"].data}) > 1
    assert dense["facets_join"].facets[GER] and dense["facets_join"].facets[KANJI] is not None
    assert not indexes["ref_disk"].has_index(GER + ".textindex.anchor_to_text_id")
    assert "gender" not in indexes["ref_disk"].key_base
    assert indexes["ref_disk"].get_dictionary("gender") is not None
    # the phrase factor lifts the pair's documents
    without = {k: v for k, v in CASES["phrase_same_field"].items() if k != "phrase_boosts"}
    plain = search(PortRequest.from_dict(without), indexes["ref_disk"], dense_only=True)
    assert sum(h.score for h in dense["phrase_same_field"].data) > sum(h.score for h in plain.data)


def test_one_n_boost_helpers_equal_reference(built):
    """The port's 1:n chain and its per-anchor accumulation against the
    reference's (``boost_to_anchor_values``, ``anchor_boost_accs``)."""
    pers, indexes, _ref = built
    idx = indexes["ref_disk"]
    part = Request.from_dict(CASES["one_n_replace"]).search_req.part
    fsr = importlib.import_module("veloci_tpu.search.field_search").get_term_ids_in_field(pers, part)
    for name in ONE_N:
        b = Request.from_dict(CASES[name]).boost[0]
        pb = PortRequest.from_dict(CASES[name]).boost[0]
        want = ref_boost.boost_to_anchor_values(pers, fsr.path, b, fsr.term_ids)
        got = port_boost.boost_to_anchor_values(idx, fsr.path, pb, fsr.term_ids)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))
        facmul, addacc, repl = ref_boost.anchor_boost_accs(pers.num_docs, *want, b)
        acc = port_boost.anchor_boost_accs(pers.num_docs, *got, pb)
        if facmul is not None:
            np.testing.assert_array_equal(acc.factor.view(np.int32), facmul[acc.anchors].view(np.int32))
        if repl is not None:
            np.testing.assert_array_equal(acc.replace.view(np.int32), repl[acc.anchors].view(np.int32))
        if b.boost_fun == "Add" and not b.expression:
            np.testing.assert_array_equal(acc.add.view(np.int32), addacc[acc.anchors].view(np.int32))


# ---------------------------------------------------------------- the dense executor against the tree route
def _tree_cases():
    out = {}
    for mod in (tg, ts):
        for name in list(mod.CASES) + list(mod.GENERATED):
            out[f"{mod.__name__.split('_')[-1]}-{name}"] = (mod, name)
    return out


TREE_CASES = _tree_cases()


@pytest.fixture(scope="module")
def tree_indexes():
    """The generic and search corpora, built by the port."""
    gen = PortPersistence.from_built(create_indices_from_str(tg._corpus(), tg.CONFIG))
    port_add_token_values(gen, *tg._token_values())
    plain = PortPersistence.from_built(create_indices_from_str(ts._corpus(), "{}"))
    return {tg: TorchIndex.from_persistence(gen, "cpu"), ts: TorchIndex.from_persistence(plain, "cpu")}


@pytest.mark.parametrize("case", list(TREE_CASES))
def test_dense_executor_equals_tree_route(tree_indexes, case):
    mod, name = TREE_CASES[case]
    idx = tree_indexes[mod]
    req = mod._port_request(idx, name)
    (want,) = search_batch([req], idx)
    assert idx.path_counts["executor"] == 0  # these cases ride the tree routes
    got = search(req, idx, dense_only=True)
    idx.path_counts["executor"] = 0
    _assert_same(got, want, approx=True)


# ---------------------------------------------------------------- kernel B7's plain version
def _csr(rng, num_keys, num_docs, max_run):
    """A CSR of runs sorted by anchor, one row per anchor, empty runs among
    them; the reference's layout: offsets [num_keys + 2] with a double tail."""
    counts = rng.integers(0, max_run + 1, num_keys)
    counts[rng.random(num_keys) < 0.2] = 0
    anchors = [np.sort(rng.choice(num_docs, size=c, replace=False)) for c in counts]
    offsets = np.zeros(num_keys + 2, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:-1])
    offsets[-1] = offsets[-2]
    scores01 = (rng.integers(0, 60000, int(counts.sum())).astype(np.float32) / np.float32(100.0))
    packed = np.stack([np.concatenate(anchors).astype(np.int32), scores01.view(np.int32)], axis=1)
    return offsets, packed


@pytest.mark.parametrize("seed", range(4))
def test_dense_resolve_plain_equals_reference(seed):
    """Out-of-range term ids dropped, empty runs, anchors repeated across
    terms (the max wins), repeated term ids: bit-equal to the reference's
    ``_resolve_kernel`` through its ``resolve_to_anchor_dense``."""
    rng = np.random.default_rng(seed)
    num_keys, num_docs = 300, 1000
    offsets, packed = _csr(rng, num_keys, num_docs, 120)
    num_score_keys = num_keys - 20  # the last keys have no scores: dropped
    tids = rng.integers(0, num_keys + 10, int(rng.integers(1, 80)))
    tids[:3] = [num_keys + 5, 0, 0]
    tscores = (rng.integers(1, 400, len(tids)) / np.float32(37.0)).astype(np.float32)
    dev_field = SimpleNamespace(offsets=jnp.asarray(offsets.astype(np.int32)), host_offsets=offsets,
                                num_score_keys=num_score_keys, packed=jnp.asarray(packed),
                                anchors=None, scores01=None)
    want = np.asarray(ref_postings.resolve_to_anchor_dense(dev_field, tids, tscores, num_docs))
    index = SimpleNamespace(key_base={"f": (0, num_score_keys)}, host_offsets=offsets, num_docs=num_docs,
                            offsets=torch.from_numpy(offsets), packed=torch.from_numpy(packed), device="cpu")
    launches = dense_resolve.launches
    got = resolve_to_anchor_dense(index, "f", tids, tscores).numpy()
    assert dense_resolve.launches == launches  # CPU tensors take the plain version
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got > 0).sum() > 0
    assert not resolve_to_anchor_dense(index, "g", tids, tscores).any()  # no postings: zeros


def test_dense_resolve_plain_edges():
    """No terms, only empty runs, anchors past num_docs dropped."""
    offsets = torch.tensor([0, 2, 2, 4, 4], dtype=torch.int64)
    packed = torch.tensor([[1, 0], [7, 0], [3, 0], [9, 0]], dtype=torch.int32)
    packed[:, 1] = torch.tensor([0.5, 2.0, 1.5, 4.0]).view(torch.int32)
    scores = torch.tensor([2.0, 1.0, 3.0])

    def run(tids, num_docs):
        t = torch.tensor(tids, dtype=torch.int32)
        counts = offsets[t.long() + 1] - offsets[t.long()]
        starts = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(counts, 0)])
        return dense_resolve(offsets, packed, t, scores[: len(tids)], starts, int(starts[-1]), num_docs)

    assert run([], 5).tolist() == [0.0] * 5
    assert run([1, 1], 5).tolist() == [0.0] * 5
    assert run([0, 1, 2], 8).tolist() == [0.0, 1.0, 0.0, 4.5, 0.0, 0.0, 0.0, 4.0]
    assert run([2, 0], 4).tolist() == [0.0, 0.5, 0.0, 3.0]  # rows 7 and 9 dropped
    with pytest.raises(ValueError):
        dense_resolve_plain(offsets, packed, torch.tensor([0]), scores[:1], torch.tensor([0, 2]), 2, 8)


# ---------------------------------------------------------------- no host planes
def test_executor_planes_stay_tensors_on_the_device(built, monkeypatch):
    """Every plane the leaf resolve and the combine steps return is a
    ``torch.Tensor`` on ``index.device`` (no numpy branch for small
    indices, no host fallback)."""
    _pers, indexes, _ref = built
    idx = indexes["ref_disk"]
    seen = []

    def wrap(fn, pick=lambda out: out):
        def inner(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(pick(out))
            return out
        return inner

    for name in ("resolve_to_anchor_dense", "_union", "_intersect", "apply_anchor_boost_values_device",
                 "apply_boost_dense_device", "scatter_factor_device"):
        monkeypatch.setattr(port_executor, name, wrap(getattr(port_executor, name)))
    monkeypatch.setattr(port_executor, "_eval_scores", wrap(port_executor._eval_scores, lambda out: out[0]))
    for name in NAMES:
        _outcome(lambda: search(PortRequest.from_dict(CASES[name]), idx, dense_only=True))
    assert len(seen) > 3 * len(NAMES)
    bad = [type(p) for p in seen if not (isinstance(p, torch.Tensor) and p.device == idx.device
                                         and p.shape == (idx.num_docs,))]
    assert not bad
