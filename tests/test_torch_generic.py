"""The port's ``search_batch`` with filters, boost columns, facets, phrase
boosts and token-value leaves against the JAX package's ``search_batch`` on
its batched generic route, one seeded index read by both packages. Every
case runs in one batch and alone; plus the port's building blocks against
the reference's (boost factors at candidate anchors, the CSR facet count)
and the port against ``tests/goldens.json``.

Tolerance: ids, order, ``num_hits`` and facet lists exact. Scores are
bit-equal where the formula and the summation order are the same
(Multiply, Add, Replace, ``skip_when_score``, filters, the phrase factor
5 ** g, facet counts). Log10 / Log2 and expression boosts (numpy's f32 log
and XLA's may differ by one ulp) and unions of three or more values (the
reference's associative scan) are held to a relative 1e-6: the cases in
``APPROX``; their ids and order are still exact, no two of their scores
tying within that tolerance.

``SMALL_DOCS`` is forced to 1 on the reference side so that it takes its
device kernels (on the CPU) rather than its host path for small indices.
One case is held to the reference's host executor instead
(``HOST_REFERENCE``): a boost that makes a score infinite, which the
reference's device top-k reports under the pad id ``num_docs`` (ROADMAP C5);
its host executor and the port report the document."""

import importlib
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens
from veloci_tpu.ops import generic_step as ref_generic_step
from veloci_tpu.ops import tree_step as ref_tree_step
from veloci_tpu.query.generator import SearchQueryGeneratorParameters as RefParams
from veloci_tpu.query.generator import search_query as ref_search_query
from veloci_tpu_torch import Persistence as PortPersistence
from veloci_tpu_torch import Request as PortRequest
from veloci_tpu_torch import SearchQueryGeneratorParameters, TorchIndex, load_index, search, search_batch
from veloci_tpu_torch import add_token_values_to_tokens as port_add_token_values
from veloci_tpu_torch import create_indices_from_str, search_query
from veloci_tpu_torch.ops.generic_step import _precompute_boost
from veloci_tpu_torch.ops.tree_step import _apply_boost_gathered
from veloci_tpu_torch.search.facet import facet_counts, facet_relation

batch_mod = importlib.import_module("veloci_tpu.search.batch")
ex_mod = importlib.import_module("veloci_tpu.search.executor")
stats_mod = importlib.import_module("veloci_tpu.search.stats")
ref_facet = importlib.import_module("veloci_tpu.search.facet")
field_mod = importlib.import_module("veloci_tpu.search.field_search")

CONFIG = """
["*GLOBAL*"]
features = ["All"]
["cat"]
facet = true
["labels[]"]
facet = true
["pop".boost]
boost_type = "f32"
["rank".boost]
boost_type = "f32"
"""
PHRASE = ["pa", "pb", "pc", "pd"]  # a phrase most documents start with
TOKEN_VALUE_TERMS = ["w1bb", "w2ccc", "w3dddd", "w10"]


def _corpus() -> str:
    rng = np.random.default_rng(4321)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(2500)]
    vocab += ["Apple", "apple"]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p[-2:] = p[40]
    p /= p.sum()
    lines = []
    for i in range(4000):
        words = list(rng.choice(vocab, size=int(rng.integers(3, 10)), p=p))
        if rng.random() < 0.75:
            words = PHRASE + words
        doc = {
            "title": " ".join(words),
            "tags": " ".join(rng.choice(vocab[:300], size=2)),
            "nr": str(i),
            "cat": f"c{int(rng.integers(16))}",
            "labels": [f"l{int(x)}" for x in rng.choice(12, size=int(rng.integers(0, 4)), replace=False)],
            "pop": int(rng.integers(0, 1000)),
        }
        if rng.random() < 0.7:  # a boost column with absent values
            doc["rank"] = float(rng.integers(0, 8)) / 2
        lines.append(json.dumps(doc))
    return "\n".join(lines)


def _token_values() -> tuple:
    values = [{"text": t, "value": float(5 * i + 2)} for i, t in enumerate(TOKEN_VALUE_TERMS)]
    return json.dumps(values), json.dumps({"path": "title"})


def _leaf(term, **kw):
    return {"search_req": {"search": dict({"terms": [term], "path": "title"}, **kw)}}


def _tree(kind, *children):
    return {"search_req": {kind: {"queries": [c["search_req"] for c in children]}}}


def _or(*children):
    return _tree("or", *children)


def _and(*children):
    return _tree("and", *children)


def _both(term, **kw):
    return _or(_leaf(term, **kw), _leaf(term, path="tags", **kw))


def _with(req, **extras):
    return dict(req, **extras)


def _phrase(a, b, path="title", **kw):
    return {"search1": dict({"terms": [a], "path": path}, **kw),
            "search2": dict({"terms": [b], "path": path}, **kw)}


def _filter_or(*nodes):
    return {"or": {"queries": list(nodes)}}


def _filter_and(*nodes):
    return {"and": {"queries": list(nodes)}}


def _boost(fun=None, path="pop", **kw):
    out = dict({"path": path}, **kw)
    if fun:
        out["boost_fun"] = fun
    return [out]


CAT = {"facets": [{"field": "cat"}]}
F_W1BB = {"search": {"terms": ["w1bb"], "path": "title"}}
F_CAT3 = {"search": {"terms": ["c3"], "path": "cat"}}
F_CAT7 = {"search": {"terms": ["c7"], "path": "cat"}}
F_W0A = {"search": {"terms": ["w0a"], "path": "title"}}
PB_PHRASE = [_phrase("pa", "pb"), _phrase("pb", "pc")]

CASES = {
    # moved from test_torch_search.py's out-of-slice cases: the port answers them now
    "filter": _with(_leaf("w1bb"), filter=F_W1BB),
    "phrase_boosts": _with(_leaf("w1bb"), phrase_boosts=[_phrase("a", "b")]),
    "token_value": _leaf("w1bb", token_value={"path": "title"}),
    "filter_on_tree": _with(_or(_leaf("w1bb"), _leaf("w2ccc")), filter=F_W1BB),
    # each extra alone
    "filter_cat": _with(_leaf("w0a"), filter=F_CAT3),
    "boost_log10": _with(_leaf("w0a"), boost=_boost("Log10", param=1)),
    "boost_log2": _with(_leaf("w0a"), boost=_boost("Log2", param=2)),
    "boost_multiply": _with(_leaf("w0a"), boost=_boost("Multiply", param=2)),
    "boost_add": _with(_leaf("w0a"), boost=_boost("Add", param=0.5)),
    "boost_replace": _with(_leaf("w0a"), boost=_boost("Replace", param=1)),
    "boost_no_fun": _with(_leaf("w0a"), boost=_boost()),
    "boost_expression": _with(_leaf("w0a"), boost=_boost(expression="10 / $SCORE")),
    "boost_mul_expression": _with(_leaf("w0a"), boost=_boost("Multiply", expression="$SCORE * 2")),
    "boost_skip_when_score": _with(_leaf("w0a"), boost=_boost("Multiply", param=1, skip_when_score=[0.4])),
    "boost_absent_values": _with(_leaf("w0a"), boost=_boost("Multiply", path="rank", param=1)),
    "boost_log10_of_zero": _with(_leaf("w0a"), boost=_boost("Log10", path="rank"), top=4000),
    "boost_chain": _with(_leaf("w0a"), boost=_boost("Log10", param=1) + _boost("Add", path="rank", param=1)),
    "facets": _with(_leaf("w0a"), **CAT),
    "facets_top": _with(_leaf("w0a"), facets=[{"field": "cat", "top": 3}]),
    "facets_multi_value": _with(_leaf("w1bb"), facets=[{"field": "labels[]"}, {"field": "cat", "top": 5}]),
    "facets_no_hits": _with(_leaf("nothere"), **CAT),
    "phrase_pair": _with(_or(_leaf("pa"), _leaf("w0a")), phrase_boosts=PB_PHRASE),
    "phrase_repeated_pair": _with(_leaf("pb"), phrase_boosts=[_phrase("pa", "pb"), _phrase("pa", "pb", path="tags"),
                                                              _phrase("pa", "pb")]),
    # every leaf kind under extras
    "fuzzy_1_extras": _with(_leaf("w1ab", levenshtein_distance=1), filter=F_CAT3, **CAT),
    "fuzzy_2_extras": _with(_leaf("w2ccc", levenshtein_distance=2), boost=_boost("Multiply", param=1), **CAT),
    "wildcard_extras": _with(_leaf("w10", starts_with=True), boost=_boost("Add", param=1), **CAT),
    "wildcard_fuzzy_extras": _with(_leaf("w2cc", starts_with=True, levenshtein_distance=1), filter=F_CAT7),
    # trees with phrase boosts
    "or_phrase": _with(_or(_leaf("pb"), _leaf("w1bb")), phrase_boosts=PB_PHRASE),
    "and_phrase": _with(_and(_leaf("pa"), _leaf("w0a")), phrase_boosts=PB_PHRASE),
    "and_of_ors_phrase": _with(_and(_both("pc"), _both("w0a", levenshtein_distance=1)), phrase_boosts=PB_PHRASE),
    "or_of_ands_phrase": _with(
        _or(_and(_leaf("pa"), _leaf("w1bb")), _and(_leaf("pa"), _leaf("w10", path="tags")), _leaf("w2ccc")),
        phrase_boosts=PB_PHRASE,
    ),
    "or_of_ands_all_extras": _with(
        _or(_and(_both("pb"), _leaf("w10", levenshtein_distance=1)), _both("w2ccc")),
        phrase_boosts=PB_PHRASE, filter=_filter_or(F_CAT3, F_CAT7, F_W0A),
        boost=_boost("Log10", param=1), **CAT,
    ),
    # filters that are trees
    "filter_or": _with(_leaf("w0a"), filter=_filter_or(F_CAT3, F_CAT7)),
    "filter_and": _with(_leaf("w0a"), filter=_filter_and(F_W1BB, _filter_or(F_CAT3, F_CAT7))),
    "filter_fuzzy_leaf": _with(_leaf("w0a"), filter={"search": {"terms": ["c13"], "path": "cat",
                                                                "levenshtein_distance": 1}}),
    "filter_prefix_leaf": _with(_leaf("w0a"), filter={"search": {"terms": ["w1b"], "path": "title",
                                                                 "starts_with": True}}),
    "filter_no_match": _with(_leaf("w0a"), filter={"search": {"terms": ["nothere"], "path": "title"}}),
    "filter_empty_or": _with(_leaf("w0a"), filter=_filter_or()),
    # token-value leaves
    "token_value_multiply": _leaf("w1bb", token_value={"path": "title", "boost_fun": "Multiply", "param": 1}),
    "token_value_in_or": _or(_leaf("w2ccc", token_value={"path": "title", "boost_fun": "Add"}),
                             _leaf("w10", token_value={"path": "title", "boost_fun": "Log10", "param": 1})),
    "token_value_with_extras": _with(_leaf("w3dddd", levenshtein_distance=1,
                                           token_value={"path": "title", "boost_fun": "Multiply"}), **CAT),
    # everything together, and windows
    "all_extras": _with(
        _and(_both("w0a"), _both("w1bb", levenshtein_distance=1)),
        filter=_filter_or(F_CAT3, F_CAT7, F_W0A), boost=_boost("Log10", param=1) + _boost("Multiply", path="rank"),
        facets=[{"field": "cat", "top": 4}, {"field": "labels[]"}], phrase_boosts=PB_PHRASE,
    ),
    "window_top_skip": _with(_leaf("w0a"), boost=_boost("Multiply", param=1), top=3, skip=2, **CAT),
    "window_large_top": _with(_leaf("w1bb"), filter=F_CAT3, top=500),
    "window_skip_past_hits": _with(_leaf("w1bb"), skip=100000, **CAT),
    # past the reference's TPU-only caps (ROADMAP C3): its per-request
    # executor or fused fuzzy route, the port's tree route
    "phrase_over_8192_anchors": _with(
        _leaf("pa"), phrase_boosts=[_phrase("pa", "pb"), _phrase("pb", "pc"), _phrase("pc", "pd")],
    ),
    "fuzzy_over_256_matches_extras": _with(_leaf("w1aaa", levenshtein_distance=4), filter=F_CAT3, **CAT),
    "prefix_over_64_extras": _with(_leaf("w1", starts_with=True), boost=_boost("Multiply", param=1)),
}

# the generator's own requests (search_query on each side)
GENERATED = {
    "gen_facets_boost": dict(search_term="w0a w1bb", facets=["cat"],
                             boost_queries=[{"path": "pop", "boost_fun": "Log10", "param": 1}]),
    "gen_phrase_filter": dict(search_term="pa pb w2ccc", phrase_pairs=True, filter="cat:c3 OR cat:c7"),
    "gen_all": dict(search_term="pb pc~1 AND w0a", phrase_pairs=True, facets=["cat", "labels[]"],
                    filter="cat:c3", boost_queries=[{"path": "pop", "boost_fun": "Multiply", "param": 1}]),
}

NAMES = list(CASES) + list(GENERATED)
HOST_REFERENCE = {"boost_expression"}  # 10 / $SCORE of a zero value: +inf
APPROX = {
    "boost_log10", "boost_log2", "boost_expression", "boost_mul_expression", "boost_log10_of_zero",
    "boost_chain", "token_value_in_or", "or_of_ands_all_extras", "all_extras", "and_of_ors_phrase",
    "gen_facets_boost", "gen_phrase_filter", "gen_all", "or_of_ands_phrase",
}


def _gen_params(cls, name):
    kw = dict(GENERATED[name])
    if "boost_queries" in kw:
        from veloci_tpu_torch.query.request import RequestBoostPart

        kw["boost_queries"] = [RequestBoostPart.from_dict(b) for b in kw["boost_queries"]]
        if cls is RefParams:
            from veloci_tpu.query.request import RequestBoostPart as RefBoost

            kw["boost_queries"] = [RefBoost.from_dict(b) for b in GENERATED[name]["boost_queries"]]
    return cls(**kw)


def _ref_request(pers, name):
    if name in GENERATED:
        return ref_search_query(pers, _gen_params(RefParams, name))
    return Request.from_dict(CASES[name])


def _port_request(index, name):
    if name in GENERATED:
        return search_query(index, _gen_params(SearchQueryGeneratorParameters, name))
    return PortRequest.from_dict(CASES[name])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data = _corpus()
    pers = Persistence.create_from_str(data, CONFIG)
    add_token_values_to_tokens(pers, *_token_values())
    directory = tmp_path_factory.mktemp("torch_generic_index")
    pers.save(str(directory))
    reqs = [_ref_request(pers, name) for name in NAMES]
    stats_mod.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_mod, "SMALL_DOCS", 1)
        mp.setattr(ex_mod, "SMALL_DOCS", 1)
        ref = batch_mod.search_batch(reqs, pers)
        routes = stats_mod.snapshot()["paths"]
        device_ref = dict(zip(NAMES, ref))
        # the reference's route per case, each alone
        ref_route = {}
        for name, req in zip(NAMES, reqs):
            stats_mod.reset()
            batch_mod.search_batch([req], pers)
            ref_route[name] = {k for k, v in stats_mod.snapshot()["paths"].items() if v}
    stats_mod.reset()
    ref = [ex_mod.search(r, pers) if n in HOST_REFERENCE else a for n, r, a in zip(NAMES, reqs, ref)]
    # the port's own builder, with its own token values, loaded from disk
    port_pers = PortPersistence.from_built(create_indices_from_str(data, CONFIG))
    port_add_token_values(port_pers, *_token_values())
    port_dir = tmp_path_factory.mktemp("torch_generic_port_index")
    port_pers.save(str(port_dir))
    indexes = {"ref_disk": load_index(str(directory), "cpu"), "port_built": TorchIndex.from_persistence(
        PortPersistence.load(str(port_dir)), "cpu")}
    return pers, dict(zip(NAMES, ref)), indexes, routes, (ref_route, device_ref)


@pytest.fixture(scope="module")
def batched(built):
    _pers, _ref, indexes, _routes, _ref_route = built
    out = {}
    for name, idx in indexes.items():
        before = idx.path_counts["batched_generic"]
        out[name] = dict(zip(NAMES, search_batch([_port_request(idx, n) for n in NAMES], idx)))
        out[name + "_generic"] = idx.path_counts["batched_generic"] - before
    return out


def _facets(res):
    return None if res.facets is None else {k: [list(t) for t in v] for k, v in res.facets.items()}


def _assert_parity(got, want, name):
    assert got.num_hits == want.num_hits
    assert _facets(got) == _facets(want)
    assert [h.id for h in got.data] == [h.id for h in want.data]
    gs = np.array([h.score for h in got.data], np.float32)
    ws = np.array([h.score for h in want.data], np.float32)
    if name in APPROX:
        np.testing.assert_allclose(gs, ws, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(gs.view(np.int32), ws.view(np.int32))


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", NAMES)
def test_batch_parity(built, batched, index, name):
    _pers, ref, _indexes, _routes, _ref_route = built
    _assert_parity(batched[index][name], ref[name], name)


@pytest.mark.parametrize("name", NAMES)
def test_request_alone_parity(built, name):
    _pers, ref, indexes, _routes, _ref_route = built
    idx = indexes["ref_disk"]
    got = search_batch([_port_request(idx, name)], idx)[0]
    _assert_parity(got, ref[name], name)


def test_cases_cover_the_routes(built, batched):
    """The reference answered the cases on its batched generic route (the
    C3 cases past its caps excepted), the port on its counterpart."""
    pers, ref, _indexes, routes, (ref_route, device_ref) = built
    assert routes.get("batched_generic", 0) > 0
    # the reference's device top-k reports the infinite score under the pad id
    inf_case = device_ref["boost_expression"].data[0]
    assert inf_case.score == np.inf and inf_case.id == pers.num_docs
    assert ref["boost_expression"].data[0].score == np.inf and ref["boost_expression"].data[0].id < pers.num_docs
    c3 = {"phrase_over_8192_anchors", "fuzzy_over_256_matches_extras", "prefix_over_64_extras"}
    wrong = []
    for name in NAMES:
        if name.startswith("token_value") and name != "token_value_with_extras":
            ok = bool(ref_route[name] & {"batched_single_term", "batched_tree"})
        elif name in c3:
            ok = "batched_generic" not in ref_route[name]
        else:
            ok = ref_route[name] == {"batched_generic"}
        if not ok:
            wrong.append((name, ref_route[name]))
    assert not wrong
    generic = [n for n in NAMES if not n.startswith("token_value") or n == "token_value_with_extras"]
    assert batched["ref_disk_generic"] == batched["port_built_generic"] == len(generic)
    # the cases exercise what they name
    index = _indexes["ref_disk"]
    (plain,) = search_batch([PortRequest.from_dict(_or(_leaf("pa"), _leaf("w0a")))], index)
    assert ref["phrase_pair"].data[0].score > plain.data[0].score
    assert ref["filter_empty_or"].num_hits == 0 and ref["filter_no_match"].num_hits == 0
    assert 0 < ref["filter_cat"].num_hits < ref["facets"].num_hits
    assert ref["facets_top"].facets["cat"] == ref["facets"].facets["cat"][:3]
    assert batched["ref_disk"]["facets_multi_value"].to_dict()["facets"] == ref["facets_multi_value"].to_dict()["facets"]
    # Log10 of a zero value floors the hit at 1e-30 and keeps it
    assert min(h.score for h in ref["boost_log10_of_zero"].data) == np.float32(1e-30)
    for name in ("fuzzy_1_extras", "fuzzy_2_extras", "wildcard_extras", "all_extras", "or_of_ands_all_extras",
                 "phrase_repeated_pair", "gen_all", "token_value_multiply", "filter_fuzzy_leaf"):
        assert ref[name].num_hits > 0, name


# extras the reference's _generic_eligible sends to its per-request
# executor: the port answers them on its executor as the reference's
# executor does ("executor"), boost_term and text_locality included, or
# raises the executor's error. A regex leaf is held to the reference's host
# re scan (VELOCI_REGEX_DEVICE=0: ROADMAP C6)
OUT_OF_SLICE = {
    "boost_one_to_n_path": (_with(_leaf("w0a"), boost=[{"path": "labels[]", "boost_fun": "Multiply"}]), "executor"),
    "boost_without_column": (_with(_leaf("w0a"), boost=[{"path": "nr", "boost_fun": "Multiply"}]), "VelociError"),
    "facet_past_gate": (_with(_leaf("w0a"), facets=[{"field": "nr"}]), "executor"),
    "phrase_two_fields": (_with(_leaf("w0a"), phrase_boosts=[{"search1": {"terms": ["pa"], "path": "title"},
                                                              "search2": {"terms": ["pb"], "path": "tags"}}]),
                          "InvalidRequestError"),
    "boost_term": (_with(_leaf("w0a"), boost_term=[{"terms": ["w1bb"], "path": "title", "boost": 2.0}]), "executor"),
    "text_locality": (_with(_leaf("w0a"), text_locality=True, **CAT), "executor"),
    "regex_in_filter": (_with(_leaf("w0a"), filter={"search": {"terms": ["c1.*"], "path": "cat",
                                                               "is_regex": True}}), "executor"),
}


def _outcome(call):
    """The result, or the raised error's class name."""
    try:
        return call()
    except Exception as e:  # noqa: BLE001 -- the error type is the outcome compared
        return type(e).__name__


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_out_of_slice_raises(built, name):
    pers, _ref, indexes, _routes, _ref_route = built
    req, expect = OUT_OF_SLICE[name]
    if name != "regex_in_filter":  # the reference's batched route resolves a regex filter leaf on the host
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(batch_mod, "SMALL_DOCS", 1)
            assert batch_mod._generic_eligible(Request.from_dict(req), pers, pers.device_combined()) is None
    index = indexes["ref_disk"]
    batch = [PortRequest.from_dict(CASES["facets"]), PortRequest.from_dict(req)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex_mod, "SMALL_DOCS", 0)
        mp.setenv("VELOCI_REGEX_DEVICE", "0")
        mp.setattr(pers, "_field_search_cache", {}, raising=False)
        want = _outcome(lambda: ex_mod.search(Request.from_dict(req), pers, dense_only=True))
    before = index.path_counts["executor"]
    got = _outcome(lambda: search_batch(batch, index)[1])
    if expect != "executor":
        assert got == want == expect
        return
    _assert_parity(got, want, name)
    assert index.path_counts["executor"] == before + 1 and got.num_hits > 0


def test_dropped_caps_are_exceeded(built):
    """The C3 cases pass the reference's caps: phrase anchors over
    _MAX_FILTER_ANCHORS, a fuzzy leaf over _MAX_LEAF_TERMS_FUZZY, a prefix
    leaf over _MAX_LEAF_TERMS."""
    pers, _ref, _indexes, _routes, _ref_route = built
    req = Request.from_dict(CASES["phrase_over_8192_anchors"])
    assert len(batch_mod._phrase_anchor_list(pers, req.phrase_boosts)) > batch_mod._MAX_FILTER_ANCHORS
    for name, cap in (("fuzzy_over_256_matches_extras", batch_mod._MAX_LEAF_TERMS_FUZZY),
                      ("prefix_over_64_extras", batch_mod._MAX_LEAF_TERMS)):
        part = Request.from_dict(CASES[name]).search_req.part
        assert len(field_mod.get_term_ids_in_field(pers, part).term_ids) > cap


# ---------------------------------------------------------------- building blocks
BOOST_SPECS = {
    "log10": ("Log10", 1.0, ()),
    "log2": ("Log2", 2.0, ()),
    "multiply": ("Multiply", 0.5, ()),
    "add": ("Add", -0.25, ()),
    "replace": ("Replace", 1.0, ()),
    "none": ("", 0.0, ()),
    "multiply_skip": ("Multiply", 1.0, (0.75, 3.0)),
    "add_skip": ("Add", 0.0, (1.5,)),
}


@pytest.mark.parametrize("expression", [False, True], ids=["plain", "expression"])
@pytest.mark.parametrize("spec", list(BOOST_SPECS))
def test_boost_at_candidates_equals_reference(spec, expression):
    """_precompute_boost + _apply_boost_gathered against the reference's on
    random columns: absent values, scores that match skip_when_score, zero
    scores (not hits), boosts that go below zero."""
    rng = np.random.default_rng(len(spec) + 10 * expression)
    n, m = 500, 2000
    bv = (rng.integers(0, 40, n) / 4).astype(np.float32)
    pres = rng.random(n) < 0.7
    final = (rng.integers(0, 12, m) * 0.25).astype(np.float32)
    a = rng.integers(0, n, m).astype(np.int32)
    fun, param, skip = BOOST_SPECS[spec]
    expr_ref = expr_port = None
    if expression:
        expr_ref = (jnp.asarray(bv) + jnp.float32(1.0)) / jnp.float32(4.0)
        expr_port = (torch.from_numpy(bv) + 1.0) / 4.0
    pre_ref = ref_generic_step._precompute_boost(jnp.asarray(bv), jnp.asarray(pres), (fun, param, skip, expr_ref))
    want = np.asarray(ref_tree_step._apply_boost_gathered(jnp.asarray(final), jnp.asarray(a), pre_ref))
    pre = _precompute_boost(torch.from_numpy(bv), torch.from_numpy(pres), (fun, param, skip, expr_port))
    got = _apply_boost_gathered(torch.from_numpy(final), torch.from_numpy(a.astype(np.int64)), pre).numpy()
    if fun in ("Log10", "Log2") or expression:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(got > 0, final > 0)


@pytest.mark.parametrize("field", ["cat", "labels[]"])
def test_facet_csr_count_equals_matrix(built, field):
    """The CSR count of random hit sets equals the reference's dense
    relation matrix times the hits."""
    pers, _ref, indexes, _routes, _ref_route = built
    index = indexes["ref_disk"]
    rel = facet_relation(index, field)
    m, num_targets = ref_facet.facet_matrix_host(pers, field)
    assert rel is not None and rel.num_targets == num_targets
    rng = np.random.default_rng(3)
    q = 6
    hits = rng.random((q, pers.num_docs)) < np.linspace(0.001, 0.5, q)[:, None]
    seg, anchors = np.nonzero(hits)
    got = facet_counts(rel, torch.from_numpy(seg), torch.from_numpy(anchors), q).numpy()
    want = hits.astype(np.float64) @ m.astype(np.float64)
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.sum() > 0


def test_facet_gates_follow_the_reference(built):
    """A field the reference's batched route does not count (more than
    FACET_MAX_TARGETS values) is not counted by the port either."""
    pers, _ref, indexes, _routes, _ref_route = built
    assert ref_facet.facet_matrix_host(pers, "nr") is None
    assert facet_relation(indexes["ref_disk"], "nr") is None


# ---------------------------------------------------------------- goldens
GOLDENS = json.load(open(os.path.join(os.path.dirname(__file__), "goldens.json")))["entries"]


@pytest.fixture(scope="module")
def golden_indexes():
    from bench import build_corpus

    pers = PortPersistence.from_built(create_indices_from_str(data_ndjson(), TEST_CONFIG))
    port_add_token_values(pers, TOKEN_VALUES[0], TOKEN_VALUES[1])
    corpus, _vocab = build_corpus(5000)
    synth = PortPersistence.from_built(create_indices_from_str(corpus, "{}"))
    return TorchIndex.from_persistence(pers, "cpu"), TorchIndex.from_persistence(synth, "cpu")


def _golden_request(entry, golden_indexes):
    index, synth = golden_indexes
    if entry["kind"] == "request":
        return PortRequest.from_dict(dict(entry["request"])), index
    if entry["kind"] == "query":
        return search_query(index, SearchQueryGeneratorParameters(search_term=entry["query"])), index
    return PortRequest.from_dict({"search_req": {"search": {"terms": [entry["term"]], "path": "title"}}}), synth


@pytest.mark.parametrize("i", range(len(GOLDENS)))
def test_golden(i, golden_indexes):
    """The port's search_batch against the frozen goldens, with
    test_goldens.py's tolerance (scores rounded to 4 decimals), entries 15
    (boost_term) and 16 (text_locality) included."""
    req, index = _golden_request(GOLDENS[i], golden_indexes)
    _check_golden(GOLDENS[i], search_batch([req], index)[0])


@pytest.mark.parametrize("i", range(len(GOLDENS)))
def test_golden_search(i, golden_indexes):
    """The same goldens through ``search``, one request at a time, and
    through its dense executor."""
    req, index = _golden_request(GOLDENS[i], golden_indexes)
    _check_golden(GOLDENS[i], search(req, index))
    _check_golden(GOLDENS[i], search(req, index, dense_only=True))


def _check_golden(entry, res):
    assert res.num_hits == entry["num_hits"]
    assert [[h.id, round(float(h.score), 4)] for h in res.data[:10]] == [list(x) for x in entry["top"]]
    if entry.get("facets"):
        assert _facets(res) == {k: [list(t) for t in v] for k, v in entry["facets"].items()}
