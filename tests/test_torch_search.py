"""The port's ``search_batch`` against the JAX package's ``search_batch`` on
one seeded index, carried into the port twice: from the reference's host
arrays (``TorchIndex.from_reference_arrays``) and through ``save`` plus the
port's own reader. Every case runs in one batch and alone.

Tolerance: ids, order and ``num_hits`` exact. Scores are bit-equal (the
same f32 products and sums on both sides) except for the cases in
``APPROX``, where a union sums three or more values and the reference's
associative scan may round them in another order: there the relative error
is at most 1e-6.

Cases past the reference's caps (a prefix leaf over 64 terms, a fuzzy leaf
over 256, nesting its two-level test does not flatten) are answered by its
per-request executor and by the port's tree route; the answers agree.

``SMALL_DOCS`` is forced to 1 on the reference side so that it takes its
device kernels (on the CPU) rather than its host path for small indices."""

import importlib

import numpy as np
import pytest

import torch

from veloci_tpu import Persistence, Request
from veloci_tpu.query.generator import SearchQueryGeneratorParameters as RefParams
from veloci_tpu.query.generator import search_query as ref_search_query
from veloci_tpu_torch import Request as PortRequest
from veloci_tpu_torch import SearchQueryGeneratorParameters, TorchIndex, load_index, search_batch
from veloci_tpu_torch import search_query
from veloci_tpu_torch.ops.levenshtein_sweep import (
    levenshtein_select_banded,
    levenshtein_sweep_banded,
    levenshtein_sweep_banded_batch,
    levenshtein_sweep_full_batch,
)
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

batch_mod = importlib.import_module("veloci_tpu.search.batch")
ex_mod = importlib.import_module("veloci_tpu.search.executor")
field_mod = importlib.import_module("veloci_tpu.search.field_search")

LONG = "longterm" + "q" * 30  # 38 chars: beyond the sweep matrix
LONG33 = "longterm" + "q" * 25  # 33 chars


def _corpus() -> str:
    rng = np.random.default_rng(1234)
    vocab = [f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(2500)]
    vocab += ["Apple", "apple", "APPLE", "x" * 31, "x" * 32, LONG, LONG[:-1] + "r", LONG33]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p[-8:] = p[40]  # make the special terms common enough to hit
    p /= p.sum()
    lines = []
    for i in range(4000):
        words = rng.choice(vocab, size=int(rng.integers(3, 10)), p=p)
        tags = rng.choice(vocab[:300], size=2)  # the same terms on a second field
        lines.append(
            '{"title": "%s", "tags": "%s", "nr": "%d"}' % (" ".join(words), " ".join(tags), i)
        )
    return "\n".join(lines)


def _leaf(term, **kw):
    return {"search_req": {"search": dict({"terms": [term], "path": "title"}, **kw)}}


def _tree(kind, *children):
    return {"search_req": {kind: {"queries": [c["search_req"] for c in children]}}}


def _or(*children):
    return _tree("or", *children)


def _and(*children):
    return _tree("and", *children)


def _both(term, **kw):
    """One term on both text fields: ONE slot, so the fields' maximum."""
    return _or(_leaf(term, **kw), _leaf(term, path="tags", **kw))


CASES = {
    "exact_hit": _leaf("w1bb"),
    "exact_miss": _leaf("nothere"),
    "exact_ignore_case_multi_id": _leaf("apple"),
    "exact_case_sensitive": _leaf("Apple", ignore_case=False),
    "exact_case_sensitive_miss": _leaf("aPPle", ignore_case=False),
    "fuzzy_1": _leaf("w1ab", levenshtein_distance=1),
    "fuzzy_2": _leaf("w2ccc", levenshtein_distance=2),
    "fuzzy_3_band4": _leaf("w3dddd", levenshtein_distance=3),
    "fuzzy_clamped_to_exact": _leaf("x", levenshtein_distance=2),
    "fuzzy_case_sensitive": _leaf("Appel", levenshtein_distance=1, ignore_case=False),
    "fuzzy_long_term_extras": _leaf(LONG33[:30], levenshtein_distance=3),
    "fuzzy_query_over_31_chars": _leaf(LONG[:-2], levenshtein_distance=2),
    "fuzzy_32_char_query": _leaf("x" * 32, levenshtein_distance=1),
    "leaf_boost": _leaf("w10", levenshtein_distance=1, boost=2.5),
    "leaf_top": _leaf("w2ccc", levenshtein_distance=2, top=2, skip=1),
    "exact_leaf_boost": _leaf("w1bb", boost=0.5),
    "window_top_skip": dict(_leaf("w2ccc", levenshtein_distance=2), top=3, skip=2),
    "window_large_top": dict(_leaf("w1bb"), top=500),
    "window_skip_past_hits": dict(_leaf("w1bb"), skip=100000),
    "window_top_zero": dict(_leaf("w1bb"), top=0),
    "equal_score_ties": dict(_leaf("apple"), top=40),
    "fuzzy_over_256_matches": _leaf("w1aaa", levenshtein_distance=4),
    # trees (the reference's _node_groups / _node_deep shapes)
    "or_tree": _or(_leaf("w1bb"), _leaf("w2ccc")),
    "or_same_term_two_fields": _both("w1bb"),
    "or_three_slots": _or(_leaf("w1bb"), _leaf("w2ccc"), _leaf("w3dddd", path="tags"), _leaf("w10")),
    "and_tree": _and(_leaf("w1bb"), _leaf("w2ccc")),
    "and_three_groups": _and(_leaf("w1bb"), _leaf("w2ccc"), _leaf("w3dddd")),
    "and_of_ors": _and(_both("w1bb"), _both("w2ccc", levenshtein_distance=1)),
    "and_of_ors_window": dict(_and(_both("w0a"), _both("w1bb")), top=5, skip=3),
    "or_of_ands_repeated_term": _or(
        _and(_leaf("w1bb"), _leaf("w2ccc")), _and(_leaf("w1bb"), _leaf("w10", path="tags")),
        _leaf("w3dddd"),
    ),
    "or_of_ands_of_ors": _or(_and(_both("w1bb"), _leaf("w10", levenshtein_distance=1)), _both("w2ccc")),
    "nested_or_flattens": _or(_or(_leaf("w1bb")), _leaf("w2ccc")),
    "nested_and_flattens": _and(_and(_leaf("w0a"), _leaf("w1bb")), _both("w0a", levenshtein_distance=1)),
    # starts_with at distance 0 (prefix range) and on the full-width sweep
    "prefix_d0": _leaf("w1bb", starts_with=True),
    "prefix_d0_case_sensitive": _leaf("App", starts_with=True, ignore_case=False),
    "prefix_d1": _leaf("w2cc", starts_with=True, levenshtein_distance=1),
    "prefix_d2": _leaf("w3ddd", starts_with=True, levenshtein_distance=2),
    "prefix_d1_case_sensitive": _leaf("Appl", starts_with=True, levenshtein_distance=1, ignore_case=False),
    "prefix_long_term_extras": _leaf(LONG[:20], starts_with=True, levenshtein_distance=1),
    "prefix_query_over_31_chars": _leaf(LONG33, starts_with=True, levenshtein_distance=1),
    "prefix_both_fields": _both("w1ab", starts_with=True, levenshtein_distance=1),
    "fuzzy_5": _leaf("w1bbbbbb", levenshtein_distance=5),
    "fuzzy_5_and_prefix": _and(_leaf("w2cccccc", levenshtein_distance=5), _leaf("w1", starts_with=True)),
    # leaves past the reference's per-leaf caps, inside an AND
    "and_prefix_over_64_fuzzy_over_256": _and(
        _leaf("w1", starts_with=True), _leaf("w1aaa", levenshtein_distance=4)
    ),
}

# the generator's own requests for query strings (search_query on each side)
GENERATED = {
    "gen_wildcard": "w1ab*",
    "gen_two_words": "w2ccc w10",
    "gen_and_wildcard": "w2ccc AND w1bb*",
    "gen_a_and_b_or_c": "a AND b OR c",
    "gen_or_of_and": "w10 OR w1bb AND w2ccc",
    "gen_prefix_d0": "w1b*",
}

NAMES = list(CASES) + list(GENERATED)
# unions of three or more values: relative error <= 1e-6 (see the module note)
APPROX = {"or_three_slots", "and_three_groups", "nested_and_flattens"}


def _ref_request(pers, name):
    if name in GENERATED:
        return ref_search_query(pers, RefParams(search_term=GENERATED[name]))
    return Request.from_dict(CASES[name])


def _port_request(index, name):
    if name in GENERATED:
        return search_query(index, SearchQueryGeneratorParameters(search_term=GENERATED[name]))
    return PortRequest.from_dict(CASES[name])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    pers = Persistence.create_from_str(_corpus(), "{}")
    reqs = [_ref_request(pers, name) for name in NAMES]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(batch_mod, "SMALL_DOCS", 1)
        mp.setattr(ex_mod, "SMALL_DOCS", 1)
        ref = batch_mod.search_batch(reqs, pers)
        ns, key_base = pers.combined_host_csr()
        fields = {}
        for f in pers.dictionaries:
            dev = pers.device_field(f)
            fields[f] = (dev._chars_host, dev._lengths_host, dev._sweep_ids_host)
    from_arrays = TorchIndex.from_reference_arrays(
        num_docs=pers.num_docs, all_fields=pers.get_all_fields(),
        term_bytes={f: d.to_arrays()["term_bytes"] for f, d in pers.dictionaries.items()},
        fields=fields, offsets=ns.offsets, anchors=ns.anchors, scores=ns.scores,
        key_base=key_base, device="cpu",
    )
    directory = tmp_path_factory.mktemp("torch_index")
    pers.save(str(directory))
    indexes = {"arrays": from_arrays, "disk": load_index(str(directory), "cpu")}
    return pers, dict(zip(NAMES, ref)), indexes


@pytest.fixture(scope="module")
def batched(built):
    """Each index route's answers to the whole batch in ONE call."""
    _pers, _ref, indexes = built
    return {
        route: dict(zip(NAMES, search_batch([_port_request(idx, n) for n in NAMES], idx)))
        for route, idx in indexes.items()
    }


def _key(res):
    return res.num_hits, [(h.id, np.float32(h.score).view(np.int32)) for h in res.data]


def _assert_parity(got, want, name):
    if name not in APPROX:
        assert _key(got) == _key(want)
        return
    assert got.num_hits == want.num_hits
    assert [h.id for h in got.data] == [h.id for h in want.data]
    np.testing.assert_allclose(
        [h.score for h in got.data], [h.score for h in want.data], rtol=1e-6, atol=0
    )


@pytest.mark.parametrize("route", ["arrays", "disk"])
@pytest.mark.parametrize("name", NAMES)
def test_batch_parity(built, batched, route, name):
    _pers, ref, _indexes = built
    _assert_parity(batched[route][name], ref[name], name)


@pytest.mark.parametrize("name", NAMES)
def test_request_alone_parity(built, name):
    """A batch of one: a fuzzy leaf then takes the single-query sweep."""
    _pers, ref, indexes = built
    got = search_batch([_port_request(indexes["disk"], name)], indexes["disk"])[0]
    _assert_parity(got, ref[name], name)


def test_cases_cover_the_routes(built, batched):
    pers, ref, indexes = built
    part = Request.from_dict(CASES["fuzzy_over_256_matches"]).search_req.part
    assert len(field_mod.get_term_ids_in_field(pers, part).term_ids) > 256
    part = Request.from_dict(CASES["and_prefix_over_64_fuzzy_over_256"]).search_req.queries[0].part
    assert len(field_mod.get_term_ids_in_field(pers, part).term_ids) > 64
    assert ref["exact_hit"].num_hits > 10 and ref["fuzzy_2"].num_hits > 10
    assert ref["fuzzy_long_term_extras"].num_hits > 0
    assert len({h.score for h in ref["equal_score_ties"].data}) < 40
    for name in NAMES:
        if name.startswith(("or_", "and_", "prefix_", "fuzzy_5", "nested_", "gen_")) and name not in (
            "prefix_d0_case_sensitive", "gen_a_and_b_or_c",
        ):
            assert ref[name].num_hits > 0, name
    # the same term on two fields is one slot: its score is the fields' max
    one = batched["disk"]["or_same_term_two_fields"].data[0].score
    assert one <= max(batched["disk"]["exact_hit"].data[0].score, 1e9)
    assert ref["prefix_long_term_extras"].num_hits > 0 and ref["prefix_query_over_31_chars"].num_hits > 0
    counts = indexes["arrays"].path_counts
    assert counts["batched_single_term"] > 0 and counts["batched_tree"] > 0
    assert counts["batched_tree_deep"] > 0


def test_sweep_entry_points_run_on_cpu(built):
    """On CPU tensors the wrappers take the plain version: no launch counted."""
    _pers, _ref, indexes = built
    kernels = (levenshtein_sweep_banded_batch, levenshtein_sweep_banded, levenshtein_select_banded,
               levenshtein_sweep_full_batch)
    before = [k.launches for k in kernels]
    search_batch([PortRequest.from_dict(CASES[n]) for n in ("fuzzy_2", "prefix_d1")], indexes["disk"])
    assert [k.launches for k in kernels] == before
    assert indexes["disk"].fields["title"].chars_t.dtype == torch.uint16


# the A6 shapes the port answers (filter, phrase_boosts, token_value,
# filter_on_tree) are parity cases of test_torch_generic.py. The shapes
# the reference answers on its per-request executor only go to the port's
# executor: a facet on "nr" (more values than the batched gate), leaves
# with several terms, deeper trees, node options, regex leaves (held to the
# reference's host re scan, VELOCI_REGEX_DEVICE=0: ROADMAP C6), leaves that
# ask for snippets; their answers equal the reference executor's, and a
# boost on "nr" (no boost column) raises its VelociError. A why_found
# request rides the batched route ("batched"): its answer, why_found_terms
# included, equals the reference's search. explain, on the request or in
# a leaf's options, goes to the executor too (its entries are
# tests/test_torch_explain.py's).
OUT_OF_SLICE = {
    "request_boost": (dict(_leaf("w1bb"), boost=[{"path": "nr", "boost_fun": "Log10"}]), "VelociError"),
    "facets": (dict(_leaf("w1bb"), facets=[{"field": "nr"}]), "executor"),
    "why_found": (dict(_leaf("w1bb"), why_found=True), "batched"),
    "explain": (dict(_leaf("w1bb"), explain=True), "executor"),
    "regex": (_leaf("w1.*", is_regex=True), "executor"),
    "snippet": (_leaf("w1bb", snippet=True), "executor"),
    "leaf_options": (_leaf("w1bb", options={"explain": True}), "executor"),
    "two_terms": ({"search_req": {"search": {"terms": ["w1bb", "b"], "path": "title"}}}, "executor"),
    "four_alternations": (_or(_and(_or(_and(_leaf("w1bb"), _leaf("w2ccc")), _leaf("w0a")), _leaf("w10")),
                              _leaf("w3dddd")), "executor"),
    "regex_in_and": (_and(_leaf("w1bb"), _leaf("w1.*", is_regex=True)), "executor"),
    "two_terms_in_or": (_or(_leaf("w1bb"), {"search_req": {"search": {"terms": ["w2ccc", "b"], "path": "title"}}}),
                        "executor"),
    "tree_node_options": ({"search_req": {"and": {"queries": [_leaf("w0a")["search_req"],
                                                              _leaf("w1bb")["search_req"]],
                                                  "options": {"top": 3}}}}, "executor"),
}


@pytest.mark.parametrize("name", list(OUT_OF_SLICE))
def test_out_of_slice_raises(built, name):
    pers, _ref, indexes = built
    req, expect = OUT_OF_SLICE[name]
    index = indexes["disk"]
    batch = [PortRequest.from_dict(CASES["exact_hit"]), PortRequest.from_dict(req)]
    if expect.startswith("A"):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {expect}"):
            search_batch(batch, index)
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex_mod, "SMALL_DOCS", 0)
        mp.setattr(batch_mod, "SMALL_DOCS", 0)
        mp.setenv("VELOCI_REGEX_DEVICE", "0")
        mp.setattr(pers, "_field_search_cache", {}, raising=False)
        try:
            want = ex_mod.search(Request.from_dict(req), pers, dense_only=expect != "batched")
        except Exception as e:  # noqa: BLE001 -- the error type is what is compared
            want = type(e).__name__
    if expect == "batched":
        before = index.path_counts["executor"]
        got = search_batch(batch, index)[1]
        assert index.path_counts["executor"] == before
        _assert_parity(got, want, name)
        assert got.why_found_terms == want.why_found_terms and got.why_found_terms
        return
    if expect != "executor":
        with pytest.raises(Exception) as err:
            search_batch(batch, index)
        assert type(err.value).__name__ == want == expect
        return
    before = index.path_counts["executor"]
    got = search_batch(batch, index)[1]
    assert index.path_counts["executor"] == before + 1
    _assert_parity(got, want, name)
    assert got.num_hits > 0
