"""``boost_term``, ``text_locality``, ``why_found`` and suggest in the port
(``veloci_tpu_torch``) against the JAX package, and ``TorchIndex.warmup``.

* ``tests/test_all.py``'s boost-term, text-locality, why-found, suggest and
  field-search cases, ``tests/test_why_found.py``'s cases and
  ``tests/test_suggest_fast.py``'s four tests, run on the port by rebinding
  those modules' entry points (``run``, ``suggest``, ``Request``, ``ex_mod``
  and the reference's ``get_term_ids_in_field``). The rebound ``run`` answers
  each request through the port's ``search``, ``search(dense_only=True)``
  and ``search_batch`` and holds each answer, and its documents, to the
  reference's ``search``, on its device branch (``SMALL_DOCS`` 0) and on
  its host branch; the rebound ``suggest`` holds ``suggest`` and
  ``suggest_batch`` to the reference's. The reference's test files stay as
  they are.
* Feature requests on the ``TEST_CONFIG`` index (boost_term parts exact,
  fuzzy, regex, on 1:n fields and without a match; text locality over one
  field, two fields and an AND; why_found with and without
  ``select`` on every route) the same way, and in one ``search_batch``; the
  text-locality factor's anchor-identity branch on a corpus with such a
  column; suggest requests from ``suggest_query`` at distance 0 to 2.
* B10's factor against the reference's ``term_boost_factor`` (a seeded
  hypothesis test: anchors, counts and boosts drawn), and the term-boost
  cache.
* ``TorchIndex.warmup``: its seconds, its breakdown, the caches it fills.

Goldens 15 (``boost_term``) and 16 (``text_locality``) are entries of
``tests/test_torch_generic.py``'s golden tests.

Regex leaves are held to the reference's host ``re`` scan
(``VELOCI_REGEX_DEVICE=0``), as ``tests/test_torch_regex.py`` holds them.

Tolerance: exact everywhere: ids, order, ``num_hits``, f32 score bits,
facets, ``why_found_terms``, ``why_found_info``, documents, the suggest
triples and the factor's bits.
"""

import dataclasses
import gc
import importlib
import json
from collections import Counter
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import torch

import test_all as ta
import test_suggest_fast as tsf
import test_why_found as twf
from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens, search, search_to_result_with_doc
from veloci_tpu.query.generator import suggest_query as ref_suggest_query
import veloci_tpu_torch as vt
from veloci_tpu_torch.error import VelociError
from veloci_tpu_torch.query.request import RequestSearchPart as PortPart
from veloci_tpu_torch.search import boost as port_boost
from veloci_tpu_torch.search import executor as port_executor
from veloci_tpu_torch.search.field_search import fuzzy_spec, leaf_fuzzy, prefetch_fuzzy_matches, search_field
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

ex_mod = importlib.import_module("veloci_tpu.search.executor")
batch_mod = importlib.import_module("veloci_tpu.search.batch")
ref_fs = importlib.import_module("veloci_tpu.search.field_search")
ref_boost = importlib.import_module("veloci_tpu.search.boost")
REF_FIELD_SEARCH = ref_fs.get_term_ids_in_field


class Pair(NamedTuple):
    """One corpus in both packages: the reference's index and the port's."""

    pers: object
    index: object


def _pairs(data, config, tmp_path_factory, token_values=False):
    """{"ref_disk": the reference's index directory read by the port,
    "port_built": the port's own build} beside the reference's index."""
    pers = Persistence.create_from_str(data, config)
    port = vt.Persistence.from_built(vt.create_indices_from_str(data, config))
    if token_values:
        add_token_values_to_tokens(pers, *TOKEN_VALUES)
        vt.add_token_values_to_tokens(port, *TOKEN_VALUES)
    directory = tmp_path_factory.mktemp("torch_features")
    pers.save(str(directory))
    return {"ref_disk": Pair(pers, vt.load_index(str(directory), "cpu")),
            "port_built": Pair(pers, vt.TorchIndex.from_persistence(port, "cpu"))}


@pytest.fixture(scope="module")
def all_corpus(tmp_path_factory):
    return _pairs(data_ndjson(), TEST_CONFIG, tmp_path_factory, token_values=True)


@pytest.fixture(scope="module")
def why_corpus(tmp_path_factory):
    return _pairs("\n".join(json.dumps(d, ensure_ascii=False) for d in twf.DATA), twf.CONFIG,
                  tmp_path_factory)


def _suggest_docs():
    """``tests/test_suggest_fast.py``'s corpus (its ``pers`` fixture's data)."""
    rng = np.random.default_rng(3)
    words = (
        ["Apple", "apple", "APPLEs", "applet", "appletree", "apfel"]
        + ["Ärger", "ärgerlich", "ärger"]
        + [f"app{i}" for i in range(30)]
        + [f"ap{'p' * (i % 6)}le{i}" for i in range(40)]
        + ["zz"]
    )
    docs = []
    for i in range(400):
        t1 = " ".join(rng.choice(words, size=3))
        t2 = " ".join(rng.choice(words, size=2))
        docs.append(json.dumps({"title": t1, "sub": t2, "nr": str(i)}))
    return "\n".join(docs)


@pytest.fixture(scope="module")
def suggest_corpus(tmp_path_factory):
    return _pairs(_suggest_docs(), "{}", tmp_path_factory)


# ---------------------------------------------------------------- the comparison

def _key(res):
    return (res.num_hits, [(h.id, np.float32(h.score).view(np.int32).item()) for h in res.data],
            res.to_dict().get("facets"), res.why_found_terms, res.why_found_info)


def _docs(res):
    d = res.to_dict()
    d.pop("execution_time_ns")
    return d


def _ref_answers(pers, spec):
    """The reference's ``search`` of the request dict with its documents, on
    its device branch (``SMALL_DOCS`` 0) and on its host branch."""
    out = []
    for device_branch in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if device_branch:
                mp.setattr(ex_mod, "SMALL_DOCS", 0)
                mp.setattr(batch_mod, "SMALL_DOCS", 0)
            mp.setenv("VELOCI_REGEX_DEVICE", "0")
            mp.setattr(pers, "_field_search_cache", {}, raising=False)
            req = Request.from_dict(spec)
            res = search(req, pers)
            out.append((res, search_to_result_with_doc(pers, res, req.select)))
    return out


def _port_answers(index, spec):
    """The port's answers through ``search``, ``search(dense_only=True)`` and
    ``search_batch``, each with its documents."""
    out = []
    for answer in (lambda r: vt.search(r, index), lambda r: vt.search(r, index, dense_only=True),
                   lambda r: vt.search_batch([r], index)[0]):
        req = vt.Request.from_dict(spec)
        res = answer(req)
        out.append((res, vt.search_to_result_with_doc(index, res, req.select)))
    return out


def _run(pair, spec):
    """``run`` of the reference's test modules, on the port: the port's
    answer with its documents, after every port entry point's answer and
    documents are found equal to the reference's on both branches."""
    wants = _ref_answers(pair.pers, spec)
    gots = _port_answers(pair.index, spec)
    for res, docs in gots:
        for want, want_docs in wants:
            assert _key(res) == _key(want), spec
            assert _docs(docs) == _docs(want_docs), spec
    return gots[0][1]


class _Requests:
    """A test module's ``Request``: ``from_dict`` gives the request in both
    packages."""

    @staticmethod
    def from_dict(spec):
        return SimpleNamespace(ref=Request.from_dict(spec), port=vt.Request.from_dict(spec))


def _suggest(pair, req):
    """``suggest`` of ``tests/test_all.py``, on the port, held to the
    reference's."""
    want = ex_mod.suggest(pair.pers, req.ref)
    got = vt.suggest(pair.index, req.port)
    assert got == want
    assert vt.suggest_batch(pair.index, [req.port, req.port]) == [want, want]
    return got


def _part_of(ref_part):
    assert ref_part.token_value is None
    return PortPart(**{f.name: getattr(ref_part, f.name) for f in dataclasses.fields(ref_part)})


def _field_search(pair, part, **flags):
    """The reference's ``get_term_ids_in_field``, on the port's
    ``search_field``, held to the reference's."""
    want = REF_FIELD_SEARCH(pair.pers, part, **flags)
    port_part = _part_of(part)
    got = search_field(pair.index, port_part, leaf_fuzzy(pair.index, port_part), **flags)
    assert got.terms == want.terms
    assert np.array_equal(got.term_ids, want.term_ids)
    assert np.array_equal(got.term_scores.view(np.int32), want.term_scores.view(np.int32))
    return got


# ---------------------------------------------------------------- the reference's test modules

ALL_CASES = ["test_boost_terms", "test_boost_terms_and_from_cache", "test_boost_text_locality",
             "test_should_add_why_found_terms", "test_real_suggest_with_score",
             "test_multi_real_suggest_with_score", "test_suggest_with_token_value_boost",
             "test_field_search_return_terms"]


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", ALL_CASES)
def test_all_cases_on_the_port(all_corpus, monkeypatch, index, name):
    monkeypatch.setattr(ta, "run", _run)
    monkeypatch.setattr(ta, "suggest", _suggest)
    monkeypatch.setattr(ta, "Request", _Requests)
    if name == "test_field_search_return_terms":  # the reference's own code imports it too
        monkeypatch.setattr(ref_fs, "get_term_ids_in_field", _field_search)
    getattr(ta, name)(all_corpus[index])


WHY_FOUND_CASES = [n for n in dir(twf) if n.startswith("test_") and n != "test_get_number_of_docs"]


def test_why_found_cases_listed():
    assert len(WHY_FOUND_CASES) == 15 and "test_regex_why_found_token" in WHY_FOUND_CASES


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", WHY_FOUND_CASES)
def test_why_found_cases_on_the_port(why_corpus, monkeypatch, index, name):
    monkeypatch.setattr(twf, "run", _run)
    getattr(twf, name)(why_corpus[index])


SUGGEST_FAST_TESTS = {
    "test_fast_path_parity": [(case,) for case in tsf.CASES],
    "test_fast_path_randomized": [()],
    "test_fast_path_declines_unsupported": None,
    "test_suggest_batch_matches_sequential": None,
}


@pytest.mark.parametrize("name,args", [
    (name, args) for name, cases in SUGGEST_FAST_TESTS.items() for args in (cases or [()])
], ids=lambda v: v if isinstance(v, str) else None)
def test_suggest_fast_tests_on_the_port(suggest_corpus, name, args):
    """``tests/test_suggest_fast.py`` with its executor module, ``suggest`` and
    ``Request`` rebound to the port's. Its ``_slow`` patches and undoes the
    monkeypatch it is given, so the rebinding has a patch of its own."""
    index = suggest_corpus["ref_disk"].index
    with pytest.MonkeyPatch.context() as rebind:
        rebind.setattr(tsf, "ex_mod", port_executor)
        rebind.setattr(tsf, "suggest", vt.suggest)
        rebind.setattr(tsf, "Request", vt.Request)
        fn = getattr(tsf, name)
        with pytest.MonkeyPatch.context() as mp:
            if name in ("test_fast_path_parity", "test_fast_path_randomized"):
                fn(index, *args, mp)
            else:
                fn(index)


def _suggest_specs():
    rng = np.random.default_rng(11)
    specs = [dict(case) for case in tsf.CASES]
    prefixes = ["a", "ap", "app", "appl", "apple", "applet", "är", "z", "q", "Appl", "ÄR"]
    for _ in range(24):
        spec = {"suggest": [{"terms": [str(rng.choice(prefixes))], "path": str(rng.choice(["title", "sub"])),
                             "starts_with": True}],
                "top": int(rng.integers(1, 15))}
        if rng.random() < 0.4:
            spec["skip"] = int(rng.integers(0, 5))
        if rng.random() < 0.3:
            spec["suggest"][0]["levenshtein_distance"] = int(rng.integers(1, 3))
        if rng.random() < 0.3:
            spec["suggest"].append(dict(spec["suggest"][0], path="sub", boost=0.5))
        specs.append(spec)
    return specs


SUGGEST_SPECS = _suggest_specs()


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
def test_suggest_equals_reference(suggest_corpus, index):
    """Each request's suggestions, one by one and in one batch, and the
    fast and the general path apart, equal the reference's."""
    pair = suggest_corpus[index]
    wants = [ex_mod.suggest(pair.pers, Request.from_dict(s)) for s in SUGGEST_SPECS]
    reqs = [vt.Request.from_dict(s) for s in SUGGEST_SPECS]
    assert vt.suggest_batch(pair.index, reqs) == wants
    for spec, req, want in zip(SUGGEST_SPECS, reqs, wants):
        assert vt.suggest(pair.index, req) == want, spec
        ref_fast = ex_mod._suggest_fast(pair.pers, Request.from_dict(spec))
        assert port_executor._suggest_fast(pair.index, req) == ref_fast, spec
        fuzzy = prefetch_fuzzy_matches(pair.index, {fuzzy_spec(p) for p in req.suggest} - {None})
        general = port_executor._suggest_general(pair.index, req, fuzzy)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ex_mod, "_suggest_fast", lambda *_a: None)
            assert general == ex_mod.suggest(pair.pers, Request.from_dict(spec)), spec


# ---------------------------------------------------------------- feature requests on TEST_CONFIG

GER, ENG, KANJI = "meanings.ger[]", "meanings.eng[]", "kanji[].text"


def _leaf(term, path=GER, **kw):
    return {"search": dict({"terms": [term], "path": path}, **kw)}


def _or(*queries):
    return {"or": {"queries": list(queries)}}


def _and(*queries):
    return {"and": {"queries": list(queries)}}


def _bt(term, path=GER, **kw):
    return dict({"terms": [term], "path": path}, **kw)


CASES = {
    # boost_term: parts exact, fuzzy, on 1:n fields, with no match, defaults
    "bt_ent_seq": {"search_req": _leaf("weich", levenshtein_distance=1),
                   "boost_term": [_bt("9555", "ent_seq", boost=5.0)]},
    "bt_fuzzy_part": {"search_req": _or(_leaf("guter"), _leaf("text"), _leaf("weich")),
                      "boost_term": [_bt("welch", levenshtein_distance=1, boost=3.0)]},
    "bt_default_boost": {"search_req": _or(_leaf("guter"), _leaf("text")), "boost_term": [_bt("localität")]},
    # a part's matched ids resolve to anchors as text ids: a token alone
    # ("alle") resolves to none, in both packages
    "bt_two_parts_one_anchor": {"search_req": _or(_leaf("text"), _leaf("treffer")),
                                "boost_term": [_bt("localität", boost=1.5), _bt("welch", boost=0.5),
                                               _bt("alle", boost=3.0)]},
    "bt_counts": {"search_req": _or(_leaf("guter"), _leaf("text"), _leaf("weich")),
                  "boost_term": [_bt(".*e.*", is_regex=True, boost=1.1)]},
    "bt_one_n": {"search_req": _leaf("意", KANJI, starts_with=True), "boost_term": [_bt("意欲", KANJI, boost=7.0)]},
    "bt_no_match": {"search_req": _leaf("guter"), "boost_term": [_bt("nothere", boost=9.0)]},
    "bt_with_extras": {"search_req": _or(_leaf("guter"), _leaf("will", ENG), _leaf("majestät")),
                       "boost_term": [_bt("will", ENG, boost=2.5)], "facets": [{"field": "tags[]"}],
                       "filter": _or(_leaf("nice", "tags[]"), _leaf("cool", "tags[]")), "top": 2, "skip": 1},
    "bt_deep_tree": {"search_req": _or(_and(_or(_leaf("guter"), _leaf("text")), _leaf("treffer")), _leaf("welch")),
                     "boost_term": [_bt("welch", boost=4.0)]},
    # text locality
    "tl_one_field": {"search_req": _or(_leaf("text"), _leaf("localität")), "text_locality": True},
    "tl_fuzzy": {"search_req": _or(_leaf("guter", levenshtein_distance=1), _leaf("treffer", levenshtein_distance=1),
                                   _leaf("nicht")), "text_locality": True},
    "tl_two_fields": {"search_req": _or(_leaf("will", ENG), _leaf("testo", ENG), _leaf("wille"), _leaf("m")),
                      "text_locality": True},
    "tl_and": {"search_req": _and(_leaf("alle"), _leaf("words")), "text_locality": True},
    "tl_single_leaf": {"search_req": _leaf("text"), "text_locality": True},
    "tl_eng": {"search_req": _or(_leaf("majestic", ENG), _leaf("appearance", ENG), _leaf("will", ENG)),
               "text_locality": True},
    "tl_and_boost_term": {"search_req": _or(_leaf("text"), _leaf("localität"), _leaf("alle")),
                          "text_locality": True, "boost_term": [_bt("words", boost=2.0)]},
    # why_found, on every route
    "wf_single": {"search_req": _leaf("weich", levenshtein_distance=1), "why_found": True},
    "wf_select": {"search_req": _leaf("weich", levenshtein_distance=1), "why_found": True,
                  "select": [GER, "ent_seq"]},
    "wf_two_fields_select": {"search_req": _or(_leaf("will", ENG), _leaf("wille")), "why_found": True,
                             "select": [GER, ENG]},
    "wf_same_first_term": {"search_req": _or(_leaf("treffer"), _leaf("treffer", levenshtein_distance=1)),
                           "why_found": True, "select": [GER]},
    "wf_deep_tree": {"search_req": _or(_and(_or(_leaf("guter"), _leaf("text")), _leaf("treffer")), _leaf("welch")),
                     "why_found": True, "select": [GER]},
    "wf_extras": {"search_req": _or(_leaf("guter"), _leaf("majestät")), "why_found": True, "select": ["tags[]", GER],
                  "facets": [{"field": "tags[]"}], "filter": _leaf("nice", "tags[]")},
    "wf_prefix": {"search_req": _leaf("majes", starts_with=True), "why_found": True, "select": [GER]},
    "wf_one_n": {"search_req": _leaf("意", KANJI, starts_with=True), "why_found": True, "select": [KANJI]},
    "wf_regex": {"search_req": _leaf(".*eich", is_regex=True), "why_found": True, "select": [GER]},
    "wf_no_hit": {"search_req": _leaf("nothere"), "why_found": True, "select": [GER]},
    "wf_text_locality": {"search_req": _or(_leaf("text"), _leaf("localität")), "why_found": True,
                         "text_locality": True, "select": [GER]},
    # a search request that carries suggest parts: its search_req is answered
    "carries_suggest": {"search_req": _leaf("guter"), "suggest": [_bt("gut", starts_with=True)]},
}
EXECUTOR = {n for n in CASES if n.startswith(("bt_", "tl_")) or n in ("wf_regex", "wf_text_locality",
                                                                       "carries_suggest")}


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", list(CASES))
def test_feature_request_equals_reference(all_corpus, index, name):
    pair = all_corpus[index]
    before = pair.index.path_counts["executor"]
    _run(pair, CASES[name])
    # search, search(dense_only=True), search_batch: the executor answers
    # dense_only always, and the rest where the admission sends them
    assert pair.index.path_counts["executor"] - before == (3 if name in EXECUTOR else 1)


def test_feature_cases_exercise_what_they_name(all_corpus):
    pair = all_corpus["ref_disk"]
    res = {n: vt.search(vt.Request.from_dict(s), pair.index) for n, s in CASES.items()}
    plain = {n: vt.search(vt.Request.from_dict({k: v for k, v in s.items()
                                                if k not in ("boost_term", "text_locality")}), pair.index)
             for n, s in CASES.items()}
    for n in CASES:
        assert res[n].num_hits > 0 or n in ("wf_no_hit",), n
        moved = _key(res[n])[1] != _key(plain[n])[1]
        assert moved == (n.startswith(("bt_", "tl_")) and n not in ("bt_no_match", "tl_single_leaf")
                         or n == "wf_text_locality"), n
        assert bool(res[n].why_found_terms) == (n.startswith("wf_") and n != "wf_no_hit"), n
        assert bool(res[n].why_found_info) == (n.startswith("wf_") and "select" in CASES[n]
                                               and n != "wf_no_hit"), n
    assert res["wf_same_first_term"].why_found_terms[GER + ".textindex"] == ["Treffer", "Treffer"]


def test_feature_requests_in_one_batch(all_corpus):
    """Every case in one ``search_batch``: each answer as alone."""
    pair = all_corpus["port_built"]
    batch = vt.search_batch([vt.Request.from_dict(s) for s in CASES.values()], pair.index)
    for name, got in zip(CASES, batch):
        assert _key(got) == _key(vt.search(vt.Request.from_dict(CASES[name]), pair.index)), name


IDENTITY_LINES = [json.dumps({"n": f"k{i}", "t": f"w{i % 3} x"}) for i in range(12)]


def test_text_locality_on_an_anchor_identity_column(tmp_path_factory):
    """Two leaves whose first terms differ in case match one term of a
    column whose text ids are the anchors."""
    pairs = _pairs("\n".join(IDENTITY_LINES), "{}", tmp_path_factory)
    spec = {"search_req": _or(_leaf("K3", "n"), _leaf("k3", "n"), _leaf("k4", "n")), "text_locality": True}
    for pair in pairs.values():
        assert pair.index.is_anchor_identity_column("n")
        got = _run(pair, spec)
        assert got.data[0].hit.id == 3 and got.data[0].hit.score > 2 * got.data[1].hit.score


SUGGEST_QUERIES = [("majes", None, None), ("wil", 1, None), ("begeist", 0, [GER]), ("guter", 2, None),
                   ("tre", 1, [GER, ENG]), ("意", None, [KANJI]), ("ma", 1, None)]


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("term,levenshtein,fields", SUGGEST_QUERIES)
def test_suggest_query_equals_reference(all_corpus, index, term, levenshtein, fields):
    pair = all_corpus[index]
    ref_req = ref_suggest_query(term, pair.pers, None, None, levenshtein, fields)
    port_req = vt.suggest_query(term, pair.index, None, None, levenshtein, fields)
    assert [dataclasses.astuple(p) for p in port_req.suggest] == [dataclasses.astuple(p) for p in ref_req.suggest]
    want = ex_mod.suggest(pair.pers, ref_req)
    assert want
    assert vt.suggest(pair.index, port_req) == want
    assert vt.suggest_batch(pair.index, [port_req, port_req]) == [want, want]


def test_suggest_paths_counted(all_corpus):
    index = all_corpus["port_built"].index
    before = Counter(index.path_counts)
    fast = vt.Request.from_dict({"suggest": [_bt("majes", starts_with=True)], "top": 5})
    vt.suggest_batch(index, [fast, vt.suggest_query("majes", index, fields=[GER])])
    assert index.path_counts["suggest_fast"] - before["suggest_fast"] == 1
    assert index.path_counts["suggest_general"] - before["suggest_general"] == 1
    with pytest.raises(VelociError, match="only suggest"):
        vt.suggest(index, vt.Request.from_dict({"search_req": _leaf("guter")}))


def test_explain_still_raises_naming_a13b(all_corpus):
    """Explain is answered on both entry points: on the request or in a
    leaf's options, with why_found beside it, with entries for every hit
    (their values are tests/test_torch_explain.py's). The name is the one
    the test had while explain raised; it is kept so the test's record
    carries on."""
    index = all_corpus["port_built"].index
    for spec in ({"search_req": _leaf("guter"), "explain": True},
                 {"search_req": _leaf("guter", options={"explain": True}), "why_found": True}):
        for call in (lambda r: vt.search(r, index), lambda r: vt.search_batch([r], index)[0]):
            res = call(vt.Request.from_dict(spec))
            assert res.data and set(res.explain) == {h.id for h in res.data}, spec


# ---------------------------------------------------------------- B10, the term-boost factor

def _identity_index(num_docs, device="cpu"):
    """A stand-in index whose every field is an anchor-identity column: a
    part's matched ids are its anchors."""
    return SimpleNamespace(num_docs=num_docs, device=torch.device(device), term_boost_cache={},
                           path_counts=Counter(), key_value_stores={},
                           is_anchor_identity_column=lambda _path: True)


def _factor_pair(num_docs, parts, device="cpu"):
    """(the port's factor, the reference's ``term_boost_factor``) for parts
    ``[(anchor ids, boost or None)]``."""
    boost_terms = [SimpleNamespace(path="f", terms=[f"t{i}"], boost=b, key=lambda i=i: ("f", i))
                   for i, (_ids, b) in enumerate(parts)]
    ids_of = {bt.key(): np.asarray(ids, np.int64) for bt, (ids, _b) in zip(boost_terms, parts)}
    index = _identity_index(num_docs, device)
    anchors = [port_boost.resolve_part_anchors(index, bt, ids_of[bt.key()]) for bt in boost_terms]
    got = port_boost.term_boost_factor_device(index, boost_terms, anchors)

    def run_part(part, **kw):
        assert kw == {"get_scores": False, "get_ids": True}
        return SimpleNamespace(path="f.textindex", hits_ids=ids_of[part.key()])

    want = ref_boost.term_boost_factor(_identity_index(num_docs), boost_terms, num_docs, run_part)
    return got, want


@settings(max_examples=60, deadline=None, derandomize=True, suppress_health_check=[HealthCheck.too_slow])
@given(
    num_docs=st.integers(1, 300),
    parts=st.lists(st.tuples(st.lists(st.integers(0, 330), max_size=120),
                             st.one_of(st.none(), st.floats(0.0625, 12.0, width=32))), max_size=4),
)
def test_term_boost_factor_bit_equal_to_reference(num_docs, parts):
    """Anchors past ``num_docs`` dropped, repeats counted, the parts'
    powers multiplied in order: the reference's host factor, bit for bit."""
    got, want = _factor_pair(num_docs, parts)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_term_boost_factor_at_high_counts():
    """Counts up to 40 at boosts whose powers XLA's ``pow`` rounds otherwise
    (the reference's device branch differs there; its host branch is held)."""
    rng = np.random.default_rng(5)
    anchors = np.repeat(np.arange(41), np.arange(41))
    parts = [(rng.permutation(anchors) + 41 * j, b) for j, b in enumerate((3.0, 5.0, 1.7, 0.3, 7.3))]
    got, want = _factor_pair(41 * 5, parts)
    assert np.isfinite(want).all()
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_term_boost_cache(all_corpus):
    """Anchors are resolved once per part key, counted as hits and misses,
    and the cache empties past 512 entries, as the reference's."""
    index = all_corpus["port_built"].index
    index.term_boost_cache.clear()
    spec = CASES["bt_two_parts_one_anchor"]
    before = Counter(index.path_counts)
    first = vt.search(vt.Request.from_dict(spec), index)
    second = vt.search(vt.Request.from_dict(spec), index)
    assert _key(first) == _key(second)
    assert index.path_counts["term_boost_cache_miss"] - before["term_boost_cache_miss"] == 3
    assert index.path_counts["term_boost_cache_hit"] - before["term_boost_cache_hit"] == 3
    for i in range(port_boost.TERM_BOOST_CACHE_LIMIT + 1):
        index.term_boost_cache[("filler", i)] = (torch.zeros(0, dtype=torch.int64), 0)
    vt.search(vt.Request.from_dict(CASES["bt_default_boost"]), index)
    assert len(index.term_boost_cache) == 1


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
def test_term_boost_cache_emptied_by_an_earlier_part(all_corpus, index):
    """A request whose first part misses a cache past its limit, and whose
    second part, fuzzy, was cached: the first part's miss empties the cache,
    and the second keeps the anchors it was found with. Through ``search``,
    ``search(dense_only=True)`` and ``search_batch``, equal to the
    reference's answer."""
    pair = all_corpus[index]
    cached = _bt("welch", levenshtein_distance=1, boost=3.0)
    spec = {"search_req": _or(_leaf("guter"), _leaf("text"), _leaf("weich")),
            "boost_term": [_bt("localität", boost=1.5), cached]}
    wants = _ref_answers(pair.pers, spec)
    for answer in (lambda r: vt.search(r, pair.index), lambda r: vt.search(r, pair.index, dense_only=True),
                   lambda r: vt.search_batch([r], pair.index)[0]):
        pair.index.term_boost_cache.clear()
        vt.search(vt.Request.from_dict(CASES["bt_fuzzy_part"]), pair.index)  # caches the ~1 part
        for i in range(port_boost.TERM_BOOST_CACHE_LIMIT + 1):
            pair.index.term_boost_cache[("filler", i)] = (torch.zeros(0, dtype=torch.int64), 0)
        assert vt.Request.from_dict(spec).boost_term[1].key() in pair.index.term_boost_cache
        before = Counter(pair.index.path_counts)
        got = answer(vt.Request.from_dict(spec))
        assert pair.index.path_counts["term_boost_cache_miss"] - before["term_boost_cache_miss"] == 1
        assert pair.index.path_counts["term_boost_cache_hit"] - before["term_boost_cache_hit"] == 1
        assert len(pair.index.term_boost_cache) == 1
        for want, _docs_want in wants:
            assert _key(got) == _key(want)


# ---------------------------------------------------------------- warmup

def test_warmup_fills_the_caches(all_corpus, monkeypatch):
    pair = all_corpus["port_built"]
    index = vt.TorchIndex.from_persistence(
        vt.Persistence.from_built(vt.create_indices_from_str(data_ndjson(), TEST_CONFIG)), "cpu")
    monkeypatch.setattr(gc, "freeze", lambda: pytest.fail("warmup froze the collector"))
    assert not index.cache
    seconds = index.warmup()
    assert isinstance(seconds, float) and seconds > 0
    assert set(index.last_warmup_breakdown) == {"build_s", "upload_s", "probe_s"}
    assert sum(index.last_warmup_breakdown.values()) <= seconds
    assert all(("boost", p) in index.cache for p in index.boost_stores)
    assert all(("facet", f, True) in index.cache for f in index.all_fields)
    assert index.cache["filter_masks"] and index.regex_rows
    assert index.path_counts["executor"] == 1 and sum(index.path_counts.values()) > 1
    # the probes: the largest and a median posting run, a short frequent term
    assert len(index._warmup_terms()) >= 2
    spec = {"search_req": _or(_leaf("guter"), _leaf("text")), "facets": [{"field": "tags[]"}]}
    assert _key(vt.search(vt.Request.from_dict(spec), index)) == _key(
        vt.search(vt.Request.from_dict(spec), pair.index))
    assert index.warmup(queries=["guter"], top=3) > 0
