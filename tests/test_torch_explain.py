"""``explain`` and ``explain_plan`` in the port (``veloci_tpu_torch``)
against the JAX package.

* ``tests/test_all.py``'s ``test_simple_search_explained``,
  ``test_or_query_explained``, ``test_explain_plan_contents``,
  ``test_log10_boost_explained_dual_entries`` and
  ``test_prefer_short_results``, run on the port by rebinding their entry
  points (``run``, ``Request``, ``veloci_tpu.explain_plan``, and the query
  generator and ``search`` the last one imports). The rebound entry points
  answer each request through the port's ``search``,
  ``search(dense_only=True)`` and ``search_batch``, hold each answer to the
  reference's ``search`` on its device branch (``SMALL_DOCS`` 0) and on its
  host branch, and hand the port's answer to the case.
* Explained requests on the ``TEST_CONFIG`` index: every request of
  ``tests/test_torch_executor.py`` (deep trees, multi-term leaves, leaf and
  node options, a 1:n boost under each boost function and with
  expressions, column boosts Log10 included, filters, facets, phrase
  boosts, windows) and the ``boost_term`` / ``text_locality`` requests of
  ``tests/test_torch_features.py``, each with ``explain`` set, and requests
  of this file's own: explain in a leaf's options only, an OR that repeats
  a term, an AND, a deep tree, requests of the batched route's shapes with
  their extras, ``skip`` and ``top``.
* ``explain_plan`` against the reference's, line for line but the ``path``
  node, which names the port's route and kernels.

Tolerance: exact. Ids, order, ``num_hits``, facets and why-found metadata
equal; every explain entry equal as JSON text, so each float equals the
reference's to the f32 bit (``repr`` round-trips); the documents with
their explain entries equal; a raised error's class name equal.
"""

import importlib
import json
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import pytest

import test_all as ta
import test_torch_executor as tex
import test_torch_features as tfe
import veloci_tpu
from corpus import TOKEN_VALUES, data_ndjson
from veloci_tpu import Persistence, Request, add_token_values_to_tokens
from veloci_tpu.query import generator as ref_generator
import veloci_tpu_torch as vt
from veloci_tpu_torch.search import executor as port_executor
from veloci_tpu_torch.search import stats as port_stats

ex_mod = importlib.import_module("veloci_tpu.search.executor")
batch_mod = importlib.import_module("veloci_tpu.search.batch")
REF_SEARCH_QUERY = ref_generator.search_query  # the case below rebinds the module's
CONFIG = tex.CONFIG  # TEST_CONFIG with a field without postings
GER, ENG, KANJI = "meanings.ger[]", "meanings.eng[]", "kanji[].text"
_leaf, _or, _and, _req, _b = tex._leaf, tex._or, tex._and, tex._req, tex._b


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """{"ref_disk": the reference's index directory read by the port,
    "port_built": the port's own build}, each beside the reference's index."""
    data = data_ndjson()
    pers = Persistence.create_from_str(data, CONFIG)
    add_token_values_to_tokens(pers, *TOKEN_VALUES)
    port = vt.Persistence.from_built(vt.create_indices_from_str(data, CONFIG))
    vt.add_token_values_to_tokens(port, *TOKEN_VALUES)
    directory = tmp_path_factory.mktemp("torch_explain")
    pers.save(str(directory))
    return {"ref_disk": tfe.Pair(pers, vt.load_index(str(directory), "cpu")),
            "port_built": tfe.Pair(pers, vt.TorchIndex.from_persistence(port, "cpu"))}


# ---------------------------------------------------------------- the comparison

class _Raised(NamedTuple):
    name: str  # the class name of the error a call raised


def _outcome(call):
    """The call's result, or the raised error's class name."""
    try:
        return call()
    except Exception as e:  # noqa: BLE001 -- the error type is the outcome compared
        return _Raised(type(e).__name__)


def _explain_text(res) -> str:
    return json.dumps({int(k): v for k, v in res.explain.items()})


def _docs(docs) -> dict:
    d = docs.to_dict()
    d.pop("execution_time_ns")
    return d


def _ref_answers(pers, make):
    """The reference's ``search`` of ``make()``'s request, with its
    documents, on its device branch and on its host branch."""
    out = []
    for device_branch in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if device_branch:
                mp.setattr(ex_mod, "SMALL_DOCS", 0)
                mp.setattr(batch_mod, "SMALL_DOCS", 0)
            mp.setenv("VELOCI_REGEX_DEVICE", "0")
            mp.setattr(pers, "_field_search_cache", {}, raising=False)

            def answer():
                req = make()
                res = ex_mod.search(req, pers)
                return res, ex_mod.search_to_result_with_doc(pers, res, req.select)
            out.append(_outcome(answer))
    return out


def _port_answers(index, make):
    """The port's answers through ``search``, ``search(dense_only=True)``
    and ``search_batch``, each with its documents."""
    out = []
    for answer in (lambda r: vt.search(r, index), lambda r: vt.search(r, index, dense_only=True),
                   lambda r: vt.search_batch([r], index)[0]):
        def both(answer=answer):
            req = make()
            res = answer(req)
            return res, vt.search_to_result_with_doc(index, res, req.select)
        out.append(_outcome(both))
    return out


def _compare(pair, make_ref, make_port):
    """Every port answer equal to both reference answers; the port's
    ``search`` answer (or the error's name)."""
    wants = _ref_answers(pair.pers, make_ref)
    gots = _port_answers(pair.index, make_port)
    for got in gots:
        for want in wants:
            if isinstance(want, _Raised) or isinstance(got, _Raised):
                assert got == want
                continue
            (res, docs), (want_res, want_docs) = got, want
            assert tfe._key(res) == tfe._key(want_res)
            assert _explain_text(res) == _explain_text(want_res)
            assert _docs(docs) == _docs(want_docs)
    return gots[0]


def _run(pair, spec):
    """``run`` of ``tests/test_all.py``, on the port."""
    return _compare(pair, lambda: Request.from_dict(spec), lambda: vt.Request.from_dict(spec))[1]


def _plan_lines(text):
    return [line for line in text.split("\n") if not line.startswith("  path ")]


def _explain_plan(req, pair):
    """``explain_plan`` of ``tests/test_all.py``, on the port, held to the
    reference's line for line but the ``path`` node."""
    want = ex_mod.explain_plan(req.ref, pair.pers)
    got = port_executor.explain_plan(req.port, pair.index)
    assert _plan_lines(got) == _plan_lines(want)
    assert sum(line.startswith("  path ") for line in got.split("\n")) == 1
    return got


class _Generated(SimpleNamespace):
    """A generator request in both packages."""


def _search_query(pair, params):
    """The query generator, in both packages: the port's from the same
    parameters."""
    port_params = vt.SearchQueryGeneratorParameters.from_dict(
        {k: v for k, v in vars(params).items() if v is not None})
    return _Generated(pair=pair, params=params, port_params=port_params,
                      select=REF_SEARCH_QUERY(pair.pers, params).select)


def _search(gen, pair):
    return gen


def _search_to_result_with_doc(pair, gen, select):
    """The generated request through every entry point of both packages,
    held equal; the port's documents."""
    return _compare(pair, lambda: REF_SEARCH_QUERY(pair.pers, gen.params),
                    lambda: vt.search_query(pair.index, gen.port_params))[1]


ALL_CASES = ["test_simple_search_explained", "test_or_query_explained", "test_explain_plan_contents",
             "test_log10_boost_explained_dual_entries", "test_prefer_short_results"]


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", ALL_CASES)
def test_all_explain_cases_on_the_port(corpus, monkeypatch, index, name):
    monkeypatch.setattr(ta, "run", _run)
    monkeypatch.setattr(ta, "Request", tfe._Requests)
    monkeypatch.setattr(veloci_tpu, "explain_plan", _explain_plan)
    monkeypatch.setattr(ref_generator, "search_query", _search_query)
    monkeypatch.setattr(veloci_tpu, "search", _search)
    monkeypatch.setattr(veloci_tpu, "search_to_result_with_doc", _search_to_result_with_doc)
    getattr(ta, name)(corpus[index])


# ---------------------------------------------------------------- explained requests

KANJI_PREFIX = tex.KANJI_PREFIX
OWN = {
    "leaf_option_only": _req(_leaf("urge", ENG, options={"explain": True})),
    "leaf_option_in_or": _req(_or(_leaf("majestät"), _leaf("urge", ENG, options={"explain": True}))),
    "or_repeated_term": _req(_or(_leaf("treffer"), _leaf("treffer", ENG), _leaf("treffer", levenshtein_distance=1),
                                 _leaf("guter")), explain=True),
    "and": _req(_and(_leaf("guter"), _leaf("treffer")), explain=True),
    "and_or": _req(_and(_or(_leaf("guter"), _leaf("text")), _leaf("treffer")), explain=True),
    "deep_tree": _req(_or(_and(_or(_leaf("guter"), _leaf("weich", levenshtein_distance=1)), _leaf("treffer")),
                          _leaf("majestät"), _leaf("will", ENG)), explain=True),
    "fuzzy_prefix": _req(_leaf("majes", starts_with=True, levenshtein_distance=1), explain=True),
    "one_n_on_or": _req(_or(KANJI_PREFIX, _leaf("何の", KANJI)),
                        boost=[_b("kanji[].commonness", "Log10", param=1)], explain=True),
    "columns_and_one_n": _req(_or(KANJI_PREFIX, _leaf("urge", ENG)),
                              boost=[_b("kanji[].commonness", "Multiply", param=2),
                                     _b("commonness", "Log10", param=1), _b("commonness", "Log2", param=2)],
                              explain=True),
    "column_each_function": _req(_or(_leaf("guter"), _leaf("urge", ENG), _leaf("majestät")),
                                 boost=[_b("commonness", "Add", param=0.5), _b("commonness", "Multiply", param=0.25),
                                        _b("commonness", "Replace", param=3),
                                        _b("commonness", expression="$SCORE / 4")], explain=True),
    "column_skip_when_score": _req(_or(_leaf("guter"), _leaf("urge", ENG)),
                                   boost=[_b("commonness", "Log10", param=1, skip_when_score=[0.0])], explain=True),
    "batched_extras": _req(_or(_leaf("guter"), _leaf("urge", ENG), _leaf("weich", levenshtein_distance=1)),
                           filter=_leaf("nice", "tags[]"), facets=[{"field": "commonness", "top": 2}],
                           boost=[_b("commonness", "Log10", param=1)], explain=True),
    "phrase_boost": _req(_or(_leaf("guter"), _leaf("nicht"), _leaf("treffer")),
                         phrase_boosts=[{"search1": _leaf("guter")["search"], "search2": _leaf("nicht")["search"]}],
                         explain=True),
    "boost_term_and_text_locality": _req(_or(_leaf("text"), _leaf("localität"), _leaf("alle")), explain=True,
                                         text_locality=True, boost_term=[tfe._bt("words", boost=2.0)]),
    "why_found_select": _req(_or(_leaf("will", ENG), _leaf("wille")), explain=True, why_found=True,
                             select=[GER, ENG]),
    "top_skip": _req(_or(_leaf("guter"), _leaf("text"), _leaf("alle"), _leaf("weich")), top=2, skip=1,
                     explain=True),
    "top_zero": _req(_leaf("treffer"), top=0, explain=True),
    "skip_past_hits": _req(_leaf("treffer"), skip=100, explain=True),
    "no_hit": _req(_leaf("nothere"), explain=True),
}
CASES = {
    **{f"executor_{n}": dict(s, explain=True) for n, s in tex.CASES.items()},
    **{f"features_{n}": dict(s, explain=True) for n, s in tfe.CASES.items() if n.startswith(("bt_", "tl_"))},
    **OWN,
}
# the reference's errors, which the port raises too
RAISING = {"executor_boost_no_column", "executor_unknown_field", "executor_phrase_two_fields",
           "executor_one_n_two_matching"}


@pytest.mark.parametrize("index", ["ref_disk", "port_built"])
@pytest.mark.parametrize("name", list(CASES))
def test_explained_request_equals_reference(corpus, index, name):
    pair = corpus[index]
    before = pair.index.path_counts["executor"]
    got = _compare(pair, lambda: Request.from_dict(CASES[name]), lambda: vt.Request.from_dict(CASES[name]))
    if not isinstance(got, _Raised):  # every entry point answers explain on the executor
        assert pair.index.path_counts["executor"] - before == 3


def test_explained_cases_exercise_what_they_name(corpus):
    """The cases reach what they are named for: entries of every kind, two
    Boost entries for Log10, one for the rest."""
    index = corpus["ref_disk"].index
    kinds = set()
    for name, spec in CASES.items():
        res = _outcome(lambda: vt.search(vt.Request.from_dict(spec), index))
        if isinstance(res, _Raised):
            assert name in RAISING, (name, res)
            continue
        assert set(res.explain) == {h.id for h in res.data}, name
        for entries in res.explain.values():
            kinds.update(k for e in entries for k in e)
    assert kinds == {"TermToAnchor", "LevenshteinScore", "OrSumOverDistinctTerms", "Boost"}
    res = vt.search(vt.Request.from_dict(OWN["column_each_function"]), index)
    assert all(sum("Boost" in e for e in entries) >= 2 for entries in res.explain.values())
    res = vt.search(vt.Request.from_dict(CASES["executor_one_n_log10"]), index)
    assert res.explain and all(sum("Boost" in e for e in entries) == 2 for entries in res.explain.values())
    res = vt.search(vt.Request.from_dict(CASES["executor_one_n_multiply"]), index)
    assert res.explain and all(sum("Boost" in e for e in entries) == 1 for entries in res.explain.values())
    assert not vt.search(vt.Request.from_dict(OWN["no_hit"]), index).explain


def test_explained_requests_in_one_batch(corpus):
    """Every case in one ``search_batch`` beside requests without explain:
    each explained answer as alone, the others without entries."""
    index = corpus["port_built"].index
    specs = [s for n, s in CASES.items() if n not in RAISING]
    plain = _req(_or(_leaf("guter"), _leaf("text")))
    batch = vt.search_batch([vt.Request.from_dict(s) for s in specs] + [vt.Request.from_dict(plain)], index)
    for spec, got in zip(specs, batch):
        alone = vt.search(vt.Request.from_dict(spec), index)
        assert tfe._key(got) == tfe._key(alone) and _explain_text(got) == _explain_text(alone), spec
    assert batch[-1].explain == {} and batch[-1].data


def test_explain_counts_its_fallback_reason(corpus):
    """An explained request counts as the executor's fallback, its reason
    the admission row's key; a plain one as its tree route."""
    index = corpus["port_built"].index
    port_stats.reset()
    vt.search(vt.Request.from_dict(OWN["leaf_option_only"]), index)
    vt.search(vt.Request.from_dict(_req(_leaf("urge", ENG))), index)
    vt.search(vt.Request.from_dict(_req(_leaf("urge", ENG))), index, dense_only=True)
    snap = port_stats.snapshot()
    assert snap["fallback_reasons"] == {"explain": 1, "dense_only": 1}
    assert snap["paths"]["per_request_fallback"] == 2 and snap["paths"]["batched_single_term"] == 1


# ---------------------------------------------------------------- explain_plan

PLAN_CASES = {
    **{f"executor_{n}": s for n, s in tex.CASES.items() if n not in ("phrase_two_fields",)},
    **{f"features_{n}": s for n, s in tfe.CASES.items()},
    **OWN,
    "generator_phrase": {"generator": {"search_term": "die erbin taschenbuch", "phrase_pairs": True}},
    "generator_fuzzy": {"generator": {"search_term": "majestät~1 treffer", "facets": ["tags[]"]}},
    "plain_single": _req(_leaf("guter")),
    "plain_or": _req(_or(_leaf("guter"), _leaf("text"))),
    "plain_fuzzy": _req(_leaf("guter", levenshtein_distance=1)),
}


def _plan_requests(pair, spec):
    if "generator" in spec:
        params = spec["generator"]
        return (REF_SEARCH_QUERY(pair.pers, ref_generator.SearchQueryGeneratorParameters.from_dict(params)),
                vt.search_query(pair.index, vt.SearchQueryGeneratorParameters.from_dict(params)))
    return Request.from_dict(spec), vt.Request.from_dict(spec)


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_explain_plan_equals_reference(corpus, name):
    pair = corpus["ref_disk"]
    ref_req, port_req = _plan_requests(pair, PLAN_CASES[name])
    want = _outcome(lambda: ex_mod.explain_plan(ref_req, pair.pers))
    got = _outcome(lambda: vt.explain_plan(port_req, pair.index))
    if isinstance(want, _Raised) or isinstance(got, _Raised):
        assert got == want
        return
    assert _plan_lines(got) == _plan_lines(want)
    path = [line for line in got.split("\n") if line.startswith("  path ")]
    assert len(path) == 1 and path[0].startswith('  path [label="execution path: ')


def test_explain_plan_names_the_ports_route(corpus):
    """The path node names the route ``search`` takes and its kernels."""
    index = corpus["ref_disk"].index

    def path(spec):
        text = vt.explain_plan(vt.Request.from_dict(spec), index)
        return next(line for line in text.split("\n") if line.startswith("  path "))

    assert "flat tree (plain: " in path(PLAN_CASES["plain_single"])
    assert "kernels (plain versions on cpu): none" in path(PLAN_CASES["plain_or"])
    fuzzy = path(PLAN_CASES["plain_fuzzy"])
    assert "flat tree (plain: " in fuzzy and "B2 fused select" in fuzzy
    assert "deep tree (plain: " in path(_req(_or(_and(_leaf("guter"), _leaf("treffer")), _leaf("text"))))
    assert "flat tree (generic: " in path(OWN["batched_extras"] | {"explain": False})
    explained = path(OWN["batched_extras"])
    assert "dense executor (explain: " in explained and "B7 dense resolve" in explained
    assert "B1 banded sweep" in path(_req(_or(_leaf("guter", levenshtein_distance=1),
                                              _leaf("treffer", levenshtein_distance=1))))
    assert "B3 full-width sweep" in path(OWN["fuzzy_prefix"])
    assert "B8 DFA walk" in path(_req(_leaf(".*eich", is_regex=True)))
    assert "dense executor (tree_shape: " in path(tex.CASES["deep_four_levels"])
    assert "dense executor (leaf_shape: " in path(tex.CASES["multi_term"])
    before = dict(index.path_counts)
    vt.explain_plan(vt.Request.from_dict(OWN["deep_tree"]), index)
    assert dict(index.path_counts) == before  # no request was answered
