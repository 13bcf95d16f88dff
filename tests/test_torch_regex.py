"""Regex leaves in the port (``veloci_tpu_torch``) against the JAX package.

* The port's copy of ``compile_dfa`` against the reference's, on every
  pattern of ``tests/test_regex_dfa.py`` and on its unsupported ones.
* The DFA walk's plain version (the CPU form of kernel B8) over the port's
  length-sorted sweep rows, mapped through ``sweep_ids``, against the
  reference's ``regex_match_device`` (JAX on the CPU) over its own matrix,
  mapped through its ``sweep_ids``; and over the long terms' int32 codes
  against a walk of the DFA in Python.
* A hypothesis test over patterns drawn from the DFA parser's grammar and
  dictionaries with non-ASCII, long and empty terms: the prefilter's
  candidates hold every ``re`` match, and the leaf's answer is the ``re``
  scan.
* ``search`` with documents against the reference's ``search`` on the
  request cases of ``tests/test_regex_dfa.py`` and the cases of
  ``tests/test_code_search.py``, the reference held to its host ``re`` scan
  (``VELOCI_REGEX_DEVICE=0``) and to its device branch of the executor
  (``SMALL_DOCS`` 0), as ``tests/test_torch_executor.py`` does.
* The reference's prefilter faults the port does not copy, pinned: term ids
  taken from sweep rows, ASCII-only shorthands and case folds, and the DFA
  compiled from a pattern ``re`` refused.
* Regex leaves in a filter and in a phrase boost, through ``search_batch``.

Tolerance: exact everywhere: DFA tables, match sets, ids, order,
``num_hits``, f32 score bits and documents.
"""

import importlib
import json
import re

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import torch

import test_code_search as tcs
import test_regex_dfa as trd
from veloci_tpu import Persistence, Request, search, search_to_result_with_doc
from veloci_tpu.ops import regex_dfa as ref_regex
from veloci_tpu.query.generator import SearchQueryGeneratorParameters, search_query
from veloci_tpu.query.parser import Options
import veloci_tpu_torch as vt
from veloci_tpu_torch.indices import TermDictionary
from veloci_tpu_torch.ops import regex_dfa
from veloci_tpu_torch.persistence import LONG_WIDTH
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

fs = importlib.import_module("veloci_tpu_torch.search.field_search")
ex_mod = importlib.import_module("veloci_tpu.search.executor")
batch_mod = importlib.import_module("veloci_tpu.search.batch")

UNSUPPORTED = ["a{2,3}", r"\bword", "(?=x)", "(?P<g>a)", "a$"]


def _same_dfa(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (np.array_equal(a.boundaries, b.boundaries) and a.boundaries.dtype == b.boundaries.dtype
            and np.array_equal(a.trans, b.trans) and np.array_equal(a.accept, b.accept)
            and a.dead == b.dead)


@pytest.mark.parametrize("ignore_case", [True, False])
@pytest.mark.parametrize("pattern", trd.PATTERNS + UNSUPPORTED)
def test_compile_dfa_equals_reference(pattern, ignore_case):
    got = regex_dfa.compile_dfa(pattern, ignore_case=ignore_case)
    want = ref_regex.compile_dfa(pattern, ignore_case=ignore_case)
    assert _same_dfa(got, want), pattern
    assert (got is None) == (pattern in UNSUPPORTED)


def _dictionary_index(terms, field="f"):
    """A CPU index of one field whose dictionary is ``terms`` (no postings)."""
    d = TermDictionary(sorted(set(terms)))
    index = vt.TorchIndex.from_reference_arrays(
        num_docs=0, all_fields=[field], term_bytes={field: d.to_arrays()["term_bytes"]},
        fields={field: d.char_matrix_compact()}, offsets=np.zeros(2, np.int64),
        anchors=np.zeros(0, np.int32), scores=np.zeros(0, np.uint16), key_base={}, device="cpu",
    )
    return index, index.get_dictionary(field).terms  # a lone empty term does not survive the bytes


# test_regex_dfa's terms, with long terms, non-ASCII ones and one that
# sorts first and is dropped from the compact matrix (so rows != term ids);
# two past 254 chars: the host distance caps at 255, but not on its
# startswith branch
WALK_TERMS = trd.TERMS + ["a" * 40 + "b", "Tree" + "x" * 30, "café", "日本", "hello_" * 9, "b" * 300,
                          "x1z" + "y" * 300]


@pytest.fixture(scope="module")
def walk_index():
    return _dictionary_index(WALK_TERMS)


@pytest.fixture(scope="module")
def reference_field():
    """The reference's device field over the same dictionary."""
    import veloci_tpu.persistence as ref_pers
    from veloci_tpu.indices import TermDictionary as RefDictionary

    p = ref_pers.Persistence()
    p.dictionaries["f"] = RefDictionary(sorted(set(WALK_TERMS)))
    return p.device_field("f")


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("pattern", trd.PATTERNS)
def test_walk_equals_reference_device(walk_index, reference_field, pattern, prefix):
    index, terms = walk_index
    dfa = regex_dfa.compile_dfa(pattern, ignore_case=True)
    sweep = index.fields["f"]
    got = regex_dfa.regex_match(sweep.chars_t, sweep.lengths, dfa, prefix)
    assert got.dtype == torch.bool and got.device.type == "cpu"
    got_ids = set(sweep.sweep_ids[got].tolist())
    dev = reference_field
    want = np.asarray(ref_regex.regex_match_device(dev.chars, dev.lengths, ref_regex.compile_dfa(
        pattern, ignore_case=True), prefix=prefix))
    want_ids = set(np.asarray(dev.sweep_ids)[np.flatnonzero(want)].tolist()) - {-1}
    assert got_ids == want_ids, pattern


def _walk(dfa, text, prefix):
    """The DFA walked in Python over one lowercased string."""
    if not text:
        return False
    state = 0
    if prefix and dfa.accept[0]:
        return True
    for ch in text:
        c = ord(ch) if ord(ch) <= 0xFFFF else 0xFFFD
        state = int(dfa.trans[int(np.searchsorted(dfa.boundaries, c, side="right")), state])
        if prefix and dfa.accept[state]:
            return True
    return bool(dfa.accept[state])


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("pattern", ["a*b", "(a|t).*", r"\w+", "hello_.*", "[^x]+", "..*x"])
def test_walk_over_long_codes(walk_index, pattern, prefix):
    """The int32 row-major codes of the long terms, read through a
    transposed view, walk as the Python walk does (every row within
    ``LONG_WIDTH``)."""
    index, terms = walk_index
    dfa = regex_dfa.compile_dfa(pattern, ignore_case=True)
    long = index.long_terms["f"]
    assert len(long.ids) >= 3 and not long.codes.T.is_contiguous()
    got = regex_dfa.regex_match(long.codes.T, long.lengths, dfa, prefix).numpy()
    want = [_walk(dfa, terms[t].lower()[:LONG_WIDTH], prefix) for t in long.ids]
    assert got.tolist() == want


# ---------------------------------------------------------------- hypothesis

_ATOMS = ["a", "b", "k", "s", "i", "K", "1", "_", "-", r"\.", ".", "[abk]", "[^a-c]", "[a-z]", "[0-9]",
          r"\d", r"\w", r"\s", r"\D", r"\W", r"\S", "[_s]", r"[\w-]", r"[\s.]", "[Z-a]"]


def _patterns():
    atom = st.sampled_from(_ATOMS)

    def extend(inner):
        rep = st.tuples(inner, st.sampled_from(["*", "+", "?"])).map("".join)
        cat = st.lists(inner, min_size=2, max_size=3).map("".join)
        alt = st.lists(inner, min_size=2, max_size=3).map(lambda xs: "(" + "|".join(xs) + ")")
        grp = inner.map(lambda x: "(?:" + x + ")")
        return rep | cat | alt | grp

    return st.recursive(atom, extend, max_leaves=6)


_CHARS = ["a", "b", "k", "s", "i", "A", "K", "S", "1", "_", "-", ".", " ", "ſ", "ı",
          "İ", "K", "é", "É", "٣", " ", "\x1c", "日", "\U0001F600"]


def _term():
    short = st.lists(st.sampled_from(_CHARS), min_size=0, max_size=6).map("".join)
    long = st.tuples(st.sampled_from(["a", "k", "é"]), st.integers(30, 300), short).map(
        lambda t: t[0] * t[1] + t[2])
    return short | long


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(pattern=_patterns(), terms=st.lists(_term(), min_size=1, max_size=25),
       prefix=st.booleans(), ignore_case=st.booleans())
def test_candidates_hold_every_re_match(pattern, terms, prefix, ignore_case):
    index, terms = _dictionary_index(terms + [""])
    flags = re.IGNORECASE if ignore_case else 0
    try:  # the grammar can stack quantifiers ("a**"), which re refuses: then
        rx = re.compile(pattern, flags)  # the leaf searches the escaped term
    except re.error:
        rx = re.compile(re.escape(pattern), flags)
    fn = rx.match if prefix else rx.fullmatch
    want = [i for i, t in enumerate(terms) if fn(t)]
    reads, shorthand = fs._dfa_escapes(rx.pattern)
    dfa = regex_dfa.compile_dfa(rx.pattern, ignore_case=True)
    if reads and dfa is not None:
        cand = set(fs._regex_candidates(index, "f", dfa, shorthand, prefix).tolist())
        assert set(want) <= cand, (pattern, [terms[i] for i in set(want) - cand])
    part = vt.Request.from_dict({"search_req": {"search": {
        "terms": [pattern], "path": "f", "is_regex": True, "starts_with": prefix,
        "ignore_case": ignore_case}}}).search_req.part
    assert fs._match_regex(index, part).tolist() == want


@pytest.mark.parametrize("pattern", [".*e.*", "h.*", "a" * 35 + ".*", "\U0001F600.*", ".*é",
                                     "hello_hello_.*", "x1z"])
def test_regex_scores_equal_host_distances(walk_index, pattern):
    """The batched distances (B3's plain version over the sweep rows, the
    vectorised host distance for the rest) equal ``levenshtein_distance_host``
    with the reference's ``startswith`` branch, term by term."""
    from veloci_tpu.ops.levenshtein import levenshtein_distance_host

    index, terms = walk_index
    matched = np.arange(len(terms), dtype=np.int64)
    lower = pattern.lower()
    dist, starts = fs._regex_distances(index, "f", matched, lower)
    for t, d, s in zip(matched, dist, starts):
        lo = terms[t].lower()
        assert s == lo.startswith(lower), lo
        assert d == (len(lo) - len(lower) if s else levenshtein_distance_host(lower, lo)), (lo, lower)


# ---------------------------------------------------------------- search parity

def _result_key(res):
    return (res.num_hits, [(h.id, np.float32(h.score).view(np.int32).item()) for h in res.data])


def _docs_key(res):
    d = res.to_dict()
    d.pop("execution_time_ns")
    return d


def _ref_answer(mp, pers, req, select=None):
    mp.setenv("VELOCI_REGEX_DEVICE", "0")
    mp.setattr(ex_mod, "SMALL_DOCS", 0)
    mp.setattr(batch_mod, "SMALL_DOCS", 0)
    pers._field_search_cache = {}
    res = search(req, pers)
    return res, search_to_result_with_doc(pers, res, select)


REGEX_DFA_LINES = ['{"code": "fn get_%d(x) { return x + %d }"}' % (i, i) for i in range(50)] + [
    '{"code": "struct FooBar { field: u32 }"}']
REGEX_DFA_CONFIG = '{"code": {"fulltext": {"tokenize_on_chars": [" ", "(", ")", "{", "}", ":", "+"]}}}'
CASE_LINES = ['{"t": "FooBar"}', '{"t": "foobar"}', '{"t": "FOOBAR"}']


def _leaf(term, path, **kw):
    return {"search": dict({"terms": [term], "path": path, "is_regex": True}, **kw)}


# name -> (corpus, request dict or query-generator parameters)
SEARCH_CASES = {
    "regex_dfa_get_n": ("regex_dfa", {"search_req": _leaf("get_[0-9]+", "code"), "top": 100}),
    "regex_dfa_case_sensitive": ("case", {"search_req": _leaf("Foo[A-Z][a-z]+", "t", ignore_case=False)}),
    "code_request_api": ("code", {"search_req": _leaf(".*myfun.*type1.*", "line", ignore_case=True)}),
    "code_request_api_case_sensitive": (
        "code", {"search_req": _leaf(".*myfun.*type1.*", "line", ignore_case=False)}),
    "code_generator": ("code", dict(search_term="*myfun*Type1*")),
    "code_ignore_case": ("code", dict(search_term="*myfun*type1*")),
    "code_case_sensitive": ("code", dict(search_term="*myfun*type1*", ignore_case=False)),
    "code_no_fuzzy": ("code", dict(search_term="*myfun*type2*")),
    "code_token": ("code", dict(search_term="myfun")),
    "code_disable_parser": ("code", dict(search_term="*myfun(param1: Type1)*", parser_options=Options(
        no_parentheses=True, no_attributes=True, no_levensthein=True))),
    "code_phrase_pattern": ("code", dict(search_term='"*myfun(param1: Type1)*"')),
    # prefilter work on the code corpus's dictionaries: the DFA compiles
    "code_short_regex": ("code", dict(search_term="*fun*")),
    "code_starts_with_regex": ("code", {"search_req": _leaf("my.un", "line", starts_with=True)}),
}
CORPORA = {
    "regex_dfa": ("\n".join(REGEX_DFA_LINES), REGEX_DFA_CONFIG),
    "case": ("\n".join(CASE_LINES), "{}"),
    "code": ("\n".join(json.dumps(d, ensure_ascii=False) for d in tcs.DATA), tcs.CONFIG),
}


@pytest.fixture(scope="module")
def corpora():
    out = {}
    for name, (data, config) in CORPORA.items():
        pers = Persistence.create_from_str(data, config)
        index = vt.TorchIndex.from_persistence(vt.Persistence.from_built(
            vt.create_indices_from_str(data, config)), "cpu")
        out[name] = (pers, index)
    return out


def _requests(pers, index, spec):
    if "search_req" in spec:
        return Request.from_dict(spec), vt.Request.from_dict(spec)
    ref_spec = dict(spec)
    port_spec = dict(spec)
    if "parser_options" in spec:
        port_spec["parser_options"] = importlib.import_module("veloci_tpu_torch.query.parser").Options(
            no_parentheses=True, no_attributes=True, no_levensthein=True)
    return (search_query(pers, SearchQueryGeneratorParameters(**ref_spec)),
            vt.search_query(index, vt.SearchQueryGeneratorParameters(**port_spec)))


@pytest.mark.parametrize("select", [None, "fields"])
@pytest.mark.parametrize("name", list(SEARCH_CASES))
def test_search_with_documents_equals_reference(corpora, monkeypatch, name, select):
    corpus, spec = SEARCH_CASES[name]
    pers, index = corpora[corpus]
    ref_req, port_req = _requests(pers, index, spec)
    fields = None if select is None else sorted(pers.get_all_fields())[:2]
    ref_res, ref_docs = _ref_answer(monkeypatch, pers, ref_req, fields)
    got = vt.search(port_req, index)
    assert _result_key(got) == _result_key(ref_res)
    assert _docs_key(vt.search_to_result_with_doc(index, got, fields)) == _docs_key(ref_docs)


def test_search_cases_exercise_what_they_name(corpora, monkeypatch):
    """The cases find what the reference's suites say, and the port's
    prefilter ran on the leaves whose DFA compiles."""
    expect = {"regex_dfa_get_n": 50, "regex_dfa_case_sensitive": 1, "code_request_api": 1,
              "code_request_api_case_sensitive": 0, "code_generator": 1, "code_ignore_case": 1,
              "code_case_sensitive": 0, "code_no_fuzzy": 0, "code_token": 1, "code_disable_parser": 1,
              "code_phrase_pattern": 1, "code_short_regex": 1, "code_starts_with_regex": 1}
    for name, (corpus, spec) in SEARCH_CASES.items():
        pers, index = corpora[corpus]
        before = index.path_counts["regex_dfa"]
        res = vt.search(_requests(pers, index, spec)[1], index)
        assert len(res.data) == expect[name], name
        if name in ("regex_dfa_get_n", "code_short_regex", "code_starts_with_regex"):
            assert index.path_counts["regex_dfa"] > before, name


# ---------------------------------------------------------------- reference faults, pinned

def test_sweep_rows_are_not_term_ids(monkeypatch):
    """The reference's device prefilter takes sweep-row numbers for term
    ids; after a term the compact matrix drops (here one of 41 chars that
    sorts first) every id is off by one, and its ``re`` check loses the
    match whose row it misreads. The port maps rows through ``sweep_ids``."""
    lines = ['{"title": "w%04d"}' % i for i in range(600)] + ['{"title": "%s"}' % ("a" * 41)]
    data = "\n".join(lines)
    pers = Persistence.create_from_str(data, "{}")
    index = vt.TorchIndex.from_persistence(vt.Persistence.from_built(vt.create_indices_from_str(data, "{}")),
                                           "cpu")
    spec = {"search_req": _leaf("w05.*", "title"), "top": 200}
    monkeypatch.setattr(ex_mod, "SMALL_DOCS", 0)
    monkeypatch.setattr(batch_mod, "SMALL_DOCS", 0)
    monkeypatch.setenv("VELOCI_REGEX_DEVICE", "1")
    device = search(Request.from_dict(spec), pers)
    host, _docs = _ref_answer(monkeypatch, pers, Request.from_dict(spec))
    got = vt.search(vt.Request.from_dict(spec), index)
    assert (device.num_hits, host.num_hits, got.num_hits) == (99, 100, 100)
    assert _result_key(got) == _result_key(host)
    assert index.path_counts["regex_dfa"] == 1 and not index.path_counts["regex_host_scan"]


# (pattern, options, terms that must match, terms that must not): the
# reference's folded ASCII DFA misses each "must" on a dictionary of 512
# terms or more (its device threshold)
FAULT_CASES = {
    "long_s_ignore_case": ("s", {}, ["\u017f", "S"], ["x"]),
    "dotless_i_ignore_case": ("i", {}, ["\u0131", "\u0130", "I"], ["j"]),
    "kelvin_ignore_case": ("k+", {}, ["\u212a\u212a", "k\u212aK"], ["x"]),
    "word_shorthand": (r"\w+", {}, ["caf\u00e9", "\u65e5\u672c", "ab_1"], ["a b"]),
    "digit_shorthand": (r"x\d", {}, ["x\u0663", "x1"], ["xa"]),
    "space_shorthand": (r"a\sb", {}, ["a\x1cb", "a b", "a\u00a0b"], ["ab"]),
    "dotted_i_case_sensitive": (".", {"ignore_case": False}, ["\u0130", "\u212a", "x"], ["xx"]),
    "class_negation_kelvin": ("[^kK]", {"ignore_case": False}, ["\u212a", "x"], ["k", "K"]),
    "re_refuses_range": ("[z-a]", {}, ["[z-a]"], ["z", "a"]),
    "escape_code_point": (r"caf\u00e9", {}, ["caf\u00e9"], ["cafu00e9"]),
    "escape_in_class": (r"[\W]", {}, ["!", "-"], ["W", "a"]),
}


@pytest.mark.parametrize("name", list(FAULT_CASES))
def test_prefilter_keeps_re_semantics(name):
    pattern, options, must, must_not = FAULT_CASES[name]
    filler = [f"w{i:04d}" for i in range(520)]
    index, terms = _dictionary_index(filler + must + must_not)
    part = vt.Request.from_dict({"search_req": {"search": dict(
        {"terms": [pattern], "path": "f", "is_regex": True}, **options)}}).search_req.part
    got = {terms[i] for i in fs._match_regex(index, part)}
    assert set(must) <= got and not set(must_not) & got, got
    flags = 0 if options.get("ignore_case") is False else re.IGNORECASE
    try:
        rx = re.compile(pattern, flags)
    except re.error:
        rx = re.compile(re.escape(pattern), flags)
    assert got == {t for t in terms if rx.fullmatch(t)}


# ---------------------------------------------------------------- filter and phrase boosts

@pytest.fixture(scope="module")
def regex_dfa_corpus(corpora):
    return corpora["regex_dfa"]


@pytest.mark.parametrize("where", ["filter", "phrase_boosts"])
def test_regex_leaf_in_extras_through_search_batch(regex_dfa_corpus, monkeypatch, where):
    pers, index = regex_dfa_corpus
    tree = {"search": {"terms": ["return"], "path": "code"}}
    if where == "filter":
        spec = {"search_req": tree, "filter": _leaf("get_[1-3][0-9]?", "code"), "top": 100}
    else:
        spec = {"search_req": tree, "top": 100, "phrase_boosts": [{
            "search1": _leaf("get_1.*", "code")["search"],
            "search2": {"terms": ["x"], "path": "code"}}]}
    ref_res, _docs = _ref_answer(monkeypatch, pers, Request.from_dict(spec))
    before = index.path_counts["executor"]
    ok = vt.Request.from_dict({"search_req": tree})
    got = vt.search_batch([ok, vt.Request.from_dict(spec)], index)[1]
    assert _result_key(got) == _result_key(ref_res)
    assert index.path_counts["executor"] == before + 1
    plain = search(Request.from_dict({"search_req": tree, "top": 100}), pers)
    assert _result_key(ref_res) != _result_key(plain)  # the regex leaf changed the answer
