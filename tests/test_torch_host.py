"""The port's copies of the host layers against the JAX package's originals.

* The index builder: the same ndjson through ``veloci_tpu``'s build and
  ``Persistence.save`` and through the port's writes the same index
  directory (every ``.npy`` and ``docs.bin`` byte-equal, ``metaData.json``
  equal as JSON), on the native indexer and on the pure-Python pipeline.
* The request model and the query generator: ``Request.from_dict`` and
  ``search_query`` build equal request trees.
* The bundled stopword lists are equal.

Tolerance: exact, everywhere. Inputs are made from a seed with numpy.

The reference compresses ``docs.bin`` with its native LZ codec when its
library loads and with zlib otherwise. Its loader builds the library into
one temporary file name that every process shares and remembers a failed
attempt for the life of the process, so a process that loses a race of
several cold builds writes zlib blocks while the port, which has its
library, writes LZ blocks. The builder test therefore loads the
reference's library again once the build that won has put it in place."""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest

from veloci_tpu import Persistence as RefPersistence
from veloci_tpu import native as ref_native
from veloci_tpu import Request as RefRequest
from veloci_tpu.create import create_indices_from_str as ref_create
from veloci_tpu.query.generator import SearchQueryGeneratorParameters as RefParams
from veloci_tpu.query.generator import search_query as ref_search_query
from veloci_tpu.search import stopwords as ref_stopwords
from veloci_tpu_torch import (
    Persistence,
    Request,
    SearchQueryGeneratorParameters,
    TorchIndex,
    create_indices_from_str,
    search_query,
)
from veloci_tpu_torch import native as port_native
from veloci_tpu_torch.search import stopwords
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

VOCAB = ["hello", "help", "hells", "world", "Wörld", "x" * 40, "日本語", "a-b", "the", "Haus",
         "and", "der", "z" * 70]


def _corpus(kind: str) -> str:
    rng = np.random.default_rng(len(kind))
    lines = []
    for i in range(300):
        words = " ".join(rng.choice(VOCAB, size=int(rng.integers(1, 7))))
        if kind == "flat":
            doc = {"title": words, "nr": str(i)}
        elif kind == "nested":
            doc = {"title": words, "meanings": {"ger": list(rng.choice(VOCAB, 2)),
                                                "eng": [words[:12], None]},
                   "pop": int(rng.integers(1, 1000)), "flag": bool(i % 2), "score": i / 7}
        else:  # long texts past the stored-text limit, empty and odd values
            doc = {"title": words * int(rng.integers(1, 12)), "cat": f"c{i % 5}",
                   "empty": "", "list": [] if i % 3 else [words]}
        lines.append(json.dumps(doc, ensure_ascii=False))
    return "\n".join(lines)


CONFIGS = {
    "flat": "{}",
    "nested": '{"pop": {"boost": {"boost_type": "f32"}}, "meanings.ger[]": {"facet": true}}',
    "long": '["*GLOBAL*"]\nfeatures = ["All"]\n["cat"]\nfacet = true\n'
            '["title".fulltext]\ntokenize = true\ndo_not_store_text_longer_than = 32\n',
}


@pytest.fixture(scope="module")
def reference_library():
    """The reference's native library, loaded again in this process when its
    first attempt lost a race of concurrent cold builds: wait (at most 10 s)
    for the winner's atomic rename to put the library in place, forget the
    failed attempt, and load (which builds the library if it is still
    missing)."""
    if not ref_native.native_available() and port_native.native_available():
        so_path = ref_native._so_path()
        deadline = time.monotonic() + 10.0
        while not so_path.exists() and time.monotonic() < deadline:
            time.sleep(0.1)
        ref_native._LIB, ref_native._LIB_TRIED = None, False
        ref_native.native_available()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_builder_writes_the_reference_index(tmp_path, kind, native, reference_library):
    assert ref_native.lz_available() == port_native.lz_available(), (
        "the reference and the port disagree on the native LZ codec, so their docs.bin "
        "blocks differ (zlib, codec byte 0, against LZ, codec byte 1): the reference's "
        "native library did not load in this process"
    )
    data, config = _corpus(kind), CONFIGS[kind]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefPersistence.from_built(ref_create(data, config, use_native=native)).save(str(ref_dir))
    Persistence.from_built(create_indices_from_str(data, config, use_native=native)).save(str(port_dir))
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    assert "docs.bin" in names and any(n.endswith("%23terms.npy") for n in names)
    for name in names:
        if name == "metaData.json":
            assert json.loads((ref_dir / name).read_text()) == json.loads((port_dir / name).read_text())
        else:
            assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    # and the port reads back what the reference wrote
    back = Persistence.load(ref_dir)
    assert back.num_docs == 300 and back.get_all_fields() == Persistence.load(port_dir).get_all_fields()


def _canon(obj):
    """A request tree as nested tuples, comparable across the two packages."""
    if hasattr(obj, "kind") and hasattr(obj, "queries") and hasattr(obj, "part"):
        return ("node", obj.kind, [_canon(q) for q in obj.queries], _canon(obj.part), obj.options)
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                tuple((f.name, _canon(getattr(obj, f.name))) for f in dataclasses.fields(obj)))
    if isinstance(obj, (list, tuple)):
        return [_canon(o) for o in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    return obj


LEAF = {"search": {"terms": ["hello"], "path": "title", "levenshtein_distance": 1}}
REQUESTS = {
    "leaf": {"search_req": LEAF, "top": 3, "skip": 1},
    "bare_leaf": LEAF,
    "or_and": {"search_req": {"or": {"queries": [LEAF, {"and": {"queries": [
        LEAF, {"search": {"terms": ["wor"], "path": "title", "starts_with": True, "boost": 2.0,
                          "ignore_case": False, "top": 4, "skip": 2}}],
        "options": {"top": 3}}}]}}},
    "features": {"search_req": LEAF, "filter": LEAF, "facets": [{"field": "nr", "top": 4}],
                 "boost": [{"path": "pop", "boost_fun": "Log10", "param": 1.5}],
                 "phrase_boosts": [{"search1": LEAF, "search2": LEAF}],
                 "boost_term": [LEAF["search"]], "select": ["title"], "why_found": True,
                 "text_locality": True, "explain": True},
    "leaf_extras": {"search_req": {"search": {
        "terms": ["a", "b"], "path": "title", "is_regex": True, "snippet": True,
        "snippet_info": {"num_words_around_snippet": 2, "max_snippets": 3},
        "token_value": {"path": "title", "boost_fun": "Multiply"}, "options": {"explain": True}}}},
    "suggest": {"suggest": [LEAF["search"]], "top": 5},
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_request_from_dict(name):
    assert _canon(Request.from_dict(REQUESTS[name])) == _canon(RefRequest.from_dict(REQUESTS[name]))


QUERIES = {
    "one_word": ("hello", {}),
    "two_words_or": ("hello world", {}),
    "and": ("hello AND world", {}),
    "or_keyword": ("hello OR world AND help", {}),
    "wildcard": ("hel*", {}),
    "wildcard_and": ("wor* AND hello", {}),
    "inner_wildcard": ("h*lo", {}),
    "fuzzy_tilde": ("helo~2 AND wrld~1", {}),
    "quoted_phrase": ('"hello world" help', {}),
    "attributed_group": ("title:(hello world) AND help", {}),
    "attributed_leaf": ("title:hello", {}),
    "leading_keyword": ("AND hello", {}),
    "stopwords_en": ("the hello AND and world", {"stopword_lists": ["en"]}),
    "stopwords_de": ("der Haus", {"stopword_lists": ["de"]}),
    "stopwords_set": ("hello world", {"stopwords": {"world"}}),
    "params": ("hello wor*", {"top": 7, "skip": 2, "ignore_case": False, "levenshtein": 1,
                              "boost_fields": {"title": 2.0}, "facets": ["nr"],
                              "phrase_pairs": True, "why_found": True, "select": "title,nr"}),
    "auto_limit": ("hello worlds", {"levenshtein_auto_limit": 2}),
    "fields": ("hello", {"fields": ["title"]}),
    "filter_and_boost_terms": ("hello", {"filter": "nr:3", "boost_terms": {"title:help": 2.0}}),
}


@pytest.fixture(scope="module")
def indexes():
    data = _corpus("flat")
    ref = RefPersistence.from_built(ref_create(data, "{}"))
    pers = Persistence.from_built(create_indices_from_str(data, "{}"))
    return ref, pers, TorchIndex.from_persistence(pers, "cpu")


@pytest.mark.parametrize("name", list(QUERIES))
def test_search_query(indexes, name):
    ref, pers, index = indexes
    text, kw = QUERIES[name]
    want = _canon(ref_search_query(ref, RefParams(search_term=text, **kw)))
    assert _canon(search_query(pers, SearchQueryGeneratorParameters(search_term=text, **kw))) == want
    assert _canon(search_query(index, SearchQueryGeneratorParameters(search_term=text, **kw))) == want


@pytest.mark.parametrize("language", ["en", "de"])
def test_stopword_lists(language):
    assert stopwords.get_stopwords(language) == ref_stopwords.get_stopwords(language)
    assert len(stopwords.get_stopwords(language)) > 10
    assert Path(stopwords.__file__).parent.parent.name == "veloci_tpu_torch"
