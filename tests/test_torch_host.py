"""The port's copies of the host layers against the JAX package's originals.

* The index builder: the same ndjson through ``veloci_tpu``'s build and
  ``Persistence.save`` and through the port's writes the same index
  directory (every ``.npy`` and ``docs.bin`` byte-equal, ``metaData.json``
  equal as JSON), on the native indexer and on the pure-Python pipeline.
* The request model and the query generator: ``Request.from_dict`` and
  ``search_query`` build equal request trees.
* The bundled stopword lists are equal.
* The host functions the search does not call, which the port keeps for its
  users (the parser's ``parse`` and ``walk_terms``, the tokenizers, the
  field-path helpers, the store reads, the document store's native writer
  and the native sorts), give equal outputs on seeded inputs.

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
import shutil
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


# ---------------------------------------------------------------- host functions
QUERY_TEXTS = ["hello", "hello AND wor*", "title:(a b~1) OR c", '"quoted text" x~2', "a OR b AND c d",
               "f:(g:(h))", "AND x", "x y z w"]


@pytest.mark.parametrize("text", QUERY_TEXTS)
def test_parse_and_walk_terms(text):
    from veloci_tpu.query import parser as ref_parser
    from veloci_tpu_torch.query import parser

    got, want = parser.parse(text), ref_parser.parse(text)
    assert repr(got) == repr(want)
    got_terms, want_terms = [], []
    got.walk_terms(got_terms.append)
    want.walk_terms(want_terms.append)
    assert got_terms == want_terms and got_terms


def _texts(seed: int, n: int = 200):
    rng = np.random.default_rng(seed)
    pieces = VOCAB + [" ", "  ", "\n", ",", ".", "(", ")", "-", "…", "“", ":"]
    return ["".join(rng.choice(pieces, size=int(rng.integers(0, 9)))) for _ in range(n)]


def test_tokenizers():
    from veloci_tpu import tokenizer as ref_tok
    from veloci_tpu_torch import tokenizer

    texts = _texts(5)
    for seps in (None, " ,"):
        group, ref_group = tokenizer.GroupTokenizer(seps), ref_tok.GroupTokenizer(seps)
        for text in texts:
            assert group.pieces(text) == ref_group.pieces(text) == list(group.iter(text))
            assert group.token_list(text) == ref_group.token_list(text) == [t for t, _s in group.iter(text)]
            assert group.has_tokens(text) == ref_group.has_tokens(text)
    simple, ref_simple = tokenizer.SimpleTokenizer(), ref_tok.SimpleTokenizer()
    for text in texts:
        assert simple.tokens(text) == ref_simple.tokens(text)
        assert simple.has_tokens(text) == ref_simple.has_tokens(text)


@pytest.mark.parametrize("start, end", [
    ("meanings.ger[]", "meanings.eng[]"), ("title", "meanings.ger[]"), ("a.b.c[]", "a.d[]"),
    ("a.b.c[]", "a.b"), ("a", "a"), ("meanings.ger[].text", "meanings.eng[].text"),
])
def test_field_path_helpers(start, end):
    from veloci_tpu import utils as ref_utils
    from veloci_tpu_torch import utils

    assert utils.steps_between_field_paths(start, end) == ref_utils.steps_between_field_paths(start, end)
    for path in (start, end, start + ".textindex"):
        assert utils.extract_field_name(path) == ref_utils.extract_field_name(path)


def test_store_reads():
    data, config = _corpus("long"), CONFIGS["long"]
    ref = RefPersistence.from_built(ref_create(data, config))
    pers = Persistence.from_built(create_indices_from_str(data, config))
    dictionary, ref_dictionary = pers.get_dictionary("title"), ref.get_dictionary("title")
    for prefix in ("h", "He", "hell", "x", "日", "", "zzzz", "W"):
        for ignore_case in (True, False):
            assert dictionary.prefix_range(prefix, ignore_case) == ref_dictionary.prefix_range(prefix, ignore_case)
    path = "title.textindex.to_anchor_id_score"
    store, ref_store = pers.get_token_to_anchor(path), ref.get_token_to_anchor(path)
    for token in (-1, 0, 1, store.num_keys - 1, store.num_keys):
        for got, want in zip(store.get_postings(token), ref_store.get_postings(token)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    phrase_path = next(p for p in pers.phrase_indices)
    phrases, ref_phrases = pers.get_phrase_pair_to_anchor(phrase_path), ref.get_phrase_pair_to_anchor(phrase_path)
    keys = [(int(k) >> 32, int(k) & 0xFFFFFFFF) for k in phrases.keys[:20]] + [(0, 0), (1 << 20, 3)]
    for pair in keys:
        got, want = phrases.get_values(pair), ref_phrases.get_values(pair)
        assert (got is None and want is None) or np.array_equal(got, want)
    assert pers.heap_size_bytes() == ref.heap_size_bytes()
    for name in ("has_index", "tokenize_enabled", "is_anchor_identity_column"):
        for arg in (path, "title", "title.textindex", "cat.parent_to_value_id", "missing"):
            assert getattr(pers, name)(arg) == getattr(ref, name)(arg), (name, arg)
    assert pers.num_text_ids("title") == ref.num_text_ids("title")


def test_document_store_writers(reference_library):
    from veloci_tpu import doc_store as ref_doc_store
    from veloci_tpu_torch import doc_store

    data = _corpus("long")
    lines = [line for line in data.split("\n") if line.strip()]
    writer = doc_store.DocStoreWriter()
    for line in lines:
        writer.add_doc(line)
    ref_writer = ref_doc_store.DocStoreWriter()
    for line in lines:
        ref_writer.add_doc(line)
    blob = writer.finish()
    assert blob == ref_writer.finish()
    assert doc_store.build_doc_store_native(data) == ref_doc_store.build_doc_store_native(data) == (
        blob, len(lines), writer.bytes_indexed)
    assert list(doc_store.DocLoader(blob).iter_docs()) == list(ref_doc_store.DocLoader(blob).iter_docs()) == lines
    body = port_native.doc_store_body(data.encode("utf-8"), doc_store.FLUSH_THRESHOLD)
    ref_body = ref_native.doc_store_body(data.encode("utf-8"), doc_store.FLUSH_THRESHOLD)
    assert body[0] == ref_body[0] and np.array_equal(body[1], ref_body[1]) and body[2:] == ref_body[2:]


@pytest.mark.parametrize("n", [0, 1, 1000, 70_000])
def test_native_sorts(n, reference_library):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 40, size=n, dtype=np.uint64) >> rng.integers(0, 30, size=n, dtype=np.uint64)
    vals = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)
    got, want = keys.copy(), keys.copy()
    assert port_native.sort_u64(got) and ref_native.sort_u64(want)
    assert np.array_equal(got, want) and np.array_equal(got, np.sort(keys))
    for name in ("sort_kv_u64_u32", "lexsort_kv_u64_u32"):
        got_k, got_v, want_k, want_v = keys.copy(), vals.copy(), keys.copy(), vals.copy()
        assert getattr(port_native, name)(got_k, got_v) and getattr(ref_native, name)(want_k, want_v)
        assert np.array_equal(got_k, want_k) and np.array_equal(got_v, want_v), name
    assert not port_native.sort_u64(keys.astype(np.int64))


# ------------------------------------------------------------ host settings
# The settings the reference reads (its doc store, native loader and spill
# sorter), each set on both packages and held to the reference's behaviour.

def _docs(n: int = 3000):
    return [json.dumps({"t": f"doc {i} " + "pad " * (i % 37)}) for i in range(n)]


def test_docstore_codec_zlib_setting(monkeypatch, reference_library):
    from veloci_tpu import doc_store as ref_doc_store
    from veloci_tpu_torch import doc_store

    docs = _docs()
    blobs = {}
    for codec in ("zlib", "lz"):
        monkeypatch.setenv("VELOCI_DOCSTORE_CODEC", codec)
        writer, ref_writer = doc_store.DocStoreWriter(), ref_doc_store.DocStoreWriter()
        writer.add_docs(docs)
        ref_writer.add_docs(docs)
        blobs[codec] = writer.finish()
        assert blobs[codec] == ref_writer.finish(), codec
        data = "\n".join(docs)
        if codec == "zlib":  # no native pass under a forced zlib, in either package
            assert doc_store.build_doc_store_native(data) is None and ref_doc_store.build_doc_store_native(data) is None
        else:
            assert doc_store.build_doc_store_native(data)[0] == blobs["lz"]
    loader = doc_store.DocLoader(blobs["zlib"])
    first = int(loader._index[0, 1])
    assert blobs["zlib"][first] == 0 and blobs["lz"][first] == 1  # each block's codec byte
    for blob in blobs.values():
        assert list(doc_store.DocLoader(blob).iter_docs()) == docs


def _legacy_blob(docs, per_block: int = 100) -> bytes:
    """A ``VTDS`` blob as the first format wrote it: a block is its doc
    count + 1 (u32), then zlib of the u32 doc offsets and the documents; no
    codec byte, no raw size."""
    import zlib

    body, rows = b"", []
    for first in range(0, len(docs), per_block):
        raw = [d.encode("utf-8") for d in docs[first:first + per_block]]
        offsets = np.zeros(len(raw) + 1, dtype=np.uint32)
        np.cumsum([len(r) for r in raw], out=offsets[1:])
        block = len(offsets).to_bytes(4, "little") + zlib.compress(offsets.tobytes() + b"".join(raw), 1)
        rows.append((first, len(body), len(body) + len(block)))
        body += block
    tail = np.array(rows, dtype=np.uint64).tobytes()
    return body + tail + len(tail).to_bytes(8, "little") + len(docs).to_bytes(8, "little") + b"VTDS"


def test_docstore_reads_legacy_vtds_blobs():
    from veloci_tpu import doc_store as ref_doc_store
    from veloci_tpu_torch import doc_store

    docs = _docs(750) + [json.dumps({"t": "größe 日本語"}, ensure_ascii=False)]
    blob = _legacy_blob(docs)
    loader, ref_loader = doc_store.DocLoader(blob), ref_doc_store.DocLoader(blob)
    assert loader.num_docs == ref_loader.num_docs == len(docs)
    assert list(loader.iter_docs()) == list(ref_loader.iter_docs()) == docs
    assert loader.get_doc(750) == docs[750]


def test_docstore_cache_blocks_setting(monkeypatch):
    from veloci_tpu import doc_store as ref_doc_store
    from veloci_tpu_torch import doc_store

    docs = _docs()
    writer = doc_store.DocStoreWriter()
    writer.add_docs(docs)
    blob = writer.finish()
    for blocks in ("1", None):
        if blocks is None:
            monkeypatch.delenv("VELOCI_DOCSTORE_CACHE_BLOCKS", raising=False)
        else:
            monkeypatch.setenv("VELOCI_DOCSTORE_CACHE_BLOCKS", blocks)
        loader, ref_loader = doc_store.DocLoader(blob), ref_doc_store.DocLoader(blob)
        ids = [0, 2999, 1500, 0, 2999]
        assert len(np.unique(np.searchsorted(loader._first_ids, ids, side="right"))) == 3  # three blocks
        for i in ids:
            assert loader.get_doc(i) == ref_loader.get_doc(i) == docs[i]
        kept = 1 if blocks else 3
        assert len(loader._cache) == len(ref_loader._cache) == kept, blocks
        assert list(loader._cache) == list(ref_loader._cache)  # the same blocks, in LRU order


def test_no_native_setting_builds_through_python(tmp_path, monkeypatch):
    from veloci_tpu_torch import create_native

    monkeypatch.setenv("VELOCI_TPU_NO_NATIVE", "1")
    for module in (port_native, ref_native):
        monkeypatch.setattr(module, "_LIB", None)
        monkeypatch.setattr(module, "_LIB_TRIED", False)
    native_builds = []
    real_build = create_native.build_native
    monkeypatch.setattr(create_native, "build_native", lambda *a: native_builds.append(1) or real_build(*a))
    assert not port_native.native_available() and not ref_native.native_available()
    assert not port_native.lz_available() and port_native.doc_store_body(b'{"a": 1}', 16384) is None
    data, config = _corpus("nested"), CONFIGS["nested"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    RefPersistence.from_built(ref_create(data, config)).save(str(ref_dir))
    Persistence.from_built(create_indices_from_str(data, config)).save(str(port_dir))
    assert not native_builds
    names = sorted(p.name for p in ref_dir.iterdir())
    assert names == sorted(p.name for p in port_dir.iterdir())
    for name in names:
        if name == "metaData.json":
            assert json.loads((ref_dir / name).read_text()) == json.loads((port_dir / name).read_text())
        else:
            assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name
    docs = (port_dir / "docs.bin").read_bytes()
    assert docs[-4:] == b"VTD2" and docs[0] == 0  # zlib blocks: no LZ codec without the library


_SPILL_CHILD = r"""
import sys
from pathlib import Path
from veloci_tpu_torch import Persistence, create_indices_from_str, spill
assert spill.SPILL_PAIRS == 50, spill.SPILL_PAIRS
sorters = []
real = spill.SpillSorter.__init__
def counted(self, *a, **kw):
    sorters.append(1)
    real(self, *a, **kw)
spill.SpillSorter.__init__ = counted
Persistence.from_built(create_indices_from_str(Path(sys.argv[1]).read_text(), Path(sys.argv[2]).read_text())).save(sys.argv[3])
print("SPILLED", len(sorters))
"""


def test_spill_pairs_setting_builds_the_same_index(tmp_path):
    """``VELOCI_SPILL_PAIRS`` is read when ``spill`` is imported: a child
    process with 50 builds through the spill sorter and writes the index the
    reference writes with its default."""
    import os
    import subprocess
    import sys

    data, config = _corpus("nested"), CONFIGS["nested"]
    (tmp_path / "data.ndjson").write_text(data)
    (tmp_path / "config.toml").write_text(config)
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, VELOCI_SPILL_PAIRS="50", PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", _SPILL_CHILD, str(tmp_path / "data.ndjson"),
                           str(tmp_path / "config.toml"), str(tmp_path / "spilled")],
                          env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split("SPILLED")[1]) > 0
    RefPersistence.from_built(ref_create(data, config)).save(str(tmp_path / "ref"))
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "spilled").iterdir())
    for name in names:
        if name != "metaData.json":
            assert (tmp_path / "ref" / name).read_bytes() == (tmp_path / "spilled" / name).read_bytes(), name


def test_ingest_threads_setting(monkeypatch):
    """``VELOCI_INGEST_THREADS`` reaches the native indexer: 1 (the
    single-threaded walker) and 7 chunks build the same index."""
    calls = []
    lib = port_native._load()
    real = lib.vl_index_ndjson_mt

    def recorded(data, n, cb, nthreads):
        calls.append(nthreads)
        return real(data, n, cb, nthreads)

    monkeypatch.setattr(lib, "vl_index_ndjson_mt", recorded)
    data, config = "\n".join([_corpus("nested")] * 20), CONFIGS["nested"]
    built = {}
    for threads in ("1", "7", None):
        if threads is None:
            monkeypatch.delenv("VELOCI_INGEST_THREADS", raising=False)
        else:
            monkeypatch.setenv("VELOCI_INGEST_THREADS", threads)
        built[threads] = create_indices_from_str(data, config, use_native=True)
    assert calls == [1, 7, 0]
    for threads in ("7", None):
        for group in ("anchor_scores", "key_value_stores", "phrase_indices"):
            a, b = getattr(built["1"], group), getattr(built[threads], group)
            assert a.keys() == b.keys()
            for key in a:
                for attr in ("offsets", "anchors", "scores", "values", "keys"):
                    if hasattr(a[key], attr):
                        assert np.array_equal(getattr(a[key], attr), getattr(b[key], attr)), (group, key, attr)


def test_malloc_tune_setting(monkeypatch):
    """``VELOCI_MALLOC_TUNE=0`` makes no ``mallopt`` call, in either package;
    unset, each raises the mmap and trim thresholds."""
    import ctypes

    calls = []

    class Libc:
        def __init__(self, *_a, **_kw):
            pass

        def mallopt(self, *args):
            calls.append(args)

    monkeypatch.setattr(ctypes, "CDLL", Libc)
    for value, want in (("0", []), (None, [(-3, 1 << 30), (-1, 1 << 30)])):
        if value is None:
            monkeypatch.delenv("VELOCI_MALLOC_TUNE", raising=False)
        else:
            monkeypatch.setenv("VELOCI_MALLOC_TUNE", value)
        for module in (port_native, ref_native):
            calls.clear()
            module._tune_malloc()
            assert calls == want, (module.__name__, value)


def test_native_cache_setting(tmp_path, monkeypatch):
    """``VELOCI_NATIVE_CACHE`` names the build directory; unset, it is
    ``build/native/`` at the repository root. The library is loaded from
    the named directory: a copy of the built one, so nothing is rebuilt."""
    monkeypatch.delenv("VELOCI_NATIVE_CACHE", raising=False)
    assert port_native.native_available()
    default = port_native._so_path()
    assert default.parent == Path(port_native.__file__).resolve().parent.parent / "build" / "native"
    monkeypatch.setenv("VELOCI_NATIVE_CACHE", str(tmp_path / "cache"))
    moved = port_native._so_path()
    assert moved == tmp_path / "cache" / default.name
    moved.parent.mkdir()
    shutil.copyfile(default, moved)

    def no_build(so_path):
        raise AssertionError(f"rebuilt {so_path}")

    loaded = []
    real_cdll = port_native.ctypes.CDLL
    monkeypatch.setattr(port_native, "_build_lib", no_build)
    monkeypatch.setattr(port_native.ctypes, "CDLL", lambda path: loaded.append(path) or real_cdll(path))
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_LIB_TRIED", False)
    assert port_native.native_available() and loaded == [str(moved)]
