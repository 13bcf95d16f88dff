"""Documents back from a search in the port (``veloci_tpu_torch``) against
the JAX package.

* ``DocLoader`` reads blocks of both codecs: the native LZ codec's, as the
  port writes them, and zlib's, made here by the port's writer with its LZ
  codec switched off; and the reference's ``docs.bin`` of an index
  directory, whichever codec the reference wrote it with. Nothing here
  needs the reference's native library to have loaded: the reference reads
  its own store, the port reads both codecs with its own library. The
  fixtures that build the reference's indexes take
  ``tests/test_torch_host.py``'s ``reference_library`` first, which loads
  that library again where a race of cold builds left it unloaded
  (ROADMAP C1, C7), so the reference writes LZ blocks where it can.
* ``read_data`` and ``search_to_result_with_doc``, with and without
  ``select``, on ``tests/test_all.py``'s select and read cases, on an index
  the port built and on the reference's index directory loaded by the port.
* ``highlight_field`` on ``tests/test_all.py``'s three highlight cases.
* ``highlight_on_original_document`` and ``search_to_result_with_doc``'s
  highlight on ``tests/test_why_found.py``'s ``highlight_*`` cases, with
  the why-found term sets each package's search gives (found equal).
* Requests with a snippet leaf through ``search``.

Tolerance: exact everywhere: documents, snippets, ids, order, ``num_hits``
and f32 score bits.
"""

import importlib
import json

import numpy as np
import pytest

from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
import test_why_found as twf
from test_torch_host import reference_library  # noqa: F401 -- a fixture, used by name
from veloci_tpu import Persistence, Request, add_token_values_to_tokens, search, search_to_result_with_doc
from veloci_tpu.query.request import RequestSearchPart
from veloci_tpu.search.field_search import highlight_field as ref_highlight_field
from veloci_tpu.search.highlight import highlight_on_original_document as ref_highlight_doc
from veloci_tpu.search.read_document import read_data as ref_read_data
import veloci_tpu_torch as vt
from veloci_tpu_torch import doc_store
from veloci_tpu_torch.error import VelociError
from veloci_tpu_torch.query.request import RequestSearchPart as PortSearchPart
from veloci_tpu_torch.search.highlight import highlight_on_original_document
from veloci_tpu_torch.search.read_document import read_data

ex_mod = importlib.import_module("veloci_tpu.search.executor")
batch_mod = importlib.import_module("veloci_tpu.search.batch")


# ---------------------------------------------------------------- DocLoader

def _docs(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "日本語", "straße", "x" * 50]
    return [json.dumps({"nr": i, "t": " ".join(rng.choice(words, int(rng.integers(1, 30))))},
                       ensure_ascii=False) for i in range(n)]


def _blob(docs):
    w = doc_store.DocStoreWriter()
    w.add_docs(docs)
    return w.finish()


def _codecs(blob):
    loader = doc_store.DocLoader(blob)
    return {blob[int(start)] for start in loader._index[:, 1]}


@pytest.mark.parametrize("codec", ["lz", "zlib"])
def test_doc_loader_reads_each_codec(monkeypatch, codec):
    if codec == "lz":
        assert doc_store.lz_available(), "the port's native library builds from native/indexer.cpp"
    else:
        monkeypatch.setattr(doc_store, "lz_available", lambda: False)
    docs = _docs()
    blob = _blob(docs)
    assert _codecs(blob) == {1 if codec == "lz" else 0}
    loader = doc_store.DocLoader(blob)
    assert loader.num_docs == len(docs) and len(loader._index) > 8
    assert [loader.get_doc(i) for i in range(loader.num_docs)] == docs
    for bad in (-1, len(docs)):
        with pytest.raises(IndexError):
            loader.get_doc(bad)


def test_doc_loader_evicts_and_rereads(monkeypatch):
    """A cache of two blocks, read in an order that evicts."""
    monkeypatch.setattr(doc_store, "_CACHE_BLOCKS", 2)
    docs = _docs(seed=6)
    loader = doc_store.DocLoader(_blob(docs))
    order = np.random.default_rng(7).permutation(len(docs))
    assert [loader.get_doc(int(i)) for i in order] == [docs[i] for i in order]
    assert len(loader._cache) == 2


def test_doc_loader_reads_zlib_blocks_beside_lz_blocks(monkeypatch):
    """A store whose blocks mix both codecs, as the format allows."""
    docs = _docs(400, seed=8)
    lz = _blob(docs)
    monkeypatch.setattr(doc_store, "lz_available", lambda: False)
    zl = _blob(docs)
    # every other block of the LZ store taken from the zlib store
    a, b = doc_store.DocLoader(lz), doc_store.DocLoader(zl)
    body, rows = bytearray(), []
    for k in range(len(a._index)):
        src, idx = (lz, a._index) if k % 2 else (zl, b._index)
        first, start, end = (int(x) for x in idx[k])
        rows.append((first, len(body), len(body) + end - start))
        body += src[start:end]
    tail = np.array(rows, dtype=np.uint64).tobytes()
    mixed = bytes(body) + tail + len(tail).to_bytes(8, "little") + len(docs).to_bytes(8, "little") + b"VTD2"
    assert _codecs(mixed) == {0, 1}
    mixed_loader = doc_store.DocLoader(mixed)
    assert [mixed_loader.get_doc(i) for i in range(mixed_loader.num_docs)] == docs


def test_doc_loader_refuses_other_bytes():
    with pytest.raises(VelociError):
        doc_store.DocLoader(b"not a store at all")


# ---------------------------------------------------------------- select, read, highlight

@pytest.fixture(scope="module")
def test_all_indexes(tmp_path_factory, reference_library):
    """tests/test_all.py's index: the reference's, the port's own build,
    and the reference's index directory loaded by the port."""
    data = data_ndjson()
    pers = Persistence.create_from_str(data, TEST_CONFIG)
    add_token_values_to_tokens(pers, *TOKEN_VALUES)
    directory = tmp_path_factory.mktemp("torch_documents_index")
    pers.save(str(directory))
    port = vt.Persistence.from_built(vt.create_indices_from_str(data, TEST_CONFIG))
    vt.add_token_values_to_tokens(port, *TOKEN_VALUES)
    return pers, {"port_built": vt.TorchIndex.from_persistence(port, "cpu"),
                  "ref_disk": vt.load_index(str(directory), "cpu")}


READS = {
    "object_only_partly": (4, ["commonness", "ent_seq", "meanings.ger[]", "kana[].text", "kana[].commonness",
                               "kana[].romaji", "address[].line[]"]),
    "skip_missing_fields": (3, ["mylongtext"]),
    "recreate_complete_object": (4, None),
    "nested_and_1_n": (0, ["meanings.eng[]", "kanji[].text", "kanji[].commonness", "address[].line[]"]),
}


@pytest.mark.parametrize("index_kind", ["port_built", "ref_disk"])
@pytest.mark.parametrize("name", list(READS))
def test_read_data_equals_reference(test_all_indexes, index_kind, name):
    pers, indexes = test_all_indexes
    anchor, fields = READS[name]
    fields = pers.get_all_fields() if fields is None else fields
    got = read_data(indexes[index_kind], anchor, fields)
    assert got == ref_read_data(pers, anchor, fields)
    if name == "recreate_complete_object":
        assert got["ent_seq"] == "1587700" and got["kanji"] == [{"text": "意慾", "commonness": "20"}]


WITH_DOCS = {
    "select_fields": {"search_req": {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
                      "select": ["ent_seq", "tags[]"]},
    "select_on_long_text": {"search_req": {"search": {"terms": ["story"], "path": "mylongtext"}},
                            "select": ["mylongtext"]},
    "whole_documents": {"search_req": {"or": {"queries": [
        {"search": {"terms": ["urge"], "path": "meanings.eng[]"}},
        {"search": {"terms": ["test"], "path": "meanings.ger[]"}}]}}, "top": 20},
    "whole_documents_regex": {"search_req": {"search": {"terms": ["tre.*"], "path": "meanings.ger[]",
                                                        "is_regex": True}}},
    "select_regex": {"search_req": {"search": {"terms": [".*st"], "path": "meanings.ger[]",
                                               "is_regex": True}},
                     "select": ["ent_seq", "meanings.ger[]", "kanji[].text"]},
}


def _ref_search(mp, pers, spec):
    mp.setenv("VELOCI_REGEX_DEVICE", "0")
    mp.setattr(ex_mod, "SMALL_DOCS", 0)
    mp.setattr(batch_mod, "SMALL_DOCS", 0)
    req = Request.from_dict(spec)
    res = search(req, pers)
    return res, search_to_result_with_doc(pers, res, req.select)


def _docs_key(res):
    d = res.to_dict()
    d.pop("execution_time_ns")
    for row in d["data"]:
        row["hit"]["score"] = np.float32(row["hit"]["score"]).view(np.int32).item()
    return d


@pytest.mark.parametrize("index_kind", ["port_built", "ref_disk"])
@pytest.mark.parametrize("name", list(WITH_DOCS))
def test_search_to_result_with_doc_equals_reference(test_all_indexes, monkeypatch, index_kind, name):
    pers, indexes = test_all_indexes
    spec = WITH_DOCS[name]
    _ref, want = _ref_search(monkeypatch, pers, spec)
    index = indexes[index_kind]
    req = vt.Request.from_dict(spec)
    got = vt.search_to_result_with_doc(index, vt.search(req, index), req.select)
    assert _docs_key(got) == _docs_key(want)
    assert got.data, name
    if name == "select_fields":
        assert got.data[0].doc == {"ent_seq": "1587690", "tags": ["nice"]}


@pytest.mark.parametrize("index_kind", ["port_built", "ref_disk"])
@pytest.mark.parametrize("path", ["mylongtext", "tags[]", "sub_level[].text"])
def test_highlight_field_equals_reference(test_all_indexes, index_kind, path):
    pers, indexes = test_all_indexes
    kw = dict(terms=["story"], path=path, levenshtein_distance=0, starts_with=True, snippet=True, top=10,
              skip=0)
    want = ref_highlight_field(pers, RequestSearchPart(**kw))
    got = vt.highlight_field(indexes[index_kind], PortSearchPart(**kw))
    assert [(t, np.float32(s).view(np.int32).item(), i) for t, s, i in got] == [
        (t, np.float32(s).view(np.int32).item(), i) for t, s, i in want]
    assert [el[0] for el in got][0].startswith("Prolog:\nthis is")


@pytest.mark.parametrize("index_kind", ["port_built", "ref_disk"])
@pytest.mark.parametrize("snippet_info", [None, {"num_words_around_snippet": 1, "snippet_start_tag": "[",
                                                 "snippet_end_tag": "]", "max_snippets": 1}])
def test_snippet_leaf_through_search(test_all_indexes, monkeypatch, index_kind, snippet_info):
    """A leaf that asks for snippets is searched like any other leaf, on the
    dense executor."""
    pers, indexes = test_all_indexes
    leaf = {"terms": ["story"], "path": "mylongtext", "snippet": True}
    if snippet_info is not None:
        leaf["snippet_info"] = snippet_info
    spec = {"search_req": {"or": {"queries": [{"search": leaf},
                                              {"search": {"terms": ["urge"], "path": "meanings.eng[]"}}]}}}
    _ref, want = _ref_search(monkeypatch, pers, spec)
    index = indexes[index_kind]
    before = index.path_counts["executor"]
    got = vt.search_to_result_with_doc(index, vt.search(vt.Request.from_dict(spec), index))
    assert _docs_key(got) == _docs_key(want) and len(got.data) == 2
    assert index.path_counts["executor"] == before + 1


# ---------------------------------------------------------------- highlight on the original document

HIGHLIGHTS = {
    "should_tokenize_url": ("veloci", "url", {}),
    "custom_tokenized_test": ("test", "custom_tokenized", {}),
    "custom_tokenized_section": ("§", "custom_tokenized", {}),
    "custom_tokenized_cool": ("_ cool _", "custom_tokenized", {}),
    "custom_tokenized_lt": ("<<", "custom_tokenized", {}),
    "complete_text_hit": ("<<cool>>", "custom_tokenized", {}),
    "untokenized": ("ID1000", "not_tokenized", {}),
    "untokenized_1_n": ("ID1000", "not_tokenized_1_n[]", {}),
    "taschenbuch": ("Taschenbuch", "buch", {"levenshtein_distance": 1}),
    "regex": (".*github.com.*", "url", {"is_regex": True}),
}


@pytest.fixture(scope="module")
def why_found_indexes(reference_library):
    nd = "\n".join(json.dumps(d, ensure_ascii=False) for d in twf.DATA)
    pers = Persistence.create_from_str(nd, twf.CONFIG)
    index = vt.TorchIndex.from_persistence(vt.Persistence.from_built(vt.create_indices_from_str(nd, twf.CONFIG)),
                                           "cpu")
    return pers, index


@pytest.mark.parametrize("name", list(HIGHLIGHTS) + ["multi_terms"])
def test_highlight_on_original_document_equals_reference(why_found_indexes, monkeypatch, name):
    """Each package's search with ``why_found`` gives the same term sets;
    both packages highlight the hits' documents with them, directly and
    through ``search_to_result_with_doc``."""
    pers, index = why_found_indexes
    if name == "multi_terms":
        tree = {"or": {"queries": [
            {"search": {"terms": [t], "path": "buch", "levenshtein_distance": 1}}
            for t in ("Taschenbuch", "kartoniert")]}}
    else:
        term, path, kw = HIGHLIGHTS[name]
        tree = {"search": dict({"terms": [term], "path": path}, **kw)}
    ref_res, ref_docs = _ref_search(monkeypatch, pers, {"search_req": tree, "why_found": True})
    terms = {p: set(t) for p, t in ref_res.why_found_terms.items()}
    assert terms and ref_res.data, name
    got = vt.search(vt.Request.from_dict({"search_req": tree, "why_found": True}), index)
    assert [(h.id, h.score) for h in got.data] == [(h.id, h.score) for h in ref_res.data]
    assert got.why_found_terms == ref_res.why_found_terms
    for hit in got.data:
        doc = json.loads(index.doc_loader.get_doc(hit.id))
        assert doc == json.loads(pers.doc_loader.get_doc(hit.id))
        assert highlight_on_original_document(index, doc, terms) == ref_highlight_doc(pers, doc, terms)
    with_docs = vt.search_to_result_with_doc(index, got)
    assert [d.why_found for d in with_docs.data] == [d.why_found for d in ref_docs.data]
    assert with_docs.data[0].why_found
