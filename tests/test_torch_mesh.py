"""The port's document-sharded mesh (``veloci_tpu_torch/parallel/``) against
the JAX package's mesh and against the port's own unsharded index, with
eight shards on the CPU (``build_doc_mesh(8, ["cpu"] * 8)``).

* ``search`` with the mesh attached, for each of
  ``tests/test_device_path.py``'s ``REQUESTS``: against the reference's
  ``mesh_search`` on its 8-device CPU mesh (``tests/conftest.py``) and
  against the port's detached ``search``.
* The uneven tail: 5 documents over 8 shards (``tests/test_mesh_executor.py``).
* ``search_batch`` on the mesh for ``tests/test_mesh_batch.py``'s cases
  (plain trees, ``GENERIC_REQUESTS``, ``DEEP_TREE_REQUESTS`` and a deep
  tree with a filter, a boost and a facet): against the reference's mesh
  ``search_batch`` and the port's detached ``search_batch``.
* (``test_torch_mesh_suites*.py``: the port's own suites' cases on the
  mesh.)
* ``explain`` and ``suggest`` requests are answered on the detached index,
  ``explain_plan`` names the mesh, and a shard whose window or runs hold
  no row launches nothing.

Tolerance: against the port's detached index, exact: ids, order,
``num_hits``, facet lists, the f32 bits of every score, and the raised
error's type. Against the reference: ids, order, ``num_hits`` and facets
exact; scores within each reference test's own tolerance, a relative 2e-6
(``test_mesh_executor.py``) and 1e-4 (``test_mesh_batch.py``).
"""

import importlib

import numpy as np
import torch
import pytest

import jax

import test_torch_generic as tg
from corpus import TEST_CONFIG, TOKEN_VALUES, data_ndjson
from test_batch_generic import GENERIC_REQUESTS
from test_batch_tree import DEEP_TREE_REQUESTS
from test_device_path import REQUESTS
from test_mesh_batch import PLAIN_REQUESTS
from veloci_tpu import Persistence, Request, add_token_values_to_tokens
from veloci_tpu.parallel.mesh_executor import build_doc_mesh as ref_build_doc_mesh
import veloci_tpu_torch as vt
from veloci_tpu_torch import Persistence as PortPersistence
from veloci_tpu_torch import TorchIndex, create_indices_from_str
from veloci_tpu_torch.create import BOOST_VALID_TO_VALUE
from veloci_tpu_torch.ops import postings as port_postings
from veloci_tpu_torch.parallel.mesh_executor import MeshContext, build_doc_mesh
from veloci_tpu_torch.parallel.sharding import build_mesh
from veloci_tpu_torch.search import field_search as port_field_search
from veloci_tpu_torch.search import stats as port_stats
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

ref_search = importlib.import_module("veloci_tpu.search.executor").search
ref_batch = importlib.import_module("veloci_tpu.search.batch")

DEEP_WITH_EXTRAS = {
    "search_req": DEEP_TREE_REQUESTS[0]["search_req"],
    "filter": {"search": {"terms": ["common"], "path": "tags[]"}},
    "boost": [{"path": "commonness", "boost_fun": "Log10", "param": 1}],
    "facets": [{"field": "commonness"}],
    "top": 10,
}
BATCH_REQUESTS = PLAIN_REQUESTS + GENERIC_REQUESTS + list(DEEP_TREE_REQUESTS) + [DEEP_WITH_EXTRAS]


def _cpu_mesh(d=8, q=1):
    return build_mesh(d, q, ["cpu"] * (d * q))


def _bits(res):
    """A result as compared with the detached index: exact, score bits."""
    if isinstance(res, str):
        return res
    return (res.num_hits, [h.id for h in res.data], [int(np.float32(h.score).view(np.int32)) for h in res.data],
            tg._facets(res))


def _assert_reference(got, want, rtol):
    assert got.num_hits == want.num_hits
    assert [h.id for h in got.data] == [h.id for h in want.data]
    np.testing.assert_allclose([h.score for h in got.data], [h.score for h in want.data], rtol=rtol)
    assert tg._facets(got) == tg._facets(want)


@pytest.fixture(scope="module")
def corpus():
    """The ``TEST_CONFIG`` corpus with its token values: the reference's
    answers on its 8-device mesh (``search`` each request, one
    ``search_batch``), and the port's index built from the same data."""
    pers = Persistence.create_from_str(data_ndjson(), TEST_CONFIG)
    add_token_values_to_tokens(pers, TOKEN_VALUES[0], TOKEN_VALUES[1])
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    pers.attach_mesh(ref_build_doc_mesh(8))
    try:
        lone = [ref_search(Request.from_dict(dict(r)), pers) for r in REQUESTS]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ref_batch, "SMALL_DOCS", 1)
            batched = ref_batch.search_batch([Request.from_dict(dict(d)) for d in BATCH_REQUESTS], pers)
    finally:
        pers.detach_mesh()
    port = PortPersistence.from_built(create_indices_from_str(data_ndjson(), TEST_CONFIG))
    vt.add_token_values_to_tokens(port, TOKEN_VALUES[0], TOKEN_VALUES[1])
    return lone, batched, TorchIndex.from_persistence(port, "cpu")


def _on_mesh(index, mesh, call):
    index.attach_mesh(mesh)
    try:
        return call()
    finally:
        index.detach_mesh()


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_mesh_search_equals_reference_and_detached(corpus, i):
    lone, _batched, index = corpus
    want = vt.search(vt.Request.from_dict(dict(REQUESTS[i])), index)
    before = port_stats.snapshot()["paths"].get("mesh_per_request", 0)
    got = _on_mesh(index, _cpu_mesh(), lambda: vt.search(vt.Request.from_dict(dict(REQUESTS[i])), index))
    assert port_stats.snapshot()["paths"]["mesh_per_request"] == before + 1
    assert _bits(got) == _bits(want)
    _assert_reference(got, lone[i], rtol=2e-6)


def test_mesh_batch_equals_reference_and_detached(corpus):
    _lone, batched, index = corpus
    reqs = [vt.Request.from_dict(dict(d)) for d in BATCH_REQUESTS]
    want = vt.search_batch(reqs, index)
    index.path_counts.clear()
    got = _on_mesh(index, _cpu_mesh(), lambda: vt.search_batch(reqs, index))
    assert index.path_counts["mesh_batch"] == len(reqs) and not index.path_counts["mesh_executor"]
    assert index.path_counts["batched_tree_deep"] >= len(DEEP_TREE_REQUESTS)
    for g, w, r in zip(got, want, batched):
        assert _bits(g) == _bits(w)
        _assert_reference(g, r, rtol=1e-4)


def test_mesh_uneven_shard_tail():
    """5 documents over 8 shards: the empty shards add no hits."""
    lines = ['{"t": "alpha beta"}', '{"t": "alpha"}', '{"t": "gamma"}', '{"t": "alpha gamma"}', '{"t": "delta"}']
    index = TorchIndex.from_persistence(PortPersistence.create_from_str("\n".join(lines), "{}"), "cpu")
    index.attach_mesh(_cpu_mesh())
    assert [index.mesh_ctx.shard_docs(i) for i in range(8)] == [1, 1, 1, 1, 1, 0, 0, 0]
    req = vt.Request.from_dict({"search_req": {"search": {"terms": ["alpha"], "path": "t"}}})
    for res in (vt.search(req, index), vt.search(req, index, dense_only=True), vt.search_batch([req], index)[0]):
        assert res.num_hits == 3
        assert sorted(h.id for h in res.data) == [0, 1, 3]


# ---------------------------------------------------------------- routing and launches
def test_explain_and_suggest_answer_unsharded(corpus):
    _lone, _batched, index = corpus
    explained = vt.Request.from_dict({"search_req": REQUESTS[0]["search_req"], "explain": True})
    want = vt.search(explained, index)
    plan_detached = vt.explain_plan(vt.Request.from_dict(dict(REQUESTS[1])), index)
    index.attach_mesh(_cpu_mesh())
    try:
        index.path_counts.clear()
        got = vt.search(explained, index)
        assert index.path_counts["executor"] == 1 and not index.path_counts["mesh_executor"]
        assert got.explain == want.explain and _bits(got) == _bits(want)
        plan = vt.explain_plan(vt.Request.from_dict(dict(REQUESTS[1])), index)
    finally:
        index.detach_mesh()
    assert "mesh (1 x 8 [q, d] grid, 8 document shards" in plan
    assert [ln for ln in plan.split("\n") if "path" not in ln] == [
        ln for ln in plan_detached.split("\n") if "path" not in ln]


def test_empty_shards_launch_nothing(corpus, monkeypatch):
    """A shard whose runs hold no row of a leaf does not resolve it, and a
    shard whose length window holds no row does not sweep it; every other
    shard does, once."""
    _lone, _batched, index = corpus
    resolves, selects = [], []
    real_resolve, real_select = port_postings.dense_resolve, port_field_search._select
    monkeypatch.setattr(port_postings, "dense_resolve", lambda *a, **k: resolves.append(a[6]) or real_resolve(*a, **k))
    monkeypatch.setattr(port_field_search, "_select",
                        lambda sweep, items: selects.append(sweep.lengths.shape[0]) or real_select(sweep, items))
    index.attach_mesh(_cpu_mesh())
    try:
        mc = index.mesh_ctx
        req = vt.Request.from_dict({"search_req": {"search": {"terms": ["urbge"], "path": "meanings.eng[]",
                                                              "levenshtein_distance": 1}}})
        vt.search(req, index, dense_only=True)
        launched, swept = list(resolves), list(selects)
        fsr = port_field_search.search_field(index, req.search_req.part, mc.prefetch(
            [("meanings.eng[]", "urbge", 1, False)]))
        sf = mc.field("meanings.eng[]")
        gtids = fsr.term_ids + sf.base
        ho = [sf.postings.shards[i].host_offsets for i in range(8)]
        with_rows = [i for i in range(8) if int((ho[i][gtids + 1] - ho[i][gtids]).sum())]
        dictionary = mc.sharded_dict("meanings.eng[]")
        windows = [dictionary.window(i, 4, 6).lengths.shape[0] for i in range(8)]
    finally:
        index.detach_mesh()
    assert len(launched) == len(with_rows) and 0 < len(with_rows) < 8
    assert sorted(swept) == sorted(w for w in windows if w) and 0 < len(swept) < 8


def test_mesh_context_plumbing(corpus):
    """Shard bounds, host vectors and a field's postings: every anchor
    lands on its shard, locally, and the shards hold all of the rows."""
    _lone, _batched, index = corpus
    mc = MeshContext(index, _cpu_mesh(3))
    assert list(mc.bounds) == [0, -(-index.num_docs // 3), 2 * -(-index.num_docs // 3), index.num_docs]
    vec = np.arange(index.num_docs, dtype=np.float32)
    assert np.concatenate([t.numpy() for t in mc.shard_host_vector(vec)]).tolist() == vec.tolist()
    shards = mc.combined().shards
    assert sum(s.packed.shape[0] for s in shards) == index.packed.shape[0]
    rows = np.concatenate([s.packed[:, 0].numpy() + mc.bounds[i] for i, s in enumerate(shards)])
    assert sorted(rows.tolist()) == sorted(index.packed[:, 0].tolist())
    assert build_doc_mesh(2, ["cpu", "cpu"]).shape == {"q": 1, "d": 2}


def test_mesh_context_boost_column_and_fuzzy_match(corpus):
    """``boost_column``: a column's shard slices make up the padded column.
    ``fuzzy_match``: a field's term-sharded sweep rows give the unsharded
    prefetch's matches, windowed and for ``starts_with``."""
    _lone, _batched, index = corpus
    mc = MeshContext(index, _cpu_mesh())
    path = "commonness" + BOOST_VALID_TO_VALUE
    values, present = mc.boost_column(path)
    want_values, want_present = index.device_boost(path)
    assert torch.cat(values).tolist() == want_values.tolist() and torch.cat(present).tolist() == want_present.tolist()
    assert [v.shape[0] for v in values] == [mc.shard_docs(i) for i in range(8)] and want_present.any()
    field = "meanings.eng[]"
    assert field not in index.long_terms or not len(index.long_terms[field].ids)  # sweep rows only
    for spec in (("urbge", 1, False), ("tors", 2, False), ("apearanse", 5, False), ("kar", 1, True)):
        want = port_field_search.prefetch_fuzzy_matches(index, [(field, *spec)])[(field, *spec)]
        got = mc.fuzzy_match(field, *spec)
        assert [g.tolist() for g in got] == [w.tolist() for w in want] and len(got[0])
