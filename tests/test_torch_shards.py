"""The mesh's building blocks and the host fan-out, against the JAX
package's: B4's dense-plane forms (``veloci_tpu_torch/ops/generic_step.py``
vs ``veloci_tpu/ops/generic_step.py``), the sharded postings, dictionary,
top-k and facet steps (``veloci_tpu_torch/parallel/sharding.py`` vs
``veloci_tpu/parallel/sharding.py`` and the port's unsharded steps), and
``tests/test_shards.py``'s cases bound to the port's
``parallel/shards.py``. Inputs are made from seeds with numpy; meshes hold
CPU devices.

Tolerance: B4 against the reference: ids, hit counts, masks and facet
counts exact; planes and scores within a relative 2e-6 (the reference sums
a union's values in XLA's order, the port in descending index order:
ROADMAP C2), a boost with Log10 or Log2 within 1e-6 (numpy's f32 log
against XLA's), and an Add (or no function) with an expression and no
``skip_when_score`` within 1e-6 (the port's folded form adds the factor
and the expression's value as one precomputed sum, as both packages' tree
routes read it, where the reference's dense form adds them one after the
other), the rest bit for bit. The sharded steps against the port's
unsharded ones: exact, f32 bits included. Against the reference's sharded
top-k: its own test's check (the hit set, scores within 1e-6). Fuzzy
matches: the exact match set and distances. The fan-out: its reference
test's checks.
"""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import test_shards as tshards
import veloci_tpu.ops.generic_step as ref_gs
import veloci_tpu.parallel.sharding as ref_sharding
import veloci_tpu_torch as vt
from test_torch_executor import _csr
from veloci_tpu import Persistence
from veloci_tpu.create import TEXTINDEX, TO_ANCHOR_ID_SCORE
from veloci_tpu_torch.ops import generic_step as gs
from veloci_tpu_torch.ops.postings import Csr, dense_max_row_score, resolve_to_anchor_dense
from veloci_tpu_torch.ops.topk import topk_dense
from veloci_tpu_torch.parallel import sharding
from veloci_tpu_torch.parallel.shards import ShardedPersistence, build_sharded
from veloci_tpu_torch.search.facet import FacetRelation, facet_counts
from veloci_tpu_torch.search.field_search import prefetch_fuzzy_matches
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture


def _cpu_mesh(d, q=1):
    return sharding.build_mesh(d, q, ["cpu"] * (d * q))


def _port_csr(offsets, packed):
    scores01 = packed[:, 1].copy().view(np.float32)
    return Csr(torch.from_numpy(offsets), torch.from_numpy(packed), offsets, dense_max_row_score(scores01))


def _ref_args(offsets, packed):
    return (jnp.asarray(offsets.astype(np.int32)), jnp.asarray(packed[:, 0].copy()),
            jnp.asarray(packed[:, 1].copy().view(np.float32)))


def _capacity(offsets, tids):
    live = tids[tids >= 0]
    return int(2 ** np.ceil(np.log2(max(int((offsets[live + 1] - offsets[live]).sum()), 1) + 1)))


# ---------------------------------------------------------------- B4: the dense-plane forms
BOOSTS = [(fun, expr, skip) for fun in ("Log10", "Log2", "Multiply", "Add", "Replace", None)
          for expr in (False, True) for skip in ((), (2.0,))]


@pytest.mark.parametrize("fun,expr,skip", BOOSTS)
def test_apply_boost_equals_reference(fun, expr, skip):
    rng = np.random.default_rng(len(str(fun)) + 2 * expr + 4 * len(skip))
    n = 400
    dense = np.where(rng.random(n) < 0.4, 0.0, rng.random(n) * 5 + 0.01).astype(np.float32)
    dense[:5] = 2.0  # some scores skip_when_score exempts
    bv = (rng.random(n) * 20).astype(np.float32)
    pres = rng.random(n) < 0.7
    ea = (rng.random(n) * 3).astype(np.float32) if expr else None
    spec = (fun, 1.5, skip)
    want = np.asarray(ref_gs._apply_boost(jnp.asarray(dense), ref_gs._precompute_boost(
        jnp.asarray(bv), jnp.asarray(pres), spec + (None if ea is None else jnp.asarray(ea),))))
    got = gs._apply_boost(torch.from_numpy(dense), gs._precompute_boost(
        torch.from_numpy(bv), torch.from_numpy(pres), spec + (None if ea is None else torch.from_numpy(ea),))).numpy()
    if fun in ("Log10", "Log2") or (fun in ("Add", None) and expr and not skip):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert ((got > 0) == (want > 0)).all()


@pytest.mark.parametrize("seed", [0, 1, 3, 4])  # seeds whose AND trees have hits
@pytest.mark.parametrize("is_and", [False, True])
def test_tree_dense_equals_reference(seed, is_and):
    rng = np.random.default_rng(seed)
    num_keys, nd = 120, 200
    offsets, packed = _csr(rng, num_keys, nd, 180)
    num_slots = int(rng.integers(2, 6))
    t = int(rng.integers(num_slots, 16))
    tids = np.full(16, -1, np.int32)
    tids[:t] = rng.integers(0, num_keys, t)
    tscs = (rng.integers(1, 400, 16) / np.float32(37.0)).astype(np.float32)
    tslots = np.concatenate([np.arange(num_slots), rng.integers(0, num_slots, 16 - num_slots)]).astype(np.int32)
    want = np.asarray(ref_gs.tree_dense(*_ref_args(offsets, packed), jnp.asarray(tids), jnp.asarray(tscs),
                                        jnp.asarray(tslots), _capacity(offsets, tids), nd, num_slots, is_and))
    got = gs.tree_dense(_port_csr(offsets, packed), tids, tscs, tslots, nd, num_slots, is_and).numpy()
    assert ((got > 0) == (want > 0)).all() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=2e-6)


def _deep_maps(rng, num_planes=7, num_groups=5, num_subs=3, num_terms=2):
    """Random plane -> group -> subtree -> term maps, each level onto."""
    def onto(n, m):
        return np.concatenate([np.arange(m), rng.integers(0, m, n - m)]).astype(np.int32)
    s2g, g2s, s2t = onto(num_planes, num_groups), onto(num_groups, num_subs), onto(num_subs, num_terms)
    ng_sub = np.array([np.sum(g2s == u) for u in range(num_subs)], np.float32)
    ng_sub[0] = max(ng_sub[0] - 1, 1)  # a gate below the group count
    return s2g, g2s, s2t, ng_sub


@pytest.mark.parametrize("seed", range(4))
def test_tree_dense_deep_equals_reference(seed):
    rng = np.random.default_rng(10 + seed)
    num_keys, nd = 60, 300
    offsets, packed = _csr(rng, num_keys, nd, 200)
    s2g, g2s, s2t, ng_sub = _deep_maps(rng)
    tids = rng.integers(0, num_keys, 24).astype(np.int32)
    tids[-3:] = -1
    tscs = (rng.integers(1, 400, 24) / np.float32(37.0)).astype(np.float32)
    tplanes = np.concatenate([np.arange(7), rng.integers(0, 7, 17)]).astype(np.int32)
    want = np.asarray(ref_gs.tree_dense_deep(
        *_ref_args(offsets, packed), jnp.asarray(tids), jnp.asarray(tscs), jnp.asarray(tplanes), jnp.asarray(s2g),
        jnp.asarray(g2s), jnp.asarray(s2t), jnp.asarray(ng_sub), _capacity(offsets, tids), nd, 7, 5, 3, 2))
    got = gs.tree_dense_deep(_port_csr(offsets, packed), tids, tscs, tplanes, s2g, g2s, s2t, ng_sub, nd,
                             7, 5, 3, 2).numpy()
    assert ((got > 0) == (want > 0)).all() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_phrase_factor_equals_reference():
    rng = np.random.default_rng(3)
    nd = 200
    panch = np.concatenate([rng.integers(0, nd, 300), np.full(20, nd), [-1] * 0]).astype(np.int32)
    want = np.asarray(ref_gs.phrase_factor(jnp.asarray(panch), nd))
    got = gs.phrase_factor(torch.from_numpy(panch.astype(np.int64)), nd).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got.max() > 5.0


@pytest.mark.parametrize("is_and", [False, True])
def test_batched_generic_topk_equals_reference(is_and):
    rng = np.random.default_rng(7 + is_and)
    num_keys, nd, q, k = 80, 600, 5, 12
    offsets, packed = _csr(rng, num_keys, nd, 250)
    num_slots = 2
    tids = np.full((q, 6), -1, np.int32)
    tids[:, :4] = rng.integers(0, num_keys, (q, 4))
    tscs = (rng.integers(1, 400, (q, 6)) / np.float32(37.0)).astype(np.float32)
    tslots = np.tile(np.array([0, 1, 0, 1, 0, 0], np.int32), (q, 1))
    fmasks = rng.random((3, nd)) < 0.8
    fidx = rng.integers(0, 3, q).astype(np.int32)
    pa = np.full((q, 8), nd, np.int32)
    pa[:, :5] = rng.integers(0, nd, (q, 5))
    bv = (rng.random(nd) * 20).astype(np.float32)
    pres = rng.random(nd) < 0.6
    sources = rng.integers(0, nd, 900)
    targets = rng.integers(0, 7, 900)
    mat = np.zeros((nd, 7), np.float32)
    np.add.at(mat, (sources, targets), 1.0)
    order = np.argsort(sources, kind="stable")
    rel_off = np.zeros(nd + 1, np.int64)
    np.cumsum(np.bincount(sources, minlength=nd), out=rel_off[1:])
    rel = FacetRelation(torch.from_numpy(rel_off), torch.from_numpy(targets[order].astype(np.int64)), 7)
    specs = (("Multiply", 1.0, ()),)
    w_ids, w_scores, w_hits, (w_counts,) = ref_gs.batched_generic_topk(
        *_ref_args(offsets, packed), jnp.asarray(tids), jnp.asarray(tscs), jnp.asarray(tslots), jnp.asarray(fmasks),
        jnp.asarray(fidx), jnp.asarray(pa), ((jnp.asarray(bv), jnp.asarray(pres), None),),
        (jnp.asarray(mat, dtype=jnp.bfloat16),), capacity=_capacity(offsets, tids.reshape(-1)), num_docs=nd, k=k,
        num_slots=num_slots, is_and=is_and, boost_specs=specs)
    ids, scores, hits, (counts,) = gs.batched_generic_topk(
        _port_csr(offsets, packed), tids, tscs, tslots, torch.from_numpy(fmasks), fidx, pa,
        ((torch.from_numpy(bv), torch.from_numpy(pres), None),), (rel,), nd, k, num_slots, is_and, specs)
    np.testing.assert_array_equal(hits, np.asarray(w_hits))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(w_counts))
    assert hits.sum() > 0
    for qi in range(q):
        live = np.asarray(w_scores[qi]) > 0
        assert ids[qi].tolist() == np.asarray(w_ids[qi])[live].tolist()
        np.testing.assert_allclose(scores[qi].numpy(), np.asarray(w_scores[qi])[live], rtol=2e-6)


# ---------------------------------------------------------------- the sharded steps
@pytest.fixture(scope="module")
def titles():
    """``tests/test_sharding.py``'s corpus: 64 documents over 50 words."""
    rng = np.random.default_rng(42)
    words = [f"w{i:03d}" for i in range(50)]
    nd = "\n".join(json.dumps({"title": " ".join(rng.choice(words, size=5)), "id": str(i)}) for i in range(64))
    return Persistence.create_from_str(nd, "{}"), vt.TorchIndex.from_persistence(vt.Persistence.create_from_str(nd),
                                                                                 "cpu")


def _ref_postings(pers, mesh):
    store = pers.anchor_scores["title" + TEXTINDEX + TO_ANCHOR_ID_SCORE]
    return ref_sharding.ShardedPostings(offsets=np.asarray(store.offsets, dtype=np.int64), anchors=store.anchors,
                                        scores01=store.scores.astype(np.float32) / np.float32(100.0),
                                        num_docs=pers.num_docs, mesh=mesh)


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 2)])
def test_sharded_search_topk(titles, shape):
    pers, index = titles
    d, q = shape
    packed = index.packed.numpy()
    postings = sharding.ShardedPostings(index.host_offsets[:-1], packed[:, 0], packed[:, 1].copy().view(np.float32),
                                        index.num_docs, _cpu_mesh(d, q))
    base = index.key_base["title"][0]
    dictionary = index.get_dictionary("title")
    queries = ["w001", "w017", "w042", "w007"]
    tids = np.full((4, 8), -1, np.int32)
    tscs = np.zeros((4, 8), np.float32)
    for qi, word in enumerate(queries):
        ids = dictionary.get_ignore_case(word)
        tids[qi, : len(ids)] = np.asarray(ids) + base
        tscs[qi, : len(ids)] = 10.0
    ids, scores = sharding.sharded_search_topk(postings, tids, tscs, k=8)
    ref_ids, ref_scores, _ = ref_sharding.sharded_search_topk(
        _ref_postings(pers, ref_sharding.build_mesh(d, q)), tids - base * (tids >= 0), tscs, 512, k=8)
    for qi in range(4):
        live = tids[qi] >= 0
        dense = resolve_to_anchor_dense(index, "title", tids[qi][live] - base, tscs[qi][live])
        want_ids, want_scores = topk_dense(dense, 8)
        assert ids[qi].tolist() == want_ids.tolist()
        np.testing.assert_array_equal(scores[qi].view(np.int32), want_scores.numpy().view(np.int32))
        r_scores = np.asarray(ref_scores[qi])
        assert set(ids[qi].tolist()) == set(np.asarray(ref_ids[qi])[r_scores > 0].tolist())
        np.testing.assert_allclose(np.sort(scores[qi]), np.sort(r_scores[r_scores > 0]), rtol=1e-6)
        assert len(ids[qi])


def _synthetic_dictionary():
    """``tests/test_sharding.py``'s windowed dictionary: 3000 terms of varied lengths."""
    terms = sorted({f"{'abcdwxyz'[i % 8]}{'m' * (i % 9)}{i % 53:02d}" for i in range(3000)})
    chars = np.zeros((len(terms), 32), dtype=np.uint16)
    lengths = np.zeros(len(terms), dtype=np.int32)
    for i, t in enumerate(terms):
        chars[i, : len(t)] = [ord(c) for c in t]
        lengths[i] = len(t)
    return terms, chars, lengths


@pytest.mark.parametrize("windowed", [True, False])
def test_sharded_fuzzy_match_equals_host_and_reference(windowed, monkeypatch):
    from veloci_tpu.ops.levenshtein import encode_query, levenshtein_distance_host

    terms, chars, lengths = _synthetic_dictionary()
    sd = sharding.ShardedDictionary(chars, lengths, _cpu_mesh(8))
    assert sum(s.lengths.shape[0] for s in sd.shards) == len(terms)
    monkeypatch.setattr(ref_sharding, "LW_SHARD_BLOCK", 16)
    ref_sd = ref_sharding.ShardedDictionary(chars, lengths, ref_sharding.build_mesh(8, 1))
    for query, d in (("amm07", 1), ("bmmmm21", 2), ("c04", 1), ("zmmmmmmmm52", 2)):
        window = dict(min_len=len(query) - d, max_len=len(query) + d) if windowed else {}
        if windowed:  # the windows hold fewer rows than the shards
            assert sum(sd.window(i, len(query) - d, len(query) + d).lengths.shape[0] for i in range(8)) < len(terms)
        ids, dists, _p, total = sharding.sharded_fuzzy_match(sd, query, d, **window)
        expected = {i for i, t in enumerate(terms) if levenshtein_distance_host(query, t) <= d}
        assert set(ids.tolist()) == expected and total == len(expected) and ids.tolist() == sorted(ids.tolist())
        assert [int(x) for x in dists] == [levenshtein_distance_host(query, terms[i]) for i in ids]
        q, qlen = encode_query(query)
        r_ids, _rd, _rp, _rt = ref_sharding.sharded_fuzzy_match(ref_sd, q, qlen, distance=d, **window)
        assert set(ids.tolist()) == {int(i) for i in r_ids if 0 <= i < len(terms)}


def test_sharded_select_equals_unsharded_prefetch(titles):
    """The field search's launch groups (one banded item, two banded items,
    a distance past the band, ``starts_with``) give the unsharded prefetch's
    matches on the term-sharded dictionary of a real field."""
    _pers, index = titles
    sweep = index.fields["title"]
    sd = sharding.ShardedDictionary(sweep.chars_t.numpy().T, sweep.lengths.numpy(), _cpu_mesh(4),
                                    sweep.sweep_ids.numpy())
    groups = [[("w013", 1, False)], [("w013", 1, False), ("w0x7", 2, False)], [("w01", 5, False)],
              [("w01", 1, True)]]
    for items in groups:
        want = prefetch_fuzzy_matches(index, [("title", *it) for it in items])
        for it, (ids, dists, prefixes) in zip(items, sharding.sharded_select(sd, items)):
            order = np.argsort(ids, kind="stable")
            w = want[("title", *it)]
            assert ids[order].tolist() == w[0].tolist() and len(w[0])
            assert dists[order].tolist() == w[1].tolist() and prefixes[order].tolist() == w[2].tolist()


def test_sharded_facet_counts_equal_unsharded():
    rng = np.random.default_rng(5)
    nd = 301
    sources = rng.integers(0, nd, 2000)
    targets = rng.integers(0, 11, 2000)
    order = np.argsort(sources, kind="stable")
    off = np.zeros(nd + 1, np.int64)
    np.cumsum(np.bincount(sources, minlength=nd), out=off[1:])
    rel = FacetRelation(torch.from_numpy(off), torch.from_numpy(targets[order]), 11)
    plane = torch.from_numpy(np.where(rng.random(nd) < 0.3, rng.random(nd), 0.0).astype(np.float32))
    hits = torch.nonzero(plane > 0).squeeze(1)
    want = facet_counts(rel, torch.zeros_like(hits), hits, 1)[0]
    bounds = sharding.doc_bounds(nd, 8)
    rels = sharding.shard_relation(rel, bounds, ["cpu"] * 8)
    planes = [plane[bounds[i] : bounds[i + 1]] for i in range(8)]
    assert sharding.sharded_facet_counts(rels, planes, torch.device("cpu")).tolist() == want.tolist()
    assert want.sum() > 0


def test_collectives_and_mesh_grid():
    mesh = _cpu_mesh(4, 2)
    assert mesh.shape == {"q": 2, "d": 4}
    parts = [torch.tensor([i, 10 * i]) for i in range(4)]
    assert sharding.all_gather(parts, mesh.lead()).tolist() == [0, 0, 1, 10, 2, 20, 3, 30]
    assert sharding.psum(parts, mesh.lead(1)).tolist() == [6, 60]
    big, small = np.float32(1e8), np.float32(3.0)  # shard order: (1e8 + 3) + 3 rounds away both times
    assert sharding.psum([torch.tensor([big]), torch.tensor([small]), torch.tensor([small])],
                         "cpu").item() == float(np.float32(np.float32(big + small) + small))
    assert list(sharding.doc_bounds(5, 8)) == [0, 1, 2, 3, 4, 5, 5, 5, 5]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sharding.build_mesh(2)  # the card by default: no CPU fallback


# ---------------------------------------------------------------- tests/test_shards.py's cases on the port
@pytest.fixture(scope="module")
def corpora():
    rng = np.random.default_rng(11)
    words = [f"w{i:02d}" for i in range(40)]
    lines = [json.dumps({"title": " ".join(rng.choice(words, size=4)), "tags": [str(rng.integers(0, 5))],
                         "nr": str(i)}) for i in range(60)]
    cfg = '{"*GLOBAL*": {"features": ["All"]}, "tags[]": {"facet": true}}'
    single = vt.TorchIndex.from_persistence(vt.Persistence.create_from_str("\n".join(lines), cfg), "cpu")
    return single, build_sharded(lines, cfg, shard_size=17, device="cpu")


@pytest.fixture
def port_shards(monkeypatch):
    """``tests/test_shards.py``'s module names rebound to the port's."""
    monkeypatch.setattr(tshards, "search", vt.search)
    monkeypatch.setattr(tshards, "Request", vt.Request)
    monkeypatch.setattr(tshards, "ShardedPersistence", _LoadOnCpu)
    monkeypatch.setattr(tshards, "build_sharded",
                        lambda lines, cfg, **kw: build_sharded(lines, cfg, device="cpu", **kw))


class _LoadOnCpu:
    @staticmethod
    def load(directory):
        return ShardedPersistence.load(directory, "cpu")


SHARD_CASES = [("test_shard_structure", {}), ("test_sharded_facets", {}), ("test_sharded_doc_fetch", {})] + [
    ("test_sharded_search_matches_single", {"term": t}) for t in ("w05", "w17", "w39", "missing")]


@pytest.mark.parametrize("name,kw", SHARD_CASES, ids=[f"{n}-{kw.get('term', '')}" for n, kw in SHARD_CASES])
def test_shards_cases_on_the_port(corpora, port_shards, name, kw):
    getattr(tshards, name)(corpora, **kw)


def test_shards_save_load_on_the_port(corpora, port_shards, tmp_path):
    tshards.test_sharded_save_load(corpora, tmp_path)


def test_shards_cases_listed():
    cases = {n for n in dir(tshards) if n.startswith("test_")}
    assert cases == {n for n, _kw in SHARD_CASES} | {"test_sharded_save_load"}
