"""The port's Levenshtein sweeps and match selection against the JAX
package: the plain PyTorch sweeps must equal the Pallas kernels (run in
interpret mode) bit for bit -- the banded ones B1/B2 and the full-width B3,
which must also equal the XLA sweep ``levenshtein_sweep`` -- and
``select_matches`` must select the same term rows in the same order.
Tolerance: exact equality (integer outputs)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from veloci_tpu.ops.levenshtein import encode_query as ref_encode_query
from veloci_tpu.ops.levenshtein import levenshtein_prefix_distance_host as ref_prefix_distance
from veloci_tpu.ops.levenshtein import levenshtein_sweep
from veloci_tpu.ops.levenshtein import select_matches as ref_select_matches
from veloci_tpu.ops.pallas_levenshtein import (
    levenshtein_sweep_pallas,
    levenshtein_sweep_pallas_banded,
    levenshtein_sweep_pallas_banded_batch,
)
from veloci_tpu_torch.ops.levenshtein import (
    encode_query,
    levenshtein_distances_host,
    levenshtein_prefix_distance_host,
    select_matches,
)
from veloci_tpu_torch.ops.levenshtein_sweep import (
    levenshtein_sweep_banded,
    levenshtein_sweep_banded_batch,
    levenshtein_sweep_full_batch,
    levenshtein_sweep_full_batch_plain,
)
from test_torch_limits import bounded, bounded_module  # noqa: F401 -- a time limit on each test and module fixture

N_PAD = 4096  # a multiple of both Pallas tiles, so neither pads
# edge lengths: empty query (pad row), 1, 31 and 32 chars
QUERIES = ["", "a", "w01", "hela", "x" * 31, "x" * 32, "w0015", "hlelo"]


@pytest.fixture(scope="module")
def dictionary():
    """Terms of length 1..32 plus zero-length rows (the tail and row 5)."""
    rng = np.random.default_rng(17)
    words = (
        [f"w{i:03d}" for i in range(300)]
        + ["a", "ab", "hello", "help", "hells", "x" * 31, "x" * 32, "x" * 30 + "y"]
        + ["".join(rng.choice(list("helowx"), size=int(n))) for n in rng.integers(1, 33, 200)]
    )
    chars = np.zeros((N_PAD, 32), np.uint16)
    lens = np.zeros(N_PAD, np.int32)
    for i, w in enumerate(words):
        if i == 5:
            continue  # an empty row inside the real terms
        for j, ch in enumerate(w[:32]):
            chars[i, j] = ord(ch)
        lens[i] = len(w)
    return np.ascontiguousarray(chars.T), lens


def _queries():
    queries = np.zeros((len(QUERIES), 32), np.uint16)
    qlens = np.zeros(len(QUERIES), np.int32)
    for row, t in enumerate(QUERIES):
        queries[row], qlens[row] = encode_query(t)
    return queries, qlens


def test_encode_query_matches_reference():
    for t in QUERIES + ["\U0001F600ab", "é" * 40]:
        q, n = encode_query(t)
        rq, rn = ref_encode_query(t)
        np.testing.assert_array_equal(q, rq)
        assert n == rn


@pytest.mark.parametrize("dyn", [True, False])
@pytest.mark.parametrize("band", [2, 4])
def test_batch_sweep_equals_pallas(dictionary, band, dyn):
    chars_t, lens = dictionary
    queries, qlens = _queries()
    want = levenshtein_sweep_pallas_banded_batch(
        jnp.asarray(chars_t), jnp.asarray(lens), jnp.asarray(queries),
        jnp.asarray(qlens), interpret=True, band=band, dyn=dyn,
    )
    got = levenshtein_sweep_banded_batch(
        torch.from_numpy(chars_t), torch.from_numpy(lens), torch.from_numpy(queries),
        torch.from_numpy(qlens), band=band,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("band", [2, 4])
def test_single_query_sweep_equals_pallas(dictionary, band):
    chars_t, lens = dictionary
    queries, qlens = _queries()
    for row in (1, 3, 4, 5):
        want = levenshtein_sweep_pallas_banded(
            jnp.asarray(chars_t), jnp.asarray(lens), jnp.asarray(queries[row]),
            jnp.int32(qlens[row]), interpret=True, band=band,
        )
        got = levenshtein_sweep_banded(
            torch.from_numpy(chars_t), torch.from_numpy(lens),
            torch.from_numpy(queries[row]), torch.tensor(qlens[row], dtype=torch.int32),
            band=band,
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("remap", [False, True])
def test_select_matches_equals_reference(dictionary, remap):
    chars_t, lens = dictionary
    queries, qlens = _queries()
    dist, _pd, is_prefix = levenshtein_sweep_banded_batch(
        torch.from_numpy(chars_t), torch.from_numpy(lens), torch.from_numpy(queries),
        torch.from_numpy(qlens), band=4,
    )
    distances = np.array([0, 1, 2, 2, 3, 4, 1, 2], np.int32)
    ids = np.full(N_PAD, -1, np.int32)
    ids[: 600] = np.random.default_rng(3).permutation(600) + 7
    rows, sel, d, p = select_matches(
        dist, is_prefix, dist, torch.from_numpy(distances),
        remap=torch.from_numpy(ids) if remap else None,
    )
    rows, sel, d, p = rows.numpy(), sel.numpy(), d.numpy(), p.numpy()
    assert np.all(np.diff(rows) >= 0)
    for q in range(len(QUERIES)):
        r_ids, r_d, r_p, total = ref_select_matches(
            jnp.asarray(dist[q].numpy()), jnp.asarray(is_prefix[q].numpy()),
            jnp.asarray(dist[q].numpy()), jnp.int32(distances[q]), max_matches=N_PAD,
            remap=jnp.asarray(ids) if remap else None,
        )
        r_ids, r_d, r_p = np.asarray(r_ids), np.asarray(r_d), np.asarray(r_p)
        valid = r_ids >= 0 if remap else np.arange(N_PAD) < int(total)
        mine = rows == q
        assert int(mine.sum()) == int(total)
        np.testing.assert_array_equal(sel[mine], r_ids[valid])
        np.testing.assert_array_equal(d[mine], r_d[valid])
        np.testing.assert_array_equal(p[mine], r_p[valid])


@pytest.mark.parametrize(
    "bad",
    [
        dict(band=3),
        dict(chars_t=torch.zeros((32, 8), dtype=torch.int32)),
        dict(chars_t=torch.zeros((8, 32), dtype=torch.uint16)),
        dict(query_lens=torch.zeros(2, dtype=torch.int64)),
        dict(queries=torch.zeros((2, 64), dtype=torch.uint16)[:, ::2]),
    ],
)
def test_sweep_rejects_bad_arguments(bad):
    args = dict(
        chars_t=torch.zeros((32, 8), dtype=torch.uint16),
        term_lens=torch.zeros(8, dtype=torch.int32),
        queries=torch.zeros((2, 32), dtype=torch.uint16),
        query_lens=torch.zeros(2, dtype=torch.int32),
        band=2,
    )
    args.update(bad)
    with pytest.raises(ValueError):
        levenshtein_sweep_banded_batch(**args)


def test_cpu_tensors_do_not_count_launches():
    before = levenshtein_sweep_banded_batch.launches
    levenshtein_sweep_banded_batch(
        torch.zeros((32, 8), dtype=torch.uint16), torch.zeros(8, dtype=torch.int32),
        torch.zeros((2, 32), dtype=torch.uint16), torch.zeros(2, dtype=torch.int32),
        band=2,
    )
    assert levenshtein_sweep_banded_batch.launches == before


# full-width sweep: queries of length 0, 1, 31 and 32, non-ASCII code points
# (one above the BMP, encoded as U+FFFD) and random ones
FULL_QUERIES = ["", "h", "w01", "hela", "héllo", "日本語", "\U0001F600x", "x" * 31, "x" * 32] + [
    "".join(np.random.default_rng(23).choice(list("heloxé"), size=n)) for n in (2, 5, 9, 17, 26)
]


@pytest.fixture(scope="module")
def full_dictionary():
    """Random terms of length 1..32 over a small alphabet (so distances
    spread), non-ASCII terms, edge terms, and zero-length rows (the tail,
    row 7) -- padded to a multiple of B3's 1024-term tile."""
    rng = np.random.default_rng(29)
    words = (
        ["a", "h", "hello", "héllo", "hèllo", "日本語", "日本", "\uFFFDx", "x" * 31, "x" * 32, "x" * 30 + "é"]
        + ["".join(rng.choice(list("heloxé日"), size=int(n))) for n in rng.integers(1, 33, 900)]
    )
    chars = np.zeros((2048, 32), np.uint16)
    lens = np.zeros(2048, np.int32)
    for i, w in enumerate(words):
        if i == 7:
            continue
        q, n = encode_query(w)
        chars[i], lens[i] = q, n
    return np.ascontiguousarray(chars.T), lens, chars


def _full_queries():
    enc = [encode_query(t) for t in FULL_QUERIES]
    return np.stack([q for q, _n in enc]), np.array([n for _q, n in enc], np.int32)


def test_full_sweep_equals_pallas_and_xla(full_dictionary):
    chars_t, lens, chars = full_dictionary
    queries, qlens = _full_queries()
    got = levenshtein_sweep_full_batch(
        torch.from_numpy(chars_t), torch.from_numpy(lens), torch.from_numpy(queries),
        torch.from_numpy(qlens),
    )
    got = [g.numpy() for g in got]
    for row in range(len(FULL_QUERIES)):
        b3 = levenshtein_sweep_pallas(
            jnp.asarray(chars_t), jnp.asarray(lens), jnp.asarray(queries[row]),
            jnp.int32(qlens[row]), interpret=True,
        )
        xla = levenshtein_sweep(
            jnp.asarray(chars), jnp.asarray(lens), jnp.asarray(queries[row]), jnp.int32(qlens[row])
        )
        for g, w_b3, w_xla in zip(got, b3, xla):
            np.testing.assert_array_equal(g[row], np.asarray(w_b3))
            np.testing.assert_array_equal(g[row], np.asarray(w_xla))


def test_full_sweep_edge_rows(full_dictionary):
    """Empty rows: BIG and no prefix; the empty query: dist = length,
    prefix_dist = 0; distances beyond any band are true."""
    chars_t, lens, _chars = full_dictionary
    queries, qlens = _full_queries()
    dist, prefix, is_prefix = levenshtein_sweep_full_batch(
        torch.from_numpy(chars_t), torch.from_numpy(lens), torch.from_numpy(queries),
        torch.from_numpy(qlens),
    )
    empty = lens == 0
    assert bool((dist[:, empty] == 1 << 20).all()) and bool((prefix[:, empty] == 1 << 20).all())
    assert not bool(is_prefix[:, empty].any())
    np.testing.assert_array_equal(dist[0, ~empty].numpy(), lens[~empty])
    assert bool((prefix[0, ~empty] == 0).all()) and bool(is_prefix[0, ~empty].all())
    assert int(dist[:, ~empty].max()) > 4  # the band would have said BIG


def test_full_sweep_plain_chunks_agree(full_dictionary, monkeypatch):
    """The plain version's query chunking does not change its answers."""
    import veloci_tpu_torch.ops.levenshtein_sweep as sweep_mod

    chars_t, lens, _chars = full_dictionary
    queries, qlens = _full_queries()
    args = [torch.from_numpy(a) for a in (chars_t, lens, queries, qlens)]
    whole = levenshtein_sweep_full_batch_plain(*args)
    monkeypatch.setattr(sweep_mod, "_PLAIN_CHUNK_ELEMS_FULL", 3 * chars_t.shape[1])
    for a, b in zip(whole, levenshtein_sweep_full_batch_plain(*args)):
        assert torch.equal(a, b)


def test_prefix_criterion_selects_as_reference(full_dictionary):
    """``starts_with`` selection: crit = prefix_dist, distances reported in full."""
    chars_t, lens, _chars = full_dictionary
    queries, qlens = _full_queries()
    dist, prefix, is_prefix = levenshtein_sweep_full_batch(
        torch.from_numpy(chars_t), torch.from_numpy(lens), torch.from_numpy(queries),
        torch.from_numpy(qlens),
    )
    distances = np.array([0, 1, 2, 2, 1, 1, 1, 2, 2, 1, 2, 6, 10, 14], np.int32)
    rows, sel, d, p = (
        t.numpy() for t in select_matches(dist, is_prefix, prefix, torch.from_numpy(distances))
    )
    n = chars_t.shape[1]
    assert len(np.unique(rows)) >= len(FULL_QUERIES) - 2
    for q in range(len(FULL_QUERIES)):
        r_ids, r_d, r_p, total = ref_select_matches(
            jnp.asarray(dist[q].numpy()), jnp.asarray(is_prefix[q].numpy()),
            jnp.asarray(prefix[q].numpy()), jnp.int32(distances[q]), max_matches=n,
        )
        valid = np.arange(n) < int(total)
        mine = rows == q
        assert int(mine.sum()) == int(total)
        np.testing.assert_array_equal(sel[mine], np.asarray(r_ids)[valid])
        np.testing.assert_array_equal(d[mine], np.asarray(r_d)[valid])
        np.testing.assert_array_equal(p[mine], np.asarray(r_p)[valid])


def test_prefix_distance_host_equals_reference():
    rng = np.random.default_rng(31)
    words = ["", "a", "hello", "héllo"] + [
        "".join(rng.choice(list("helo"), size=int(n))) for n in rng.integers(0, 12, 200)
    ]
    for a, b in zip(words, words[::-1]):
        assert levenshtein_prefix_distance_host(a, b) == ref_prefix_distance(a, b)


def test_full_sweep_cpu_tensors_do_not_count_launches():
    before = levenshtein_sweep_full_batch.launches
    levenshtein_sweep_full_batch(
        torch.zeros((32, 8), dtype=torch.uint16), torch.zeros(8, dtype=torch.int32),
        torch.zeros((2, 32), dtype=torch.uint16), torch.zeros(2, dtype=torch.int32),
    )
    assert levenshtein_sweep_full_batch.launches == before


@pytest.mark.parametrize("chunk", [None, 3 * 255])
def test_row_distances_equal_reference(monkeypatch, chunk):
    """``levenshtein_rows`` over long terms (the rows ``long_term_rows``
    builds) against the reference's scalar host distances: empty and
    non-ASCII queries, terms past the 254-code cap, several chunks."""
    import veloci_tpu_torch.ops.levenshtein as lev_mod
    from veloci_tpu.indices import TermDictionary
    from veloci_tpu.ops.levenshtein import levenshtein_distance_host as ref_distance
    from veloci_tpu_torch.persistence import long_term_rows

    if chunk:
        monkeypatch.setattr(lev_mod, "_ROWS_CHUNK_ELEMS", chunk)
    rng = np.random.default_rng(41)
    terms = sorted({"x" * 300, "hél" * 90, "Hello" * 7, "\U0001F600" * 40} | {
        "".join(rng.choice(list("heloéHxy"), size=int(n))) for n in rng.integers(33, 90, 60)
    })
    chars, _lens32, codes, lengths, ids = long_term_rows(TermDictionary(terms + ["short"]))
    assert len(ids) == len(terms) and chars.shape == (len(terms), 32)
    queries = ["", "h", "hello", "héllo", "x" * 31, "\U0001F600" * 3, "helohelohelo"]
    q = np.full((len(queries), 32), -1, np.int32)
    for k, t in enumerate(queries):
        q[k, : len(t)] = [ord(ch) for ch in t]
    rows = np.tile(np.arange(len(ids)), len(queries))
    query_of = np.repeat(np.arange(len(queries)), len(ids))
    dist, prefix, is_prefix = (
        t.numpy() for t in lev_mod.levenshtein_rows(
            torch.from_numpy(codes), torch.from_numpy(lengths), torch.from_numpy(q),
            torch.tensor([len(t) for t in queries], dtype=torch.int32),
            torch.from_numpy(rows), torch.from_numpy(query_of),
        )
    )
    for p, (r, k) in enumerate(zip(rows, query_of)):
        term, query = terms[int(ids[r])].lower(), queries[k]
        assert dist[p] == ref_distance(query, term)
        assert prefix[p] == ref_prefix_distance(query, term)
        assert is_prefix[p] == term.startswith(query)


def test_vectorised_host_distances_equal_reference():
    """The host distance, vectorised over terms, against the reference's
    scalar loop: empty strings, non-ASCII, terms past 255 chars (capped)."""
    from veloci_tpu.ops.levenshtein import levenshtein_distance_host as ref_distance

    rng = np.random.default_rng(37)
    terms = ["", "a", "héllo", "日本語", "x" * 300, "hel" * 90] + [
        "".join(rng.choice(list("heloé"), size=int(n))) for n in rng.integers(0, 60, 300)
    ]
    for query in ["", "h", "hello", "héllo", "lleh" * 8, "e" * 256]:
        dist = levenshtein_distances_host(query, terms)
        assert list(dist) == [ref_distance(query, t) for t in terms]
