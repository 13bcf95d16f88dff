"""The plain reference: hand-worked cases, and the port's CPU path held to it
on small corpora of both configurations' shapes."""

import json

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from benchmark.corpus import repeat
from benchmark.harness import check, traffic
from benchmark.reference import levenshtein, tokenizer
from benchmark.reference.index import ReferenceIndex
from benchmark.reference.search import Reference

from . import zipf_corpus

DOC = {"type": "taschenbuch", "title": "mein buch"}


def leaf(term, path="title", d=None):
    out = {"terms": [term], "path": path}
    if d:
        out["levenshtein_distance"] = d
    return {"search": out}


def request(tree, top=10):
    return {"search_req": tree, "top": top}


def words_tree(op, *words):
    return {op: {"queries": [{"or": {"queries": [leaf(w, f) for f in ("title", "type")]}} for w in words]}}


def test_pieces_keep_separator_runs():
    assert tokenizer.pieces("mein buch") == ["mein", " ", "buch"]
    assert tokenizer.pieces("  a,, b") == ["  ", "a", ",, ", "b"]
    assert tokenizer.pieces("taschenbuch") == ["taschenbuch"]


def test_levenshtein_by_hand():
    assert levenshtein.distance("kitten", "sitting") == 3
    assert levenshtein.distance("mein", "mien") == 2
    assert levenshtein.distance("", "abc") == 3
    codes, lengths = levenshtein.encode(["sitting", "kitten", "", "kit"])
    assert levenshtein.distances("kitten", codes, lengths).tolist() == [3, 0, 6, 3]


@settings(max_examples=200, deadline=None)
@given(st.text("abc ", max_size=8), st.lists(st.text("abcd", max_size=9), min_size=1, max_size=6))
def test_levenshtein_rows_equal_pairs(query, terms):
    codes, lengths = levenshtein.encode(terms)
    assert levenshtein.distances(query, codes, lengths).tolist() == [levenshtein.distance(query, t) for t in terms]


def test_index_scores_by_hand():
    """One document: occurrences damp to 0.3 log10(1001) - 0.6 + 1 and the
    lengths to 0.3 log10(11 or 13) + 0.7 (float64 by hand, far from the
    integer boundaries): exact texts 400 -> 395, tokens at positions 0, 1, 2
    of three: 145, 143, 142."""
    index = ReferenceIndex(json.dumps(DOC), {})
    title, kind = index.fields["title"], index.fields["type"]
    assert title.terms == [" ", "buch", "mein", "mein buch"]
    assert [title.postings(t)[1][0] * 100 for t in range(4)] == pytest.approx([143, 142, 145, 395])
    assert kind.terms == ["taschenbuch"] and kind.postings(0)[1][0] * 100 == pytest.approx(395)


def test_answers_by_hand():
    """Exact leaves score 2 / 0.2 = 10 a term; an OR of two slots is their
    sum times 2 ** 2, an AND their sum; a fuzzy match at distance 1 scores
    2 / 1.2."""
    ref = Reference(ReferenceIndex(json.dumps(DOC), {}))
    one = ref.answer(request(leaf("mein")))
    assert one.ids.tolist() == [0] and one.num_hits == 1 and one.scores[0] == pytest.approx(14.5)
    assert ref.answer(request(words_tree("or", "mein", "buch"))).scores[0] == pytest.approx((14.5 + 14.2) * 4)
    assert ref.answer(request(words_tree("and", "mein", "buch"))).scores[0] == pytest.approx(28.7)
    both = ref.answer(request(words_tree("and", "taschenbuch", "mein")))
    assert both.scores[0] == pytest.approx(39.5 + 14.5)
    assert ref.answer(request(words_tree("and", "mein", "nichts"))).num_hits == 0
    assert ref.answer(request(leaf("meln", d=1))).scores[0] == pytest.approx(1.45 * 2 / 1.2)
    assert ref.answer(request(leaf("mien", d=1))).num_hits == 0  # two edits away
    assert ref.answer(request(leaf("mien", d=2))).num_hits == 1


def test_ties_break_by_id_descending():
    ref = Reference(ReferenceIndex(repeat.ndjson({"document": DOC, "docs": 50}, 0), {}))
    ans = ref.answer(request(leaf("buch")))
    assert ans.ids.tolist() == list(range(49, 39, -1)) and ans.num_hits == 50
    assert len(set(ans.scores.tolist())) == 1


def test_lower_precision_fails_where_ids_pass():
    """On the repeat corpus every top 10 is a tie, so the ids of the
    bfloat16 control equal the reference's: only the scores catch it."""
    index = ReferenceIndex(repeat.ndjson({"document": DOC, "docs": 300}, 0), {})
    ref, control = Reference(index), Reference(index, "bfloat16")
    stream = traffic.Stream(json.load(open(traffic_path("and-lone"))), repeat.words({"document": DOC}, 0), 5)
    reqs = [stream.next_unit()[0] for _ in range(24)]
    answers = []
    for r in reqs:
        a = control.answer(r)
        answers.append((r, a.ids.tolist(), a.scores.tolist(), a.num_hits))
    checks = check.compare(answers, ref, 0, 1e-5)
    assert checks["ids_wrong"]["value"] == 0 and checks["hits_wrong"]["value"] == 0
    assert checks["score_gap"]["value"] > 1e-4 and not check.holds(checks)


def traffic_path(name):
    from benchmark.harness.spec import BENCH_DIR

    return BENCH_DIR / "traffic" / f"{name}.json"


def port_answers(reqs, index, lone):
    import veloci_tpu_torch as vt

    if lone:
        res = [vt.search(vt.Request.from_dict(r), index) for r in reqs]
    else:
        res = vt.search_batch([vt.Request.from_dict(r) for r in reqs], index)
    return [([h.id for h in x.data], [h.score for h in x.data], x.num_hits) for x in res]


def assert_equal_answers(reqs, got, ref):
    for r, (ids, scores, hits) in zip(reqs, got):
        want = ref.answer(r)
        assert ids == want.ids.tolist(), r
        assert hits == want.num_hits, r
        assert np.array_equal(np.asarray(scores, np.float32), want.scores), r


# 64-request batches of one-leaf title requests, words drawn with the corpus's weights
ZIPF_MIXES = {
    "fuzzy": {"loop": "batch", "batch": 64, "top": 10, "tree": "leaf", "fields": ["title"], "draw": "corpus",
              "edits": [[1, 0.5], [2, 0.5]]},
    "exact": {"loop": "batch", "batch": 64, "top": 10, "tree": "leaf", "fields": ["title"], "draw": "corpus",
              "edits": [[0, 1.0]]},
}
ZIPF_INDEX = {"*GLOBAL*": {"features": ["All"]}, "cat": {"facet": True}, "pop": {"boost": {"boost_type": "f32"}}}


@pytest.mark.parametrize("mix", sorted(ZIPF_MIXES))
def test_port_equals_reference_zipf(tmp_path, on_cpu, mix):
    """A vocabulary of many words, where fuzzy leaves match many terms."""
    import veloci_tpu_torch as vt

    params = {"docs": 3000, "vocabulary": 40000}
    data = zipf_corpus.ndjson(params, 77)
    vt.Persistence.create_from_str(data, json.dumps(ZIPF_INDEX)).save(str(tmp_path / "ix"))
    index = vt.load_index(str(tmp_path / "ix"), "cpu")
    stream = traffic.Stream(ZIPF_MIXES[mix], zipf_corpus.words(params, 77), 3)
    reqs = stream.next_unit() + stream.next_unit()
    # extra fuzzy and exact leaves: distances 1-2 on frequent words, and a miss
    reqs += [request(leaf(w, d=d)) for w in ("w0a", "w1bb", "w2cc", "zzzz") for d in (0, 1, 2)]
    ref = Reference(ReferenceIndex(data, ZIPF_INDEX))
    assert_equal_answers(reqs, port_answers(reqs, index, lone=False), ref)
    assert_equal_answers(reqs[:16], port_answers(reqs[:16], index, lone=True), ref)


def test_port_equals_reference_repeat(tmp_path, on_cpu):
    import veloci_tpu_torch as vt

    data = repeat.ndjson({"document": DOC, "docs": 2000}, 0)
    vt.Persistence.create_from_str(data, "{}").save(str(tmp_path / "ix"))
    index = vt.load_index(str(tmp_path / "ix"), "cpu")
    reqs = [request(words_tree(op, a, b)) for op in ("and", "or")
            for a in ("mein", "buch", "taschenbuch") for b in ("mein", "buch", "taschenbuch") if a != b]
    reqs += [request(leaf(w, f)) for w in ("mein", "buch", "taschenbuch") for f in ("title", "type")]
    reqs += [request(leaf("bcuh", d=2)), request(leaf("taschenbuh", "type", d=1))]
    ref = Reference(ReferenceIndex(data, {}))
    assert_equal_answers(reqs, port_answers(reqs, index, lone=True), ref)
    assert_equal_answers(reqs, port_answers(reqs, index, lone=False), ref)
