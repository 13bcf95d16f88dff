"""A synthetic test corpus with a large vocabulary, drawn from the seed,
for the CPU tests of the reference's fuzzy matching (no cell runs it).

A copy of the corpus of the port's ``synthetic.build_corpus``, with the
seed as a parameter: a zipfian vocabulary of ``vocabulary`` words, titles
of 3-9 words drawn with those weights, a 16-value ``cat`` facet, an
``ent_seq`` id and a ``pop`` boost column of 1-999.

Parameters: ``docs``, ``vocabulary``.
"""

from __future__ import annotations

import numpy as np


def _vocab(n: int) -> np.ndarray:
    return np.array([f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(n)])


def _weights(n: int) -> np.ndarray:
    probs = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    return probs / probs.sum()


def words(params: dict, seed: int) -> dict:
    """Per field the words its values are drawn from, with their weights."""
    n = int(params["vocabulary"])
    return {"title": (_vocab(n).tolist(), _weights(n))}


def ndjson(params: dict, seed: int) -> str:
    """The corpus as newline-delimited JSON."""
    n_docs, n = int(params["docs"]), int(params["vocabulary"])
    rng = np.random.default_rng(seed)
    vocab = _vocab(n)
    lengths = rng.integers(3, 10, size=n_docs)
    drawn = rng.choice(vocab, size=int(lengths.sum()), p=_weights(n))
    pops = rng.integers(1, 1000, size=n_docs)
    out = []
    pos = 0
    for i in range(n_docs):
        ln = lengths[i]
        title = " ".join(drawn[pos : pos + ln])
        pos += ln
        out.append('{"title": "%s", "ent_seq": "%d", "cat": "c%d", "pop": %d}' % (title, i, i % 16, pops[i]))
    return "\n".join(out)
