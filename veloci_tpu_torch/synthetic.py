"""The jmdict-like synthetic corpus: the port's copy of ``bench.py``'s
``build_corpus`` (``:249-275``), which ``cli create_test_index`` builds and
``chip_smoke.py`` searches.

A zipfian 40,000-word vocabulary, titles of 3-9 words, a 16-value ``cat``
facet column and an integer ``pop`` boost column, from a fixed seed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["VOCAB_SIZE", "build_corpus", "zipf_probs"]

VOCAB_SIZE = 40_000


def zipf_probs(n: int = VOCAB_SIZE) -> np.ndarray:
    """The probability of each of ``n`` words by rank, ``1 / rank``
    normalised: the corpus's word distribution."""
    probs = 1.0 / np.arange(1, n + 1, dtype=np.float64)
    probs /= probs.sum()
    return probs


def build_corpus(n_docs: int):
    """``n_docs`` documents as ndjson, and the vocabulary (a numpy array of
    words, rank order): ``(ndjson, vocab)``, equal to ``bench.py``'s."""
    rng = np.random.default_rng(1234)
    vocab = np.array([f"w{i:x}{'abcdefgh'[i % 8] * (1 + i % 7)}" for i in range(VOCAB_SIZE)])
    lengths = rng.integers(3, 10, size=n_docs)
    words = rng.choice(vocab, size=int(lengths.sum()), p=zipf_probs())
    pops = rng.integers(1, 1000, size=n_docs)
    out = []
    pos = 0
    for i in range(n_docs):
        ln = lengths[i]
        title = " ".join(words[pos : pos + ln])
        pos += ln
        out.append('{"title": "%s", "ent_seq": "%d", "cat": "c%d", "pop": %d}' % (title, i, i % 16, pops[i]))
    return "\n".join(out), vocab
