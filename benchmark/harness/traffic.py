"""The one traffic generator: requests from a mix's parameters and a seed.

A mix (``traffic/<name>.json``) is data:

* ``loop``: ``"batch"`` (one client sends ``batch`` requests at a time
  through ``search_batch`` and waits for them) or ``"lone"`` (one client
  sends one request at a time through ``search``), both closed;
* ``top``: the hits each request asks for;
* ``tree``: ``"leaf"`` (one term on one field) or ``"words"`` (an ``and`` or
  ``or``, one of ``ops``, of ``words`` distinct words, each an OR of one
  leaf a field of ``fields``);
* ``draw``: how words are drawn: ``"corpus"`` (a field of ``fields``, then a
  word with the corpus's own weights), ``"pairs"`` (uniformly over every
  (word, field) of ``fields``) or ``"uniform"`` (uniformly over the words of
  ``fields``);
* ``edits``: ``[[edits, weight], ...]``: random edits made to a leaf's word,
  which the leaf then searches at that Levenshtein distance (0: exact);
* ``warmup_units``: batches or requests answered before the window;
* ``check_share``: the share of the window's requests the reference checks,
  drawn from the seed.

The same seed gives the same requests in the same order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

WINDOW, WARMUP, CHECK = 0, 1, 2  # the streams drawn from one seed
_EDIT_CHARS = "abcdefgh0123456789"


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def mutate(word: str, draws) -> str:
    """``len(draws)`` random substitutions, insertions or deletions, each
    read from three uniform draws in [0, 1): the edit, the character, the
    place (a word of two characters or fewer is not shortened)."""
    w = list(word)
    for u_op, u_ch, u_at in draws:
        op = int(u_op * 3)
        ch = _EDIT_CHARS[int(u_ch * len(_EDIT_CHARS))]
        if op == 1:
            w.insert(int(u_at * (len(w) + 1)), ch)
        elif op == 0 or len(w) <= 2:
            w[int(u_at * len(w))] = ch
        else:
            del w[int(u_at * len(w))]
    return "".join(w)


class Stream:
    """An endless stream of request dicts for one mix and seed."""

    def __init__(self, mix: dict, words: Dict[str, tuple], seed: int, stream: int = WINDOW):
        self.mix = mix
        self.rng = rng_for(seed, stream)
        self.fields = list(mix["fields"])
        self.words = {f: ([str(w) for w in words[f][0]], np.asarray(words[f][1], dtype=np.float64))
                      for f in self.fields if f in words}
        self.pairs = [(w, f) for f in self.fields if f in self.words for w in self.words[f][0]]
        self.union = sorted({w for w, _f in self.pairs})
        edits = mix.get("edits", [[0, 1.0]])
        self.edits = np.array([e for e, _w in edits], dtype=np.int64)
        self.edit_p = np.array([w for _e, w in edits], dtype=np.float64)
        self.edit_cdf = np.cumsum(self.edit_p / self.edit_p.sum())
        self.cdf = {f: np.cumsum(p / p.sum()) for f, (_w, p) in self.words.items()}
        self.unit = int(mix["batch"]) if mix["loop"] == "batch" else 1

    def _leaves(self, k: int) -> List[dict]:
        draw, rng = self.mix["draw"], self.rng
        if draw == "corpus":
            fi = rng.integers(len(self.fields), size=k)
            at = np.empty(k, np.int64)
            u = rng.random(k)
            for j, f in enumerate(self.fields):
                sel = fi == j
                at[sel] = np.searchsorted(self.cdf[f], u[sel], side="right").clip(max=len(self.cdf[f]) - 1)
            picks = [(self.words[self.fields[j]][0][i], self.fields[j]) for j, i in zip(fi.tolist(), at.tolist())]
        elif draw == "pairs":
            picks = [self.pairs[i] for i in rng.integers(len(self.pairs), size=k)]
        else:
            raise ValueError(f"draw {draw!r} does not make one leaf")
        edits = self.edits[np.searchsorted(self.edit_cdf, rng.random(k), side="right").clip(max=len(self.edits) - 1)]
        draws = rng.random((k, int(self.edits.max()), 3)).tolist()
        out = []
        for (word, field), e, d in zip(picks, edits.tolist(), draws):
            leaf = {"terms": [mutate(word, d[:e]) if e else word], "path": field}
            if e:
                leaf["levenshtein_distance"] = e
            out.append({"search": leaf})
        return out

    def _words(self) -> dict:
        if self.mix["draw"] != "uniform":
            raise ValueError("a words tree draws its words uniformly")
        picked = self.rng.choice(len(self.union), size=int(self.mix["words"]), replace=False)
        op = self.mix["ops"][int(self.rng.integers(len(self.mix["ops"])))]
        return {op: {"queries": [
            {"or": {"queries": [{"search": {"terms": [self.union[int(i)]], "path": f}} for f in self.fields]}}
            for i in picked
        ]}}

    def next_unit(self) -> List[dict]:
        """The next batch (``batch`` loop) or request (``lone`` loop)."""
        if self.mix["tree"] == "leaf":
            trees = self._leaves(self.unit)
        else:
            trees = [self._words() for _ in range(self.unit)]
        top = int(self.mix["top"])
        return [{"search_req": t, "top": top} for t in trees]


def check_mask(seed: int, share: float, size: int = 1 << 22) -> np.ndarray:
    """Which of the window's first ``size`` requests the reference checks."""
    if share >= 1.0:
        return np.ones(size, dtype=bool)
    return rng_for(seed, CHECK).random(size) < share
