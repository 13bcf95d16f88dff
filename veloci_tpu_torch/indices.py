"""Columnar index structures: the port's copy of ``veloci_tpu/indices.py``.

The same flat numpy arrays as the reference package, so an index directory
written by either package loads in the other:

* :class:`Csr` — 1:n map ``key -> [values]`` as ``offsets[num_keys+1]`` +
  ``values[nnz]``.
* :class:`Direct` — 1:1 map with an EMPTY sentinel.
* :class:`AnchorScoreCsr` — the hot search index ``token_id ->
  [(anchor_id, score)]``, scores as u16.
* :class:`PhraseCsr` — sparse-key 1:n map ``(term_a, term_b) -> [anchors]``
  over packed, sorted u64 keys.
* :class:`TermDictionary` — packed sorted term dictionary (term -> id is
  ``bisect``; id -> term is direct indexing; fuzzy matching is a sweep over
  the char matrix, see :mod:`veloci_tpu_torch.ops.levenshtein_sweep`).

Only what the port's builder, reader, field search, filters, phrase boosts
and facets use is copied; the reference's per-key host readers are not.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "EMPTY",
    "Csr",
    "Direct",
    "AnchorScoreCsr",
    "PhraseCsr",
    "TermDictionary",
    "csr_from_pairs",
    "direct_from_pairs",
]

# Sentinel for "no value" in Direct columns. The reference uses 0 with a +1
# value shift (src/indices/direct/create_direct.rs:9-88); we use the max u32.
EMPTY = np.uint32(0xFFFFFFFF)

MAX_TERM_CHARS = 32  # fixed width of the fuzzy-sweep char matrix


@dataclass
class Csr:
    """1:n id -> sorted values (replaces the `.indirect`/`.data` pair)."""

    offsets: np.ndarray  # uint64 [num_keys + 1]
    values: np.ndarray  # uint32 [nnz]

    @property
    def num_keys(self) -> int:
        return len(self.offsets) - 1

    def get_values(self, key: int) -> np.ndarray:
        if key >= self.num_keys or key < 0:
            return np.empty(0, dtype=np.uint32)
        return self.values[self.offsets[key] : self.offsets[key + 1]]

    def has_values(self, key: int) -> bool:
        return 0 <= key < self.num_keys and self.offsets[key] != self.offsets[key + 1]

    def get_values_multi(self, keys: np.ndarray) -> np.ndarray:
        """Gather and concatenate values for many keys (vectorised)."""
        keys = np.asarray(keys, dtype=np.int64)
        keys = keys[(keys >= 0) & (keys < self.num_keys)]
        starts = self.offsets[keys].astype(np.int64)
        counts = self.offsets[keys + 1].astype(np.int64) - starts
        return self.values[_run_positions(starts, counts)]

    def memory_bytes(self) -> int:
        return self.offsets.nbytes + self.values.nbytes


def _run_positions(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The positions of runs ``[start, start + count)``, concatenated."""
    total = int(counts.sum())
    out_starts = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=out_starts[1:])
    idx = np.arange(total, dtype=np.int64)
    seg = np.searchsorted(out_starts[1:], idx, side="right")
    return starts[seg] + (idx - out_starts[seg])


@dataclass
class Direct:
    """1:1 id -> value with EMPTY sentinel (replaces `SingleArrayPacked`)."""

    values: np.ndarray  # uint32 [num_keys]

    @property
    def num_keys(self) -> int:
        return len(self.values)

    def get_value(self, key: int) -> Optional[int]:
        if key < 0 or key >= len(self.values):
            return None
        v = self.values[key]
        return None if v == EMPTY else int(v)

    def get_values(self, key: int) -> np.ndarray:
        v = self.get_value(key)
        if v is None:
            return np.empty(0, dtype=np.uint32)
        return np.array([v], dtype=np.uint32)

    def has_values(self, key: int) -> bool:
        return self.get_value(key) is not None

    def get_values_multi(self, keys: np.ndarray) -> np.ndarray:
        """The values of many keys, absent ones skipped."""
        keys = np.asarray(keys, dtype=np.int64)
        vals = self.values[keys[(keys >= 0) & (keys < len(self.values))]]
        return vals[vals != EMPTY]

    def memory_bytes(self) -> int:
        return self.values.nbytes


@dataclass
class AnchorScoreCsr:
    """token_id -> [(anchor_id, score_u16)] — the hot search index."""

    offsets: np.ndarray  # uint64 [num_tokens + 1]
    anchors: np.ndarray  # uint32 [nnz]
    scores: np.ndarray  # uint16 [nnz] (index-time scores, see calculate_score)

    @property
    def num_keys(self) -> int:
        return len(self.offsets) - 1

    def get_postings(self, token_id: int) -> Tuple[np.ndarray, np.ndarray]:
        """One term's (anchors, u16 scores), empty for an id out of range."""
        if token_id >= self.num_keys or token_id < 0:
            return np.empty(0, dtype=np.uint32), np.empty(0, dtype=np.uint16)
        s, e = self.offsets[token_id], self.offsets[token_id + 1]
        return self.anchors[s:e], self.scores[s:e]

    def memory_bytes(self) -> int:
        return self.offsets.nbytes + self.anchors.nbytes + self.scores.nbytes


@dataclass
class PhraseCsr:
    """(term_a, term_b) -> [anchor ids]; keys packed to sorted u64."""

    keys: np.ndarray  # uint64 [num_pairs], sorted, key = a << 32 | b
    offsets: np.ndarray  # uint64 [num_pairs + 1]
    values: np.ndarray  # uint32 [nnz]

    def get_values(self, pair: Tuple[int, int]) -> Optional[np.ndarray]:
        """The anchors of one (term a, term b) pair, or None for a pair
        not stored."""
        key = (np.uint64(pair[0]) << np.uint64(32)) | np.uint64(pair[1])
        i = np.searchsorted(self.keys, key)
        if i >= len(self.keys) or self.keys[i] != key:
            return None
        return self.values[self.offsets[i] : self.offsets[i + 1]]

    def get_values_for_pairs(self, a_ids: np.ndarray, b_ids: np.ndarray) -> np.ndarray:
        """All anchors for the cross product of term id lists (vectorised)."""
        if len(a_ids) == 0 or len(b_ids) == 0 or len(self.keys) == 0:
            return np.empty(0, dtype=np.uint32)
        a = np.asarray(a_ids, dtype=np.uint64)
        b = np.asarray(b_ids, dtype=np.uint64)
        pair_keys = ((a[:, None] << np.uint64(32)) | b[None, :]).ravel()
        pos = np.minimum(np.searchsorted(self.keys, pair_keys), len(self.keys) - 1)
        hit_pos = pos[self.keys[pos] == pair_keys]
        starts = self.offsets[hit_pos].astype(np.int64)
        counts = self.offsets[hit_pos + 1].astype(np.int64) - starts
        return self.values[_run_positions(starts, counts)]

    def memory_bytes(self) -> int:
        return self.keys.nbytes + self.offsets.nbytes + self.values.nbytes


class TermDictionary:
    """Packed sorted term dictionary (replaces the FST, reference fst 0.4).

    Terms are stored sorted; ``term_id`` equals the term's rank, matching the
    reference's id assignment (`set_ids`, src/create/create_fulltext.rs:71-80).
    A second permutation sorted by *lowercased* term supports case-insensitive
    exact / prefix lookup as contiguous ranges.
    """

    def __init__(self, terms):
        # terms may be a list OR a lazy blob-backed sequence (native builds
        # pass the C++ term blob through untouched — materialising 100k+
        # Python strings is pure build-time overhead; queries force it on
        # first dictionary access)
        self._terms_src = terms
        self._terms: Optional[List[str]] = None
        self._n = len(terms)
        # case-insensitive view built lazily (costs a sort of all terms —
        # only needed once queries arrive, not at build time)
        self._lower_cache = None
        self._char_matrix: Optional[np.ndarray] = None
        self._char_lengths: Optional[np.ndarray] = None

    @property
    def terms(self) -> List[str]:
        if self._terms is None:
            src = self._terms_src
            self._terms = src if isinstance(src, list) else list(src)
            self._terms_src = None
        return self._terms

    def _lower_view(self):
        if self._lower_cache is None:
            lower = [t.lower() for t in self.terms]
            perm = sorted(range(len(self.terms)), key=lambda i: lower[i])
            self._lower_cache = (lower, perm, [lower[i] for i in perm])
        return self._lower_cache

    @property
    def _lower(self):
        return self._lower_view()[0]

    @property
    def lower_perm(self):
        return self._lower_view()[1]

    @property
    def _lower_sorted(self):
        return self._lower_view()[2]

    def __len__(self) -> int:
        return self._n  # does not force materialisation

    # --- exact / prefix lookup -------------------------------------------
    def get(self, term: str) -> Optional[int]:
        i = bisect.bisect_left(self.terms, term)
        if i < len(self.terms) and self.terms[i] == term:
            return i
        return None

    def get_ignore_case(self, term: str) -> List[int]:
        lo = term.lower()
        i = bisect.bisect_left(self._lower_sorted, lo)
        out = []
        while i < len(self._lower_sorted) and self._lower_sorted[i] == lo:
            out.append(self.lower_perm[i])
            i += 1
        return out

    def prefix_range(self, prefix: str, ignore_case: bool = True) -> List[int]:
        """Term ids whose term starts with ``prefix``."""
        return list(self.prefix_range_ids(prefix, ignore_case=ignore_case))

    def prefix_range_ids(self, prefix: str, ignore_case: bool = True) -> np.ndarray:
        """Term ids whose term starts with ``prefix``, sorted ``int64``.

        The sorted-range slice [bisect(p), bisect(p + U+10FFFF)) IS the
        prefix set — any string ordered inside the interval must share the
        prefix (a differing codepoint before the prefix ends would order it
        outside) — so no per-term ``startswith`` verification pass."""
        if ignore_case:
            lo = prefix.lower()
            arr = self._lower_sorted
            i = bisect.bisect_left(arr, lo)
            j = bisect.bisect_right(arr, lo + "\U0010FFFF", lo=i)
            return np.sort(self.lower_perm_np[i:j]).astype(np.int64)
        arr2 = self.terms
        i = bisect.bisect_left(arr2, prefix)
        j = bisect.bisect_right(arr2, prefix + "\U0010FFFF", lo=i)
        return np.arange(i, j, dtype=np.int64)

    @property
    def lower_perm_np(self) -> np.ndarray:
        cached = getattr(self, "_lower_perm_np", None)
        if cached is None:
            cached = self._lower_perm_np = np.asarray(
                self.lower_perm, dtype=np.int64
            )
        return cached

    def char_lengths(self) -> np.ndarray:
        """[n] int32 — TRUE lowercase char count per term (unlike the sweep
        matrix lengths, which zero out terms longer than MAX_TERM_CHARS)."""
        cached = getattr(self, "_true_char_lengths", None)
        if cached is None:
            lower = self._lower
            cached = self._true_char_lengths = np.fromiter(
                (len(t) for t in lower), dtype=np.int32, count=len(lower)
            )
        return cached

    def ord_to_term(self, term_id: int) -> str:
        """id -> term (reference `ord_to_term`, search_field.rs:36-51)."""
        return self.terms[term_id]

    # --- fuzzy sweep support ---------------------------------------------
    def char_matrix(self) -> Tuple[np.ndarray, np.ndarray]:
        """Padded lowercase codepoint matrix for the device Levenshtein sweep.

        Returns ``(chars [N, MAX_TERM_CHARS] uint16, lengths [N] int32)``.
        Codepoints above the BMP are mapped to 0xFFFD (they still compare
        unequal to ASCII/BMP query chars, preserving distances in practice).
        Terms longer than MAX_TERM_CHARS report length 0 and are handled by
        the long-term path of the field search.
        """
        if self._char_matrix is None:
            n = len(self.terms)
            mat = np.zeros((max(n, 1), MAX_TERM_CHARS), dtype=np.uint16)
            lengths = np.zeros(max(n, 1), dtype=np.int32)
            for i, lo in enumerate(self._lower):
                ln = len(lo)
                if ln > MAX_TERM_CHARS:
                    continue  # masked; the long-term path covers these
                lengths[i] = ln
                for j, ch in enumerate(lo):
                    cp = ord(ch)
                    mat[i, j] = cp if cp <= 0xFFFF else 0xFFFD
            self._char_matrix = mat
            self._char_lengths = lengths
        return self._char_matrix, self._char_lengths

    def char_matrix_compact(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sweep matrix with the unsweepable rows dropped:
        ``(chars [M, MAX_TERM_CHARS] u16, lengths [M] i32, ids [M] i32)``
        where ``ids`` maps each row back to its dictionary term id."""
        cached = getattr(self, "_char_matrix_compact", None)
        if cached is None:
            chars, lengths = self.char_matrix()
            keep = np.flatnonzero(lengths > 0)
            cached = (
                np.ascontiguousarray(chars[keep]),
                np.ascontiguousarray(lengths[keep]),
                keep.astype(np.int32),
            )
            self._char_matrix_compact = cached
        return cached

    def long_term_ids(self) -> List[int]:
        """Ids of terms longer (in chars) than MAX_TERM_CHARS (cached)."""
        cached = getattr(self, "_long_ids_cache", None)
        if cached is None:
            cached = [
                i for i, t in enumerate(self.terms) if len(t) > MAX_TERM_CHARS
            ]
            self._long_ids_cache = cached
        return cached

    # --- persistence ------------------------------------------------------
    def to_arrays(self) -> Dict[str, np.ndarray]:
        packed = "\x00".join(self.terms).encode("utf-8")
        data = np.frombuffer(packed, dtype=np.uint8) if packed else np.empty(0, np.uint8)
        return {"term_bytes": data}

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "TermDictionary":
        raw = bytes(arrays["term_bytes"].tobytes())
        terms = raw.decode("utf-8").split("\x00") if raw else []
        return cls(terms)

    def memory_bytes(self) -> int:
        return sum(len(t.encode("utf-8")) + 1 for t in self.terms)


# ---------------------------------------------------------------------------
# Builders: sorted (key, value) pair streams -> packed structures.
# These replace the reference's BufferedIndexWriter external sort + kmerge
# (buffered_index_writer/src/lib.rs) with in-core numpy sorts, spilling
# sorted runs to disk past SPILL_PAIRS (see spill.py).
# ---------------------------------------------------------------------------


def csr_from_pairs(
    keys: np.ndarray,
    values: np.ndarray,
    num_keys: int,
    sort_and_dedup: bool = False,
    stable: bool = True,
) -> Csr:
    """Build a Csr from (key, value) pairs.

    ``stable`` keeps insertion order of values per key (needed for
    text_id_to_token_ids, which must preserve token order — reference
    path_data.rs `new_stable_sorted`).
    """
    keys = np.asarray(keys, dtype=np.int64)
    values = np.asarray(values, dtype=np.uint32)
    if sort_and_dedup:
        if len(keys) and int(keys.max()) < (1 << 31):
            from .spill import SPILL_PAIRS, SpillSorter

            combo = (keys << np.int64(32)) | values.astype(np.int64)
            if len(combo) > SPILL_PAIRS:
                # external sort (reference BufferedIndexWriter semantics)
                with SpillSorter() as sorter:
                    sorter.add(combo.astype(np.uint64))
                    k_s, _ = sorter.finish()
                    keep = np.ones(len(k_s), dtype=bool)
                    keep[1:] = k_s[1:] != k_s[:-1]
                    combo = np.asarray(k_s[keep]).astype(np.int64)
            else:
                # whole pack in C++: combined-key radix sort + pair dedup +
                # offsets in one call (no numpy intermediates)
                from . import native as _native

                packed = _native.pack_csr(
                    keys.astype(np.uint64),  # copy: pack clobbers in place
                    np.array(values, dtype=np.uint32, copy=True),
                    num_keys,
                    sort_and_dedup=True,
                )
                if packed is not None:
                    return Csr(offsets=packed[0], values=np.ascontiguousarray(packed[1]))
                combo = np.ascontiguousarray(combo)
                combo = np.sort(combo)
                combo = combo[np.concatenate([[True], combo[1:] != combo[:-1]])]
            keys = combo >> np.int64(32)
            values = (combo & np.int64(0xFFFFFFFF)).astype(np.uint32)
        else:
            order = np.lexsort((values, keys))
            keys, values = keys[order], values[order]
            if len(keys):
                keep = np.ones(len(keys), dtype=bool)
                keep[1:] = (keys[1:] != keys[:-1]) | (values[1:] != values[:-1])
                keys, values = keys[keep], values[keep]
    else:
        from . import native as _native

        if stable:
            packed = _native.pack_csr(
                keys.astype(np.uint64),  # copy: pack clobbers in place
                np.array(values, dtype=np.uint32, copy=True),
                num_keys,
                sort_and_dedup=False,
            )
            if packed is not None:
                return Csr(offsets=packed[0], values=np.ascontiguousarray(packed[1]))
        order = np.argsort(keys, kind="stable" if stable else "quicksort")
        keys, values = keys[order], values[order]
    counts = np.bincount(keys, minlength=num_keys) if len(keys) else np.zeros(num_keys, np.int64)
    offsets = np.zeros(num_keys + 1, dtype=np.uint64)
    np.cumsum(counts, out=offsets[1:])
    return Csr(offsets=offsets, values=values)


def direct_from_pairs(keys: np.ndarray, values: np.ndarray, num_keys: int) -> Direct:
    """Build a Direct (1:1) column; first value per key wins.

    Reference: `IndexIdToOneParentFlushing` (src/indices/direct/create_direct.rs).
    """
    out = np.full(num_keys, EMPTY, dtype=np.uint32)
    keys = np.asarray(keys, dtype=np.int64)
    values = np.asarray(values, dtype=np.uint32)
    # reversed so that the FIRST pair for a key is the one that sticks
    out[keys[::-1]] = values[::-1]
    return Direct(values=out)
