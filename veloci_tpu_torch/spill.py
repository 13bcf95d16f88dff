"""External-sort spill sorter for index construction: the port's copy of
``veloci_tpu/spill.py``.

Host-side analogue of the reference's ``BufferedIndexWriter``
(buffered_index_writer/src/lib.rs:123-330): (key, payload) pairs are
buffered, each full chunk is stable-sorted and spilled as a sorted run to a
temp file, and ``finish()`` merges the runs with a streaming binary merge
tree into one sorted memmap stream. Peak RAM is bounded by the chunk size
plus one merge block per side, independent of the total pair count —
the property that lets single-shard builds exceed memory.

Unlike the reference (vint-serialized pairs, k-merge iterators), runs here
are raw little-endian u64 arrays merged with vectorised numpy block merges:
the numpy-idiomatic equivalent of its sort-on-flush + kmerge pipeline.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SpillSorter", "SPILL_PAIRS"]

# pairs beyond this go through the spill sorter (see create._pack_anchor_scores)
SPILL_PAIRS = 64_000_000

_BLOCK = 4_000_000  # merge block size (items per side)


def _merge_blocks(
    ka: np.ndarray, va: np.ndarray, kb: np.ndarray, vb: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Stable in-RAM merge of two sorted key arrays (+payloads); on equal
    keys, A's elements come first."""
    pos_a = np.arange(len(ka), dtype=np.int64) + np.searchsorted(kb, ka, side="left")
    pos_b = np.arange(len(kb), dtype=np.int64) + np.searchsorted(ka, kb, side="right")
    ko = np.empty(len(ka) + len(kb), dtype=np.uint64)
    vo = np.empty_like(ko)
    ko[pos_a] = ka
    ko[pos_b] = kb
    vo[pos_a] = va
    vo[pos_b] = vb
    return ko, vo


class _Run:
    def __init__(self, kpath: str, vpath: str, count: int) -> None:
        self.kpath = kpath
        self.vpath = vpath
        self.count = count

    def open(self) -> Tuple[np.ndarray, np.ndarray]:
        k = np.memmap(self.kpath, dtype=np.uint64, mode="r", shape=(self.count,))
        v = np.memmap(self.vpath, dtype=np.uint64, mode="r", shape=(self.count,))
        return k, v

    def delete(self) -> None:
        for p in (self.kpath, self.vpath):
            try:
                os.unlink(p)
            except OSError:
                pass


class SpillSorter:
    """Stable external sort of (u64 key, u64 payload) pairs.

    Usage::

        with SpillSorter(chunk_items=...) as s:
            s.add(keys, payloads)   # repeatedly, any sizes
            keys, payloads = s.finish()   # sorted; memmap-backed if spilled
            ...use them before the context exits...
    """

    def __init__(
        self, chunk_items: int = 8_000_000, tmp_dir: Optional[str] = None
    ) -> None:
        self.chunk_items = max(int(chunk_items), 1024)
        self._buf_k: List[np.ndarray] = []
        self._buf_v: List[np.ndarray] = []
        self._buffered = 0
        self._runs: List[_Run] = []
        self._tmp: Optional[tempfile.TemporaryDirectory] = None
        self._tmp_base = tmp_dir
        self._run_no = 0

    # --------------------------------------------------------------- context
    def __enter__(self) -> "SpillSorter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for r in self._runs:
            r.delete()
        self._runs = []
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    # ------------------------------------------------------------------ add
    def add(self, keys: np.ndarray, payloads: Optional[np.ndarray] = None) -> None:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if payloads is None:
            payloads = keys  # key-only mode: payload mirrors the key
        payloads = np.ascontiguousarray(payloads, dtype=np.uint64)
        assert len(keys) == len(payloads)
        start = 0
        while start < len(keys):
            take = min(len(keys) - start, self.chunk_items - self._buffered)
            self._buf_k.append(keys[start : start + take])
            self._buf_v.append(payloads[start : start + take])
            self._buffered += take
            start += take
            if self._buffered >= self.chunk_items:
                self._spill()

    def _tmpdir(self) -> str:
        if self._tmp is None:
            self._tmp = tempfile.TemporaryDirectory(
                prefix="veloci_spill_", dir=self._tmp_base
            )
        return self._tmp.name

    def _sorted_buffer(self) -> Tuple[np.ndarray, np.ndarray]:
        k = np.concatenate(self._buf_k) if self._buf_k else np.empty(0, np.uint64)
        v = np.concatenate(self._buf_v) if self._buf_v else np.empty(0, np.uint64)
        self._buf_k, self._buf_v, self._buffered = [], [], 0
        order = np.argsort(k, kind="stable")
        return k[order], v[order]

    def _spill(self) -> None:
        k, v = self._sorted_buffer()
        d = self._tmpdir()
        kpath = os.path.join(d, f"run{self._run_no}.k")
        vpath = os.path.join(d, f"run{self._run_no}.v")
        self._run_no += 1
        k.tofile(kpath)
        v.tofile(vpath)
        self._runs.append(_Run(kpath, vpath, len(k)))

    # --------------------------------------------------------------- finish
    def finish(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted (keys, payloads). Plain arrays if everything fit in one
        chunk; read-only memmaps (valid until close()) otherwise."""
        if not self._runs:
            return self._sorted_buffer()
        if self._buffered:
            self._spill()
        runs = self._runs
        # binary merge tree over ADJACENT runs: earlier-run priority on equal
        # keys is preserved at every level, so the overall sort is stable
        while len(runs) > 1:
            merged: List[_Run] = []
            for i in range(0, len(runs) - 1, 2):
                merged.append(self._merge_runs(runs[i], runs[i + 1]))
            if len(runs) % 2:
                merged.append(runs[-1])
            runs = merged
        self._runs = runs
        return runs[0].open()

    def _merge_runs(self, a: _Run, b: _Run) -> _Run:
        d = self._tmpdir()
        kpath = os.path.join(d, f"run{self._run_no}.k")
        vpath = os.path.join(d, f"run{self._run_no}.v")
        self._run_no += 1
        total = a.count + b.count
        ko = np.memmap(kpath, dtype=np.uint64, mode="w+", shape=(total,))
        vo = np.memmap(vpath, dtype=np.uint64, mode="w+", shape=(total,))
        ka, va = a.open()
        kb, vb = b.open()
        pa = pb = out = 0
        while pa < a.count and pb < b.count:
            blk_a = ka[pa : pa + _BLOCK]
            blk_b = kb[pb : pb + _BLOCK]
            last_a, last_b = blk_a[-1], blk_b[-1]
            # consume everything strictly below the smaller block maximum;
            # the boundary key itself may continue into the next block
            cut = min(last_a, last_b)
            na = int(np.searchsorted(blk_a, cut, side="left"))
            nb = int(np.searchsorted(blk_b, cut, side="left"))
            if na == 0 and nb == 0:
                # both blocks lead with the boundary key: drain the full key
                # run from A (stability: A first), then from B
                for src_k, src_v, pos, count in (
                    (ka, va, pa, a.count),
                    (kb, vb, pb, b.count),
                ):
                    while pos < count and src_k[pos] == cut:
                        blk = src_k[pos : pos + _BLOCK]
                        n = int(np.searchsorted(blk, cut, side="right"))
                        ko[out : out + n] = blk[:n]
                        vo[out : out + n] = src_v[pos : pos + n]
                        out += n
                        pos += n
                    if src_k is ka:
                        pa = pos
                    else:
                        pb = pos
                continue
            mk, mv = _merge_blocks(
                blk_a[:na], va[pa : pa + na], blk_b[:nb], vb[pb : pb + nb]
            )
            ko[out : out + len(mk)] = mk
            vo[out : out + len(mk)] = mv
            out += len(mk)
            pa += na
            pb += nb
        for src_k, src_v, pos, count in ((ka, va, pa, a.count), (kb, vb, pb, b.count)):
            while pos < count:
                n = min(_BLOCK, count - pos)
                ko[out : out + n] = src_k[pos : pos + n]
                vo[out : out + n] = src_v[pos : pos + n]
                out += n
                pos += n
        assert out == total
        ko.flush()
        vo.flush()
        del ko, vo, ka, va, kb, vb
        a.delete()
        b.delete()
        return _Run(kpath, vpath, total)
