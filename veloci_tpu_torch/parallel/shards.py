"""Separate indices served as one: bounded-memory builds and a host fan-out.

Counterpart of ``veloci_tpu/parallel/shards.py`` (``shards.py:39-160``):

* :func:`build_sharded` splits an ndjson corpus into K independent indices
  (each a complete index over a contiguous range of documents), so a
  build's memory is bounded by the shard size, not the corpus;
* :class:`ShardedPersistence` serves the list as one index: a search fans
  out over the shards (:func:`..search.executor.search` on each), anchor
  ids lift by the shard's document base, the top-k merges by (score desc,
  global id desc), facet counts add up, and a document read goes to the
  shard that holds it.

Each shard is a :class:`..persistence.TorchIndex` on its own device, so
shards may sit on different cards; the in-index document sharding is
:mod:`.sharding`'s. Index-time scores carry a term-occurrence modifier
computed per shard, so shard-local term statistics can drift from one
index's global ones on skewed corpora.

This module is an entry point of its own, for a caller that builds or
loads such a list; nothing in the port's search calls it, and the parity
tests hold it to the reference's cases.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List, Optional, Tuple

import numpy as np

from ..persistence import Persistence, TorchIndex, load_index
from ..query.request import Request
from ..search.executor import search as _search
from ..search.result import Hit, SearchResult

__all__ = ["build_sharded", "ShardedPersistence"]


def build_sharded(lines: Iterable[str], indices: str = "{}", *, shard_size: int = 1_000_000,
                  target_dir: Optional[str] = None, device=None) -> "ShardedPersistence":
    """Build one index per ``shard_size`` documents of an ndjson line
    stream, each on ``device`` (the default device when None); with
    ``target_dir`` each is saved to ``shard_NNNN`` there and read back."""
    shards: List[TorchIndex] = []
    buf: List[str] = []

    def flush():
        if not buf:
            return
        idx = len(shards)
        pers = Persistence.create_from_str("\n".join(buf), indices)
        if target_dir is not None:
            d = str(Path(target_dir) / f"shard_{idx:04d}")
            pers.save(d)
            pers = Persistence.load(d)
        shards.append(TorchIndex.from_persistence(pers, device))
        buf.clear()

    for line in lines:
        if not line.strip():
            continue
        buf.append(line.rstrip("\n"))
        if len(buf) >= shard_size:
            flush()
    flush()
    return ShardedPersistence(shards)


class ShardedPersistence:
    """Search over a list of indices as one logical index."""

    def __init__(self, shards: List[TorchIndex]):
        if not shards:
            raise ValueError("at least one shard required")
        self.shards = shards
        self.doc_bases = np.zeros(len(shards) + 1, dtype=np.int64)
        np.cumsum([s.num_docs for s in shards], out=self.doc_bases[1:])
        self.num_docs = int(self.doc_bases[-1])
        self.bytes_indexed = sum(s.num_docs and s.bytes_indexed for s in shards)

    @classmethod
    def load(cls, directory: str, device=None) -> "ShardedPersistence":
        """The ``shard_*`` indices of ``directory``, in name order."""
        shard_dirs = sorted(p for p in Path(directory).iterdir() if p.name.startswith("shard_"))
        return cls([load_index(str(p), device) for p in shard_dirs])

    def get_all_fields(self) -> List[str]:
        fields: List[str] = []
        for s in self.shards:
            fields.extend(f for f in s.get_all_fields() if f not in fields)
        return fields

    def search(self, request: Request) -> SearchResult:
        """Fan out, lift ids, merge the top-k by (score desc, global id
        desc). Each shard answers ``top + skip`` hits on a thread of its
        own (the reference's vestigial ``Shards``, rocket_server.rs:102-108);
        device work and numpy release the GIL."""
        top = request.top if request.top is not None else 10
        skip = request.skip or 0

        def run_shard(shard):
            sub = Request(**{**request.__dict__})
            sub.top = top + skip  # enough to cover the global window
            sub.skip = None
            return _search(sub, shard)

        if len(self.shards) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(self.shards))) as pool:
                shard_results = list(pool.map(run_shard, self.shards))
        else:
            shard_results = [run_shard(s) for s in self.shards]

        merged = SearchResult()
        all_hits: List[Tuple[float, int]] = []
        facet_acc: dict = {}
        for si, res in enumerate(shard_results):
            base = int(self.doc_bases[si])
            merged.num_hits += res.num_hits
            all_hits.extend((h.score, base + h.id) for h in res.data)
            for field, counts in (res.facets or {}).items():
                acc = facet_acc.setdefault(field, {})
                for text, c in counts:
                    acc[text] = acc.get(text, 0) + c
            for path, texts in res.why_found_terms.items():
                dst = merged.why_found_terms.setdefault(path, [])
                dst.extend(t for t in texts if t not in dst)
        all_hits.sort(key=lambda el: (-el[0], -el[1]))
        merged.data = [Hit(gid, score) for score, gid in all_hits[skip : skip + top]]
        if facet_acc:
            limit = request.facets[0].top if request.facets else None
            merged.facets = {field: sorted(acc.items(), key=lambda el: -el[1])[:limit]
                             for field, acc in facet_acc.items()}
        return merged

    def shard_of(self, global_id: int) -> Tuple[TorchIndex, int]:
        si = int(np.searchsorted(self.doc_bases, global_id, side="right")) - 1
        return self.shards[si], global_id - int(self.doc_bases[si])

    def get_doc(self, global_id: int) -> str:
        shard, local = self.shard_of(global_id)
        return shard.doc_loader.get_doc(local)
