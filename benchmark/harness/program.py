"""The program's set-up: the port's index built from the corpus, or read
from the kept copy, then uploaded and warmed up.

A configuration with ``"index": "built"`` builds its index in every run
(the corpus depends on the seed); one with ``"index": "kept"`` builds it
in the first run of a checkout and keeps it in ``benchmark/cache/``, under a
key of the configuration, the corpus generator and the port's
index-writing sources, so that any change to them builds it again.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .spec import BENCH_DIR, ROOT

CACHE_DIR = BENCH_DIR / "cache"
MANIFEST = "metaData.json"  # the file an index directory writes last
# the port's sources that decide the bytes of a saved index
INDEX_SOURCES = (
    "veloci_tpu_torch/create.py",
    "veloci_tpu_torch/create_native.py",
    "veloci_tpu_torch/native.py",
    "native/indexer.cpp",
    "veloci_tpu_torch/doc_store.py",
    "veloci_tpu_torch/persistence.py",
    "veloci_tpu_torch/indices.py",
    "veloci_tpu_torch/config.py",
    "veloci_tpu_torch/tokenizer.py",
    "veloci_tpu_torch/json_flatten.py",
    "veloci_tpu_torch/spill.py",
)


def cache_key(config: dict, corpus_path: Path, root: Path = ROOT, sources=INDEX_SOURCES) -> str:
    """A hash of the configuration (as run), the corpus generator and the
    port's index-writing sources (a missing source hashes as missing)."""
    h = hashlib.sha256(json.dumps(config, sort_keys=True).encode() + b"\0")
    for path in (corpus_path, *(root / s for s in sources)):
        h.update(str(Path(path).name).encode() + b"\0")
        h.update(Path(path).read_bytes() if Path(path).is_file() else b"missing")
        h.update(b"\0")
    return h.hexdigest()[:16]


@dataclass
class Setup:
    """The program ready for traffic, and what its set-up took."""

    index: object
    seconds: dict = field(default_factory=dict)  # phase -> s: import, corpus, index_build, upload, warmup
    index_dir: Optional[Path] = None
    cache_hit: Optional[bool] = None
    tmp: Optional[tempfile.TemporaryDirectory] = None
    vt: object = None  # the port's package

    def close(self) -> None:
        self.index = None
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def set_up(config: dict, corpus, seed: int, device: str, cache_dir: Path = CACHE_DIR) -> Setup:
    """Import the port, make or read its index and upload it to ``device``."""
    t = time.perf_counter()
    import veloci_tpu_torch as vt
    from veloci_tpu_torch.persistence import Persistence, load_index

    seconds = {"import": time.perf_counter() - t}
    params = config["corpus"]
    index_config = json.dumps(config.get("index_config") or {})
    out = Setup(index=None, seconds=seconds)

    def build(target: Path) -> None:
        t = time.perf_counter()
        data = corpus.ndjson(params, seed)
        seconds["corpus"] = time.perf_counter() - t
        t = time.perf_counter()
        Persistence.create_from_str(data, index_config).save(str(target))
        seconds["index_build"] = time.perf_counter() - t

    if config.get("index", "built") == "kept":
        key = cache_key(config, Path(corpus.__file__))
        target = cache_dir / f"{config['name']}-{key}"
        out.cache_hit = (target / MANIFEST).is_file()
        if not out.cache_hit:
            partial = cache_dir / f"{config['name']}-{key}.building"
            shutil.rmtree(partial, ignore_errors=True)
            partial.mkdir(parents=True)
            build(partial)
            shutil.rmtree(target, ignore_errors=True)
            os.replace(partial, target)
        out.index_dir = target
    else:
        out.tmp = tempfile.TemporaryDirectory(prefix="veloci-bench-")
        out.index_dir = Path(out.tmp.name) / "index"
        build(out.index_dir)
    t = time.perf_counter()
    out.index = load_index(str(out.index_dir), device)
    _sync(device)
    seconds["upload"] = time.perf_counter() - t
    t = time.perf_counter()
    out.index.warmup()
    _sync(device)
    seconds["warmup"] = time.perf_counter() - t
    out.vt = vt
    return out
