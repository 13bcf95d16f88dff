"""Compressed document store: the port's copy of ``veloci_tpu/doc_store.py``'s
writer, writing the same bytes, and of its reader ``DocLoader`` (``:141-208``).

Documents are concatenated into ~16 KB blocks, each block compressed
independently, with a block index of ``(first_doc_id, block_start, block_end)``
plus per-block doc offsets, enabling O(log blocks) random access.

Reference: doc_store/src/lib.rs (`DocStoreWriter` 84-166 / `DocLoader` 11-62,
FLUSH_THRESHOLD=16384 at :7). Blocks use the native C++ LZ4-style codec
(native/indexer.cpp `vlz`) when available and zlib level 1 otherwise;
``VELOCI_DOCSTORE_CODEC`` (``zlib`` or ``lz``) forces one. Each block
records its codec, so blobs mix freely and load anywhere. The loader also
reads the legacy ``VTDS`` blob (zlib blocks, no codec byte) and keeps
``VELOCI_DOCSTORE_CACHE_BLOCKS`` (512) decompressed blocks.
"""

from __future__ import annotations

import io
import os
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

from .error import VelociError
from .native import lz_available, lz_compress, lz_decompress

__all__ = ["DocLoader", "DocStoreWriter", "FLUSH_THRESHOLD", "build_doc_store_native"]

FLUSH_THRESHOLD = 16_384
_MAGIC_V1 = b"VTDS"  # legacy: zlib-only blocks, no codec byte
_MAGIC = b"VTD2"
_LEVEL = 1
_CODEC_ZLIB = 0
_CODEC_LZ = 1
# decompressed blocks kept by a DocLoader, unless VELOCI_DOCSTORE_CACHE_BLOCKS
# says otherwise: 512 x 16 KB = 8 MB
_CACHE_BLOCKS = 512


def _pick_codec() -> int:
    forced = os.environ.get("VELOCI_DOCSTORE_CODEC")
    if forced == "zlib":
        return _CODEC_ZLIB
    if forced == "lz":
        return _CODEC_LZ
    return _CODEC_LZ if lz_available() else _CODEC_ZLIB


class DocStoreWriter:
    """Streaming writer; append docs, then `finish()` -> bytes.

    Blocks are compressed in parallel at `finish()` — both zlib and the
    native codec release the GIL, so a thread pool gets real speedup (the
    reference compresses inline on one thread, doc_store/src/lib.rs:131-149).
    """

    def __init__(self) -> None:
        self.curr_id = 0
        self.bytes_indexed = 0
        self._block: List[bytes] = []
        self._block_bytes = 0
        self._first_id_in_block = 0
        # pending raw blocks: (first_doc_id, num_offsets, payload bytes)
        self._raw_blocks: List[Tuple[int, int, bytes]] = []

    def add_doc(self, doc: str | bytes) -> None:
        """Append one document."""
        self.add_docs((doc,))

    def add_docs(self, docs) -> None:
        """Bulk append — one Python call per ~block instead of per doc."""
        for doc in docs:
            data = doc if isinstance(doc, bytes) else doc.encode("utf-8")
            self.bytes_indexed += len(data)
            if not self._block:
                self._first_id_in_block = self.curr_id
            self._block.append(data)
            self._block_bytes += len(data)
            if self._block_bytes > FLUSH_THRESHOLD:
                self._flush_block()
            self.curr_id += 1

    def _flush_block(self) -> None:
        raw = b"".join(self._block)
        offsets = np.zeros(len(self._block) + 1, dtype=np.uint32)
        np.cumsum([len(b) for b in self._block], out=offsets[1:])
        self._raw_blocks.append(
            (self._first_id_in_block, len(offsets), offsets.tobytes() + raw)
        )
        self._block = []
        self._block_bytes = 0

    def finish(self) -> bytes:
        if self._block:
            self._flush_block()
        codec = _pick_codec()

        def compress_one(payload: bytes) -> Tuple[int, bytes]:
            if codec == _CODEC_LZ:
                comp = lz_compress(payload)
                if comp is not None:
                    return _CODEC_LZ, comp
            return _CODEC_ZLIB, zlib.compress(payload, _LEVEL)

        if len(self._raw_blocks) > 8:
            with ThreadPoolExecutor(max_workers=8) as pool:
                compressed = list(
                    pool.map(lambda b: compress_one(b[2]), self._raw_blocks)
                )
        else:
            compressed = [compress_one(b[2]) for b in self._raw_blocks]

        out = io.BytesIO()
        index_rows = []
        for (first_id, noffsets, payload), (ccodec, comp) in zip(
            self._raw_blocks, compressed
        ):
            start = out.tell()
            out.write(bytes([ccodec]))
            out.write(noffsets.to_bytes(4, "little"))
            out.write(len(payload).to_bytes(4, "little"))
            out.write(comp)
            index_rows.append((first_id, start, out.tell()))
        index = np.array(index_rows, dtype=np.uint64).reshape(-1, 3)
        body = out.getvalue()
        tail = index.tobytes()
        return (
            body
            + tail
            + len(tail).to_bytes(8, "little")
            + self.curr_id.to_bytes(8, "little")
            + _MAGIC
        )


class DocLoader:
    """Random access reader over the bytes produced by DocStoreWriter, with
    a small LRU of decompressed blocks (hit-list fetches cluster but rarely
    share one block). Blocks of either codec read: zlib and the native LZ
    codec (``native.lz_decompress``), and the legacy ``VTDS`` blob's zlib
    blocks."""

    def __init__(self, data: bytes) -> None:
        magic = data[-4:]
        if magic not in (_MAGIC, _MAGIC_V1):
            raise VelociError("not a doc store blob")
        self._v1 = magic == _MAGIC_V1
        self.num_docs = int.from_bytes(data[-12:-4], "little")
        index_size = int.from_bytes(data[-20:-12], "little")
        index_start = len(data) - 20 - index_size
        self._index = np.frombuffer(
            data[index_start : index_start + index_size], dtype=np.uint64
        ).reshape(-1, 3)
        self._data = data
        self._first_ids = self._index[:, 0]
        self._cache: "OrderedDict[int, Tuple[np.ndarray, bytes]]" = OrderedDict()
        self._cache_max = int(os.environ.get("VELOCI_DOCSTORE_CACHE_BLOCKS", _CACHE_BLOCKS))
        # readers on several threads share the LRU: its updates take the lock
        self._cache_lock = threading.Lock()

    def _load_block(self, block: int) -> Tuple[np.ndarray, bytes]:
        with self._cache_lock:
            hit = self._cache.get(block)
            if hit is not None:
                self._cache.move_to_end(block)
                return hit
        _first_id, start, end = (int(x) for x in self._index[block])
        if self._v1:
            noffsets = int.from_bytes(self._data[start : start + 4], "little")
            payload = zlib.decompress(self._data[start + 4 : end])
        else:
            noffsets = int.from_bytes(self._data[start + 1 : start + 5], "little")
            comp = self._data[start + 9 : end]
            if self._data[start] == _CODEC_LZ:
                payload = lz_decompress(comp, int.from_bytes(self._data[start + 5 : start + 9], "little"))
            else:
                payload = zlib.decompress(comp)
        entry = (np.frombuffer(payload[: noffsets * 4], dtype=np.uint32), payload[noffsets * 4 :])
        with self._cache_lock:
            self._cache[block] = entry
            if len(self._cache) > self._cache_max:
                self._cache.popitem(last=False)
        return entry

    def get_doc(self, doc_id: int) -> str:
        if doc_id < 0 or doc_id >= self.num_docs:
            raise IndexError(f"doc id {doc_id} out of range ({self.num_docs} docs)")
        block = int(np.searchsorted(self._first_ids, doc_id, side="right")) - 1
        offsets, raw = self._load_block(block)
        pos = doc_id - int(self._first_ids[block])
        return raw[int(offsets[pos]) : int(offsets[pos + 1])].decode("utf-8")

    def iter_docs(self) -> Iterator[str]:
        """Every document, in id order."""
        for i in range(self.num_docs):
            yield self.get_doc(i)


def build_doc_store_native(data_str: str):
    """The whole document store of an ndjson string in one native pass
    (:func:`.native.doc_store_body`: line split, blocks and LZ in C++),
    byte-equal to :class:`DocStoreWriter`'s with the LZ codec:
    ``(blob, num_docs, bytes_indexed)``, or None without the native
    library or when ``VELOCI_DOCSTORE_CODEC`` forces zlib."""
    if _pick_codec() != _CODEC_LZ:
        return None
    from .native import doc_store_body

    r = doc_store_body(data_str.encode("utf-8"), FLUSH_THRESHOLD)
    if r is None:
        return None
    body, rows, num_docs, bytes_indexed = r
    tail = np.ascontiguousarray(rows, dtype=np.uint64).tobytes()
    blob = body + tail + len(tail).to_bytes(8, "little") + num_docs.to_bytes(8, "little") + _MAGIC
    return blob, num_docs, bytes_indexed
