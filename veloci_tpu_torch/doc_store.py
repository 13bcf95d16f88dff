"""Compressed document store writer: the port's copy of the writer half of
``veloci_tpu/doc_store.py``, writing the same bytes.

Documents are concatenated into ~16 KB blocks, each block compressed
independently, with a block index of ``(first_doc_id, block_start, block_end)``
plus per-block doc offsets, enabling O(log blocks) random access.

Reference: doc_store/src/lib.rs (`DocStoreWriter` 84-166,
FLUSH_THRESHOLD=16384 at :7). Blocks use the native C++ LZ4-style codec
(native/indexer.cpp `vlz`) when available and zlib level 1 otherwise. Each
block records its codec, so blobs mix freely and load anywhere.
"""

from __future__ import annotations

import io
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from .native import lz_available, lz_compress

__all__ = ["DocStoreWriter", "FLUSH_THRESHOLD"]

FLUSH_THRESHOLD = 16_384
_MAGIC = b"VTD2"
_LEVEL = 1
_CODEC_ZLIB = 0
_CODEC_LZ = 1


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
        codec = _CODEC_LZ if lz_available() else _CODEC_ZLIB

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
