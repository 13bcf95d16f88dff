"""The index on one device: sweep matrices and the combined posting CSR.

Counterpart of ``DeviceField`` and ``Persistence.device_combined``
(``veloci_tpu/persistence.py:111-393, 677-750, 784-878``) and of the
directory reader ``Persistence.load`` (``:553-598``). The host structures
(term dictionaries, CSR columns) are the reference package's own classes,
reached through :mod:`veloci_tpu_torch._host`; nothing here imports JAX.

Lengths are runtime values: the device arrays carry no tile padding and no
slice-window tail padding, because the port's kernels and reads bound
themselves.
"""

from __future__ import annotations

import json
from collections import Counter
from pathlib import Path
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _host

__all__ = [
    "FieldSweep", "LongTerms", "TorchIndex", "long_term_rows", "read_persistence", "load_index",
]

_MANIFEST = "metaData.json"
_DOCSTORE = "docs.bin"
# code points kept per long term: the host distance is 255 for a term of
# 255 chars or more (``levenshtein_distance_host``), so 254 cover the rest
LONG_WIDTH = 254


class FieldSweep(NamedTuple):
    """One field's fuzzy-sweep matrix on the device."""

    chars_t: torch.Tensor  # [32, M] uint16, lowercase codepoints, transposed
    lengths: torch.Tensor  # [M] int32 (0 = pad row, never matches)
    sweep_ids: torch.Tensor  # [M] int32 row -> dictionary term id (-1 = pad)


class LongTerms(NamedTuple):
    """One field's terms longer than the sweep matrix, lowercased."""

    prefixes: FieldSweep  # their first 32 chars; sweep_ids are row numbers
    codes: torch.Tensor  # [L, W] int32 code points, -1 past each term's end
    lengths: torch.Tensor  # [L] int32 char counts
    host_lengths: np.ndarray  # the same, on the host
    ids: np.ndarray  # [L] int64 row -> dictionary term id


def long_term_rows(dictionary):
    """The terms longer than the sweep matrix (``dictionary.long_term_ids()``),
    lowercased: ``(chars [L, 32] uint16, lengths32 [L] int32, codes [L, W]
    int32, lengths [L] int32, ids [L] int64)``.

    ``chars`` holds each term's first 32 chars in the sweep matrix's
    encoding: every prefix of at most 32 chars of a term is a prefix of its
    row, so a ``starts_with`` query with ``len + distance <= 32`` finds all
    its long matches among the rows whose prefix distance is within range.
    ``codes`` holds the exact code points of the first ``W`` chars, ``W``
    the longest term's length capped at ``LONG_WIDTH``."""
    ids = np.asarray(dictionary.long_term_ids(), dtype=np.int64)
    lows = [dictionary.terms[t].lower() for t in ids]
    lengths = np.fromiter(map(len, lows), dtype=np.int32, count=len(lows))
    width = max(32, min(int(lengths.max(initial=0)), LONG_WIDTH))
    codes = np.full((len(ids), width), -1, dtype=np.int32)
    for row, lo in enumerate(lows):
        cps = np.frombuffer(lo[:width].encode("utf-32-le"), dtype=np.int32)
        codes[row, : len(cps)] = cps
    first = codes[:, :32]
    chars = np.where(first < 0, 0, np.where(first > 0xFFFF, 0xFFFD, first)).astype(np.uint16)
    return chars, np.minimum(lengths, 32), codes, lengths, ids


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested, but torch.cuda.is_available() is False"
        )
    return dev


class TorchIndex:
    """An index on one torch device: per-field sweep matrices and the
    combined global-key posting CSR (``key_base[field] + term id``), with
    the host term dictionaries the field search reads."""

    def __init__(
        self, *, num_docs, dictionaries, fields, long_terms, host_offsets, offsets,
        packed, key_base, device, persistence=None,
    ) -> None:
        self.device = device
        self.persistence = persistence  # the host Persistence, for the query generator
        self.num_docs = int(num_docs)
        self.dictionaries = dictionaries  # field -> TermDictionary
        self.fields: Dict[str, FieldSweep] = fields
        self.long_terms: Dict[str, LongTerms] = long_terms  # see long_term_rows
        self.host_offsets = host_offsets  # [num_keys + 2] int64, host
        self.offsets = offsets  # the same, on the device
        self.packed = packed  # [nnz, 2] int32 (anchor, f32 bits of score/100)
        self.key_base = key_base  # field -> (base, num_keys)
        self.path_counts: Counter = Counter()  # requests answered per route
        self.gathered_rows: Counter = Counter()  # posting rows read per route

    @classmethod
    def from_reference_arrays(
        cls, *, num_docs, dictionaries, fields, offsets, anchors, scores, key_base,
        device, persistence=None,
    ) -> "TorchIndex":
        """Build the index on ``device`` from the reference package's host
        arrays: ``fields`` maps each field to ``(chars [M, 32] uint16,
        lengths [M] int32, sweep_ids [M] int32)`` (``DeviceField``'s
        ``_chars_host``, ``_lengths_host``, ``_sweep_ids_host``, or
        ``TermDictionary.char_matrix_compact()``); ``offsets``, ``anchors``,
        ``scores`` and ``key_base`` are ``Persistence.combined_host_csr()``'s
        (scores as the raw u16 x100 values); ``persistence``, the host
        ``Persistence``, answers the query generator's field questions."""
        dev = _device(device)

        def up(arr, dtype):
            return torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype)).to(dev)

        def sweep(chars, lengths, sweep_ids):
            return FieldSweep(
                up(np.asarray(chars).T, np.uint16), up(lengths, np.int32), up(sweep_ids, np.int32)
            )

        def long(chars, lengths32, codes, lengths, ids):
            rows = np.arange(len(ids), dtype=np.int32)
            return LongTerms(
                sweep(chars, lengths32, rows), up(codes, np.int32), up(lengths, np.int32),
                lengths, ids,
            )

        sweeps = {f: sweep(*arrays) for f, arrays in fields.items()}
        long_terms = {f: long(*long_term_rows(d)) for f, d in dictionaries.items()}
        host_offsets = np.asarray(offsets, dtype=np.int64)
        scores01 = np.asarray(scores).astype(np.float32) / np.float32(100.0)
        packed = np.stack(
            [np.asarray(anchors).astype(np.int32), scores01.view(np.int32)], axis=1
        )
        return cls(
            num_docs=num_docs, dictionaries=dictionaries, fields=sweeps,
            long_terms=long_terms, host_offsets=host_offsets, offsets=up(host_offsets, np.int64),
            packed=up(packed, np.int32), key_base=dict(key_base), device=dev,
            persistence=persistence,
        )

    @classmethod
    def from_persistence(cls, pers, device) -> "TorchIndex":
        """Upload a host ``Persistence`` (built or read, never device-loaded)."""
        comb = pers.combined_host_csr()
        if comb is None:
            offsets = np.zeros(2, np.int64)
            anchors, scores, key_base = np.zeros(0, np.int32), np.zeros(0, np.uint16), {}
        else:
            ns, key_base = comb
            offsets, anchors, scores = ns.offsets, ns.anchors, ns.scores
        return cls.from_reference_arrays(
            num_docs=pers.num_docs,
            dictionaries=dict(pers.dictionaries),
            fields={f: d.char_matrix_compact() for f, d in pers.dictionaries.items()},
            offsets=offsets, anchors=anchors, scores=scores, key_base=key_base,
            device=device, persistence=pers,
        )

    def get_all_fields(self):
        """The index's columns (``search_query`` expands terms over them)."""
        return self.persistence.get_all_fields()

    def has_token_to_anchor(self, path: str) -> bool:
        """Whether ``path`` has postings (``search_query``'s field filter)."""
        return self.persistence.has_token_to_anchor(path)

    def get_dictionary(self, field: str):
        dictionary = self.dictionaries.get(field)
        if dictionary is None:
            raise _host.error.FstNotFoundError(field)
        return dictionary


def read_persistence(directory):
    """Read an index directory into a host ``Persistence`` (mmap-backed
    arrays), as ``Persistence.load`` does but without its JAX set-up."""
    idx = _host.indices
    d = Path(directory)
    manifest = json.loads((d / _MANIFEST).read_text())
    p = _host.persistence.Persistence()
    p.path = str(d)
    p.num_docs = manifest["num_docs"]
    p.bytes_indexed = manifest["bytes_indexed"]
    p.columns = manifest["columns"]

    def arr(name: str) -> np.ndarray:
        return np.load(d / (_host.persistence._enc(name) + ".npy"), mmap_mode="r")

    for path, kind in manifest["store_kinds"].items():
        if kind == "direct":
            p.key_value_stores[path] = idx.Direct(values=arr(path + "#direct"))
        elif kind == "csr":
            p.key_value_stores[path] = idx.Csr(
                offsets=arr(path + "#offsets"), values=arr(path + "#values")
            )
        elif kind == "anchor_score":
            p.anchor_scores[path] = idx.AnchorScoreCsr(
                offsets=arr(path + "#offsets"), anchors=arr(path + "#anchors"),
                scores=arr(path + "#scores"),
            )
        elif kind == "phrase":
            p.phrase_indices[path] = idx.PhraseCsr(
                keys=arr(path + "#keys"), offsets=arr(path + "#offsets"),
                values=arr(path + "#values"),
            )
        elif kind == "boost":
            p.boost_stores[path] = (arr(path + "#bvalues"), arr(path + "#bpresent"))
    for f in d.glob("*%23terms.npy"):
        field = _host.persistence._dec(f.name[: -len(".npy")])[: -len("#terms")]
        p.dictionaries[field] = idx.TermDictionary.from_arrays({"term_bytes": np.load(f)})
    docs = d / _DOCSTORE
    if docs.exists():
        p.doc_store_bytes = docs.read_bytes()
    return p


def load_index(directory, device) -> TorchIndex:
    """Read an index directory and upload it to ``device``."""
    return TorchIndex.from_persistence(read_persistence(directory), device)
