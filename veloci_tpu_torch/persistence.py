"""The index on the host and on one device.

:class:`Persistence` is the host half of ``veloci_tpu/persistence.py``
(``Persistence.from_built``, ``save``, the directory reader ``load`` and the
accessors the query generator calls, ``:396-670``, and
``combined_host_csr``, ``:784-834``): the same index directory format, so
either package reads what the other wrote. :class:`TorchIndex` is the
counterpart of ``DeviceField``, ``Persistence.device_combined`` and
``device_boost`` (``:111-393, 677-750, 764-782, 835-878``): the sweep
matrices, the combined posting CSR and, on first use, the boost columns on
one torch device, beside the host relation stores that filters, phrase
boosts and facets read.

A Persistence answers the reference's own call, ``search(request,
persistence)``: every entry point turns it into its upload with
:func:`as_index`, on the default device (:func:`set_default_device`, the
card unless a caller asks for the CPU). The reference's HBM layout
(``DeviceField``, ``device_field`` / ``device_combined`` /
``device_boost`` on the Persistence, the capacity ladders) is not copied
by name: the upload is a :class:`TorchIndex`.

Lengths are runtime values: the device arrays carry no tile padding and no
slice-window tail padding, because the port's kernels and reads bound
themselves.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.parse
from collections import Counter
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .create import TEXTINDEX, TO_ANCHOR_ID_SCORE, BuiltIndex, create_indices_from_str
from .doc_store import DocLoader
from .error import FstNotFoundError, VelociError
from .indices import AnchorScoreCsr, Csr, Direct, PhraseCsr, TermDictionary
from .ops.postings import dense_max_row_score

__all__ = [
    "FieldSweep", "LongTerms", "Persistence", "RegexRows", "TorchIndex", "as_index", "default_device",
    "long_term_rows", "load_index", "regex_flags", "set_default_device",
]

_MANIFEST = "metaData.json"
_DOCSTORE = "docs.bin"
# code points kept per long term: the host distance is 255 for a term of
# 255 chars or more (``levenshtein_distance_host``), so 254 cover the rest
LONG_WIDTH = 254
_SCORE_SUFFIX = TEXTINDEX + TO_ANCHOR_ID_SCORE


def _enc(name: str) -> str:
    return urllib.parse.quote(name, safe="")


def _dec(name: str) -> str:
    return urllib.parse.unquote(name)


def _strip_textindex(field: str) -> str:
    return field[: -len(TEXTINDEX)] if field.endswith(TEXTINDEX) else field


class _HostStores:
    """The reads of an index's host stores that a :class:`Persistence` and
    a :class:`TorchIndex` serve alike (``persistence.py:601-668``): column
    metadata, term dictionaries, key-value relations, phrase pairs, boost
    columns and the document store."""

    columns: Dict[str, dict]
    dictionaries: Dict[str, TermDictionary]
    key_value_stores: Dict[str, Csr | Direct]
    phrase_indices: Dict[str, PhraseCsr]
    boost_stores: Dict[str, Tuple[np.ndarray, np.ndarray]]
    doc_store_bytes: Optional[bytes]
    _doc_loader: Optional[DocLoader]

    def get_all_fields(self) -> List[str]:
        """The index's columns (``search_query`` expands terms over them)."""
        return list(self.columns.keys())

    def get_dictionary(self, field: str) -> TermDictionary:
        dictionary = self.dictionaries.get(_strip_textindex(field))
        if dictionary is None:
            raise FstNotFoundError(field)
        return dictionary

    def has_index(self, path: str) -> bool:
        """Whether ``path`` names a store (each class answers
        ``has_token_to_anchor`` for the postings)."""
        return (
            path in self.key_value_stores
            or path in self.phrase_indices
            or path in self.boost_stores
            or self.has_token_to_anchor(path)
        )

    def tokenize_enabled(self, field: str) -> bool:
        col = self.columns.get(_strip_textindex(field))
        return bool(col and col["textindex_metadata"]["options"].get("tokenize", False))

    def is_anchor_identity_column(self, field: str) -> bool:
        col = self.columns.get(_strip_textindex(field))
        return bool(col and col.get("is_anchor_identity_column"))

    def get_valueid_to_parent(self, path: str):
        """A key-value store by its path (``GET /<db>/inspect``)."""
        store = self.key_value_stores.get(path)
        if store is None:
            raise VelociError(f"index not found: {path!r}")
        return store

    def get_boost(self, path: str) -> Tuple[np.ndarray, np.ndarray]:
        store = self.boost_stores.get(path)
        if store is None:
            raise VelociError(f"boost index not found: {path!r}")
        return store

    def num_text_ids(self, field: str) -> int:
        return int(self.columns[_strip_textindex(field)]["textindex_metadata"]["num_text_ids"])

    @property
    def doc_loader(self) -> DocLoader:
        """The document store's reader, made at first use
        (``persistence.py:647``)."""
        if self._doc_loader is None:
            if self.doc_store_bytes is None:
                raise VelociError("no document store")
            self._doc_loader = DocLoader(self.doc_store_bytes)
        return self._doc_loader


class Persistence(_HostStores):
    """An index on the host: metadata, term dictionaries and the packed
    columns, as a build leaves them or as an index directory holds them.

    It answers searches too: every entry point that takes an index takes a
    Persistence and searches its upload (:meth:`index`), made on first use
    on the default device (:func:`set_default_device`) and kept until a
    write to the Persistence (:func:`.create.add_token_values_to_tokens`)
    drops it (:meth:`invalidate_device_cache`)."""

    def __init__(self) -> None:
        self.num_docs: int = 0
        self.bytes_indexed: int = 0
        self.columns: Dict[str, dict] = {}
        self.dictionaries: Dict[str, TermDictionary] = {}
        self.key_value_stores: Dict[str, Csr | Direct] = {}
        self.anchor_scores: Dict[str, AnchorScoreCsr] = {}
        self.phrase_indices: Dict[str, PhraseCsr] = {}
        self.boost_stores: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.doc_store_bytes: Optional[bytes] = None
        self.path: Optional[str] = None
        self._doc_loader: Optional[DocLoader] = None
        self._index: Optional["TorchIndex"] = None  # the upload, made by index()
        self._index_lock = threading.Lock()  # server threads share one upload

    @classmethod
    def create_from_str(cls, data_str: str, indices: str = "{}", *, line_delimited: bool = True) -> "Persistence":
        """Build an index from ndjson (or, with ``line_delimited=False``,
        any JSON) and a TOML/JSON fields config (``create_from_str``,
        ``persistence.py:441``)."""
        return cls.from_built(create_indices_from_str(data_str, indices, line_delimited=line_delimited))

    @classmethod
    def create_im(cls, data_str: str, indices: str = "{}") -> "Persistence":
        """In-memory build (reference Persistence::create_im,
        persistence.rs:368-380)."""
        return cls.create_from_str(data_str, indices)

    @classmethod
    def create_mmap(cls, directory: str, data_str: str, indices: str = "{}") -> "Persistence":
        """Build, save to ``directory`` and read back through mmap
        (reference Persistence::create_mmap + load, persistence.rs:382-410)."""
        cls.create_from_str(data_str, indices).save(directory)
        return cls.load(directory)

    @classmethod
    def create_from_file(cls, data_path: str, indices: str = "{}") -> "Persistence":
        """Build from an ndjson file (reference
        create::create_indices_from_file, create.rs:935-941)."""
        return cls.create_from_str(Path(data_path).read_text(), indices)

    @classmethod
    def from_built(cls, built: BuiltIndex) -> "Persistence":
        p = cls()
        p.num_docs = built.num_docs
        p.bytes_indexed = built.bytes_indexed
        p.columns = built.columns
        p.dictionaries = built.dictionaries
        p.key_value_stores = built.key_value_stores
        p.anchor_scores = built.anchor_scores
        p.phrase_indices = built.phrase_indices
        p.boost_stores = built.boost_stores
        p.doc_store_bytes = built.doc_store
        return p

    def save(self, directory: str) -> None:
        """Write the index directory; manifest written last (atomic-ish)."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        if self.doc_store_bytes is not None:
            (d / _DOCSTORE).write_bytes(self.doc_store_bytes)

        def save_arr(name: str, arr: np.ndarray) -> None:
            np.save(d / (_enc(name) + ".npy"), arr)

        store_kinds: Dict[str, str] = {}
        for path, store in self.key_value_stores.items():
            if isinstance(store, Direct):
                store_kinds[path] = "direct"
                save_arr(path + "#direct", store.values)
            else:
                store_kinds[path] = "csr"
                save_arr(path + "#offsets", store.offsets)
                save_arr(path + "#values", store.values)
        for path, store in self.anchor_scores.items():
            store_kinds[path] = "anchor_score"
            save_arr(path + "#offsets", store.offsets)
            save_arr(path + "#anchors", store.anchors)
            save_arr(path + "#scores", store.scores)
        for path, store in self.phrase_indices.items():
            store_kinds[path] = "phrase"
            save_arr(path + "#keys", store.keys)
            save_arr(path + "#offsets", store.offsets)
            save_arr(path + "#values", store.values)
        for path, (vals, present) in self.boost_stores.items():
            store_kinds[path] = "boost"
            save_arr(path + "#bvalues", vals)
            save_arr(path + "#bpresent", present)
        for field, dictionary in self.dictionaries.items():
            save_arr(field + "#terms", dictionary.to_arrays()["term_bytes"])

        manifest = {
            "num_docs": self.num_docs,
            "bytes_indexed": self.bytes_indexed,
            "columns": self.columns,
            "store_kinds": store_kinds,
        }
        # durability: fsync every index file, then the manifest, then the
        # directory entry — the manifest only becomes visible once all data
        # it references is on disk (reference sync_directory, create.rs:718,
        # common/mod.rs:74; manifest-last at persistence.rs:363-366)
        for f in d.iterdir():
            if f.is_file() and f.name != _MANIFEST:
                with open(f, "rb") as fh:
                    os.fsync(fh.fileno())
        tmp = d / (_MANIFEST + ".tmp")
        tmp.write_text(json.dumps(manifest, ensure_ascii=False, indent=1))
        with open(tmp, "rb") as fh:
            os.fsync(fh.fileno())
        os.replace(tmp, d / _MANIFEST)
        try:
            dfd = os.open(str(d), os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # directory fsync unsupported on some filesystems

    @classmethod
    def load(cls, directory) -> "Persistence":
        """Read an index directory (mmap-backed arrays)."""
        d = Path(directory)
        manifest = json.loads((d / _MANIFEST).read_text())
        p = cls()
        p.path = str(d)
        p.num_docs = manifest["num_docs"]
        p.bytes_indexed = manifest["bytes_indexed"]
        p.columns = manifest["columns"]

        def arr(name: str) -> np.ndarray:
            return np.load(d / (_enc(name) + ".npy"), mmap_mode="r")

        for path, kind in manifest["store_kinds"].items():
            if kind == "direct":
                p.key_value_stores[path] = Direct(values=arr(path + "#direct"))
            elif kind == "csr":
                p.key_value_stores[path] = Csr(
                    offsets=arr(path + "#offsets"), values=arr(path + "#values")
                )
            elif kind == "anchor_score":
                p.anchor_scores[path] = AnchorScoreCsr(
                    offsets=arr(path + "#offsets"), anchors=arr(path + "#anchors"),
                    scores=arr(path + "#scores"),
                )
            elif kind == "phrase":
                p.phrase_indices[path] = PhraseCsr(
                    keys=arr(path + "#keys"), offsets=arr(path + "#offsets"),
                    values=arr(path + "#values"),
                )
            elif kind == "boost":
                p.boost_stores[path] = (arr(path + "#bvalues"), arr(path + "#bpresent"))
        for f in d.glob("*%23terms.npy"):
            field = _dec(f.name[: -len(".npy")])[: -len("#terms")]
            p.dictionaries[field] = TermDictionary.from_arrays({"term_bytes": np.load(f)})
        docs = d / _DOCSTORE
        if docs.exists():
            p.doc_store_bytes = docs.read_bytes()
        return p

    def index(self, device=None) -> "TorchIndex":
        """This index uploaded with :meth:`TorchIndex.from_persistence`, on
        ``device`` or the default device: made once, under a lock, and kept.
        Naming another device than the kept upload's raises; the upload is
        moved by :meth:`invalidate_device_cache` first."""
        with self._index_lock:
            if self._index is None:
                self._index = TorchIndex.from_persistence(self, device)
            elif device is not None and _device(device) != self._index.device:
                raise VelociError(
                    f"index uploaded to {self._index.device}, not {torch.device(device)}"
                )
            return self._index

    def invalidate_device_cache(self) -> None:
        """Drop the upload (and with it everything cached on it): the next
        search uploads the index as it stands then."""
        with self._index_lock:
            self._index = None

    def warmup(self, queries: Optional[List[str]] = None, top: int = 10) -> float:
        """:meth:`TorchIndex.warmup` of the upload."""
        return self.index().warmup(queries, top)

    def attach_mesh(self, mesh) -> None:
        """:meth:`TorchIndex.attach_mesh` of the upload."""
        self.index().attach_mesh(mesh)

    def detach_mesh(self) -> None:
        """:meth:`TorchIndex.detach_mesh` of the upload, if there is one."""
        if self._index is not None:
            self._index.detach_mesh()

    def get_token_to_anchor(self, path: str) -> AnchorScoreCsr:
        store = self.anchor_scores.get(path)
        if store is None:
            raise VelociError(f"anchor score index not found: {path!r}")
        return store

    def get_phrase_pair_to_anchor(self, path: str) -> PhraseCsr:
        store = self.phrase_indices.get(path)
        if store is None:
            raise VelociError(f"phrase index not found: {path!r}")
        return store

    def heap_size_bytes(self) -> int:
        """The bytes of :meth:`heap_size_report`'s stores and dictionaries
        (``persistence.py:1091``)."""
        everything = [*self.key_value_stores.values(), *self.anchor_scores.values(), *self.phrase_indices.values(),
                      *self.dictionaries.values()]
        return sum(store.memory_bytes() for store in everything)

    def heap_size_report(self) -> str:
        """The index's stores and dictionaries with their sizes in bytes
        (reference persistence.rs:412-447)."""
        lines = [f"{'index':70} {'bytes':>12}"]
        everything = [*self.key_value_stores.items(), *self.anchor_scores.items(), *self.phrase_indices.items()]
        for path, store in sorted(everything):
            lines.append(f"{path:70} {store.memory_bytes():>12}")
        for field, dictionary in sorted(self.dictionaries.items()):
            lines.append(f"{field + '.terms':70} {dictionary.memory_bytes():>12}")
        return "\n".join(lines)

    def has_token_to_anchor(self, path: str) -> bool:
        return path in self.anchor_scores

    def combined_host_csr(self):
        """Every searchable field's postings concatenated under global term
        ids ``key_base[field] + token_id``: ``(offsets int64 [nk + 2]``
        (double tail sentinel), ``anchors``, ``scores`` (u16, raw x100),
        ``key_base)``, or None with no postings."""
        parts = [
            (path[: -len(_SCORE_SUFFIX)], self.anchor_scores[path])
            for path in sorted(self.anchor_scores)
            if path.endswith(_SCORE_SUFFIX)
        ]
        if not parts:
            return None
        key_base: Dict[str, Tuple[int, int]] = {}
        off_parts, anc_parts, sc_parts = [], [], []
        nnz_base = 0
        kbase = 0
        for field, store in parts:
            ho = np.asarray(store.offsets, dtype=np.int64)
            key_base[field] = (kbase, store.num_keys)
            off_parts.append(ho[:-1] + nnz_base)
            nnz_base += int(ho[-1])
            kbase += store.num_keys
            anc_parts.append(store.anchors)
            sc_parts.append(store.scores)
        off_parts.append(np.array([nnz_base, nnz_base], dtype=np.int64))
        anchors = np.concatenate(anc_parts) if nnz_base else np.zeros(0, np.int64)
        scores = np.concatenate(sc_parts) if nnz_base else np.zeros(0, np.uint16)
        return np.concatenate(off_parts), anchors, scores, key_base


class FieldSweep(NamedTuple):
    """One field's fuzzy-sweep matrix on the device. A field's rows are
    sorted by length (stably), so the terms a warp of the full-width kernel
    sweeps have like lengths and its walk, which runs to the warp's longest
    term, wastes few steps; ``sweep_ids`` maps each row back to its term."""

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


class RegexRows(NamedTuple):
    """What a regex leaf's prefilter reads of one field, on the host: two
    flags a row of the sweep matrix and of the long terms, for the rows
    whose ``re`` answer the folded ASCII DFA may miss, and the terms in no
    row (:func:`regex_flags`)."""

    sweep_flags: np.ndarray  # [M] uint8, per sweep row (in FieldSweep order)
    long_flags: np.ndarray  # [L] uint8, per long row (in LongTerms order)
    sweep_ids: np.ndarray  # [M] int64 sweep row -> term id, on the host
    row_of: np.ndarray  # [n] int64 term id -> sweep row, -1 for a term in none
    unswept: np.ndarray  # term ids in no row: the empty term, and terms whose
    # lowercase is longer than 32 chars though the term is not


# regex_flags bits
NONASCII = 1  # a code point above 127, or U+001C-U+001F (re's \s takes them)
FOLD_SPECIAL = 2  # U+0130, U+0131, U+017F or U+212A
_FOLD_SPECIAL = (0x130, 0x131, 0x17F, 0x212A)


def regex_flags(terms) -> np.ndarray:
    """Per term, as a uint8 of :data:`NONASCII` and :data:`FOLD_SPECIAL`
    bits, from the terms as ``re`` sees them (not lowercased).

    The regex prefilter's DFA knows ASCII only. ``re``'s ``\\w``, ``\\d`` and
    ``\\s`` also take non-ASCII letters, digits and spaces, and ``\\s`` the
    separators U+001C-U+001F (NONASCII). Under ``IGNORECASE``, ``re`` folds
    U+0130 and U+0131 onto ``i``, U+017F onto ``s`` and U+212A onto ``k``;
    and the sweep rows hold ``lower()``, which turns U+212A into ASCII
    ``k`` and U+0130 into two chars (FOLD_SPECIAL). Vectorised over the
    dictionary's code points."""
    n = len(terms)
    flags = np.zeros(n, dtype=np.uint8)
    if not n:
        return flags
    cps = np.frombuffer("\x00".join(terms).encode("utf-32-le"), dtype=np.uint32)
    sep = cps == 0  # terms hold no NUL: the dictionary's own file joins them by it
    term_of = np.cumsum(sep) - sep  # each code point's term
    wide = ((cps > 127) | ((cps >= 0x1C) & (cps <= 0x1F))) & ~sep
    fold = np.isin(cps, _FOLD_SPECIAL)
    flags[np.unique(term_of[wide])] |= NONASCII
    flags[np.unique(term_of[fold])] |= FOLD_SPECIAL
    return flags


def _regex_rows(dictionary, sweep_ids: np.ndarray, long_ids: np.ndarray) -> RegexRows:
    flags = regex_flags(dictionary.terms)
    n = len(dictionary)
    sweep_ids = np.asarray(sweep_ids, dtype=np.int64)
    valid = sweep_ids >= 0  # pad rows map to -1
    row_of = np.full(n, -1, dtype=np.int64)
    row_of[sweep_ids[valid]] = np.flatnonzero(valid)
    in_row = row_of >= 0
    in_row[long_ids] = True
    return RegexRows(np.where(valid, flags[np.maximum(sweep_ids, 0)] if n else 0, 0).astype(np.uint8),
                     flags[long_ids], sweep_ids, row_of, np.flatnonzero(~in_row).astype(np.int64))


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


_DEFAULT_DEVICE = [torch.device("cuda")]


def set_default_device(device) -> None:
    """Set the device that entry points take when their caller names none:
    :func:`load_index`, :meth:`TorchIndex.from_persistence`, the upload
    behind :meth:`Persistence.index`, the server's databases and the CLI.
    It starts as ``"cuda"``; the CPU is taken only when asked for."""
    _DEFAULT_DEVICE[0] = torch.device(device)


def default_device() -> torch.device:
    """The device of :func:`set_default_device` (``cuda`` unless set)."""
    return _DEFAULT_DEVICE[0]


def _device(device=None) -> torch.device:
    """``device``, or the default device when it is None; a CUDA device
    raises where no card is present (nothing falls back to the CPU)."""
    dev = torch.device(default_device() if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested, but torch.cuda.is_available() is False"
        )
    return dev


class TorchIndex(_HostStores):
    """An index on one torch device: per-field sweep matrices and the
    combined global-key posting CSR (``key_base[field] + term id``), with
    the host term dictionaries the field search reads, the field list the
    query generator expands terms over, and the host stores (column
    metadata, key-value relations, boost columns, phrase pairs) that
    filters, boosts, facets and phrase boosts read. ``cache`` holds what
    the batched route derives from them once (device boost columns, filter
    masks, facet relations); :meth:`warmup` fills it before the first
    request.

    A server's threads share one index. Its counters are added to under a
    lock (:meth:`count_path`, :meth:`count_rows`); its lazy fills
    (``cache``, ``term_boost_cache``, the document loader) are single dict
    reads and writes of values that do not change once made, so two
    threads that race at worst make one twice."""

    def __init__(
        self, *, num_docs, all_fields, dictionaries, fields, long_terms, host_offsets, offsets,
        packed, key_base, device, max_row_score=None, columns=None, key_value_stores=None,
        boost_stores=None, phrase_indices=None, regex_rows=None, doc_store_bytes=None,
    ) -> None:
        self.device = device
        self.num_docs = int(num_docs)
        self.all_fields = list(all_fields)  # the index's columns, in manifest order
        self.dictionaries = dictionaries  # field -> TermDictionary
        self.fields: Dict[str, FieldSweep] = fields
        self.long_terms: Dict[str, LongTerms] = long_terms  # see long_term_rows
        self.regex_rows: Dict[str, RegexRows] = regex_rows or {}
        self.host_offsets = host_offsets  # [num_keys + 2] int64, host
        self.offsets = offsets  # the same, on the device
        self.packed = packed  # [nnz, 2] int32 (anchor, f32 bits of score/100)
        # the largest row score when every one is a finite float with its
        # sign bit clear, else None (ops.postings.dense_max_row_score)
        self.max_row_score = max_row_score
        self.key_base = key_base  # field -> (base, num_keys)
        self.columns: Dict[str, dict] = columns or {}
        self.key_value_stores: Dict[str, Csr | Direct] = key_value_stores or {}
        self.boost_stores: Dict[str, Tuple[np.ndarray, np.ndarray]] = boost_stores or {}
        self.phrase_indices: Dict[str, PhraseCsr] = phrase_indices or {}
        self.doc_store_bytes: Optional[bytes] = doc_store_bytes  # docs.bin, as read
        self._doc_loader: Optional[DocLoader] = None
        self.cache: dict = {}
        self.term_boost_cache: dict = {}  # boost_term part key -> its anchors (search/boost.py)
        self.last_warmup_breakdown: dict = {}  # seconds per step of the last warmup()
        self.path_counts: Counter = Counter()  # requests answered per route
        self.gathered_rows: Counter = Counter()  # posting rows read per route
        self.bytes_indexed = 0  # the source data's size (Persistence.bytes_indexed)
        self._count_lock = threading.Lock()  # server threads share the counters
        self.mesh_ctx = None  # set by attach_mesh: search and search_batch answer on the mesh

    def attach_mesh(self, mesh) -> None:
        """Attach a document-sharded mesh (``attach_mesh``,
        ``persistence.py:752``; :func:`..parallel.sharding.build_mesh`):
        the combined postings are cut into its ``d`` shards now, on their
        devices, and :func:`..search.executor.search` and
        :func:`..search.batch.search_batch` then answer on it
        (:mod:`.parallel.mesh_executor`)."""
        from .parallel.mesh_executor import MeshContext

        self.mesh_ctx = MeshContext(self, mesh)

    def detach_mesh(self) -> None:
        """Answer on this index's own device again."""
        self.mesh_ctx = None

    def count_path(self, route: str, n: int = 1) -> None:
        """Add ``n`` to ``path_counts[route]``."""
        with self._count_lock:
            self.path_counts[route] += n

    def count_rows(self, route: str, n: int) -> None:
        """Add ``n`` to ``gathered_rows[route]``."""
        with self._count_lock:
            self.gathered_rows[route] += n

    @classmethod
    def from_reference_arrays(
        cls, *, num_docs, all_fields, term_bytes, fields, offsets, anchors, scores, key_base,
        device=None,
    ) -> "TorchIndex":
        """Build the index on ``device`` from host arrays: ``all_fields``
        the index's column names in manifest order; ``term_bytes`` each
        field's packed dictionary (``TermDictionary.to_arrays()``'s
        ``term_bytes``, the array an index directory stores); ``fields``
        each field's ``(chars [M, 32] uint16, lengths [M] int32, sweep_ids
        [M] int32)`` (the reference's ``DeviceField`` host arrays, or
        ``char_matrix_compact()``); ``offsets``, ``anchors``, ``scores``
        and ``key_base`` the combined CSR of ``combined_host_csr()`` (scores
        as the raw u16 x100 values). The index carries no relation stores:
        filters, boosts, facets and phrase boosts need one from
        :meth:`from_persistence` or :func:`load_index`."""
        dictionaries = {
            f: TermDictionary.from_arrays({"term_bytes": np.asarray(b)})
            for f, b in term_bytes.items()
        }
        return cls._upload(
            num_docs, all_fields, dictionaries, fields, offsets, anchors, scores, key_base, device
        )

    @classmethod
    def from_persistence(cls, pers: Persistence, device=None) -> "TorchIndex":
        """Upload a host :class:`Persistence` (built or read) to ``device``,
        the default device (:func:`default_device`) when it is None."""
        comb = pers.combined_host_csr()
        if comb is None:
            comb = np.zeros(2, np.int64), np.zeros(0, np.int32), np.zeros(0, np.uint16), {}
        index = cls._upload(
            pers.num_docs, pers.get_all_fields(), dict(pers.dictionaries),
            {f: d.char_matrix_compact() for f, d in pers.dictionaries.items()}, *comb, device,
            columns=pers.columns, key_value_stores=pers.key_value_stores,
            boost_stores=pers.boost_stores, phrase_indices=pers.phrase_indices,
            doc_store_bytes=pers.doc_store_bytes,
        )
        index.bytes_indexed = pers.bytes_indexed
        return index

    @classmethod
    def _upload(
        cls, num_docs, all_fields, dictionaries, fields, offsets, anchors, scores, key_base, device,
        **stores,
    ) -> "TorchIndex":
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

        def by_length(chars, lengths, sweep_ids):
            order = np.argsort(lengths, kind="stable")
            return np.asarray(chars)[order], np.asarray(lengths)[order], np.asarray(sweep_ids)[order]

        sorted_rows = {f: by_length(*arrays) for f, arrays in fields.items()}
        sweeps = {f: sweep(*rows) for f, rows in sorted_rows.items()}
        long_rows = {f: long_term_rows(d) for f, d in dictionaries.items()}
        long_terms = {f: long(*rows) for f, rows in long_rows.items()}
        regex_rows = {
            f: _regex_rows(d, sorted_rows[f][2] if f in sorted_rows else np.empty(0, np.int64),
                           long_rows[f][4])
            for f, d in dictionaries.items()
        }
        host_offsets = np.asarray(offsets, dtype=np.int64)
        scores01 = np.asarray(scores).astype(np.float32) / np.float32(100.0)
        packed = np.stack(
            [np.asarray(anchors).astype(np.int32), scores01.view(np.int32)], axis=1
        )
        return cls(
            num_docs=num_docs, all_fields=all_fields, dictionaries=dictionaries, fields=sweeps,
            long_terms=long_terms, host_offsets=host_offsets, offsets=up(host_offsets, np.int64),
            packed=up(packed, np.int32), key_base=dict(key_base), device=dev,
            max_row_score=dense_max_row_score(scores01), regex_rows=regex_rows, **stores,
        )

    def get_all_fields(self) -> List[str]:
        """The index's columns, in manifest order."""
        return self.all_fields

    def has_token_to_anchor(self, path: str) -> bool:
        """Whether ``path`` has postings (``search_query``'s field filter)."""
        return path.endswith(_SCORE_SUFFIX) and path[: -len(_SCORE_SUFFIX)] in self.key_base

    def device_boost(self, path: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """A boost column on the device, padded to ``[num_docs]``: (values
        f32, present bool), uploaded once per path (``device_boost``,
        ``persistence.py:764``)."""
        key = ("boost", path)
        cached = self.cache.get(key)
        if cached is None:
            vals, present = self.get_boost(path)
            v = np.zeros(self.num_docs, dtype=np.float32)
            p = np.zeros(self.num_docs, dtype=bool)
            m = min(self.num_docs, len(vals))
            v[:m], p[:m] = vals[:m], present[:m]
            cached = self.cache[key] = (
                torch.from_numpy(v).to(self.device), torch.from_numpy(p).to(self.device)
            )
        return cached

    def warmup(self, queries: Optional[List[str]] = None, top: int = 10) -> float:
        """Make the first real request fast (``Persistence.warmup``,
        ``persistence.py:895-1088``, without its TPU compile grids and its
        compile cache): on a CUDA device, build and load every kernel
        library; upload every boost column and every field's facet relation
        (the sweep matrices, the posting CSR and the regex row flags are
        made at upload); then answer probe requests through ``search_batch``
        and, the last of them, through ``search`` on the dense executor,
        which builds the filter mask of the probe's filter. ``queries``
        defaults to the reference's self-derived probes: the terms of the
        largest and of a median posting run and a frequent short term. Each
        probe is the generator's canonical expansion (its auto-Levenshtein
        distance, an OR over every field with postings) and its exact form.
        Records the seconds of each step in ``last_warmup_breakdown`` and
        returns the seconds spent in all."""
        import time

        from .query.generator import get_levenshteinn
        from .query.request import Request, RequestSearchPart, SearchRequest
        from .search.batch import search_batch
        from .search.executor import search
        from .search.facet import facet_relation

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from .ops import _build, levenshtein_sweep, postings, regex_dfa

            _build.build_all()
            for source, signature in (*levenshtein_sweep.SIGNATURES.items(),
                                      (postings.SOURCE, postings.SIGNATURE),
                                      (regex_dfa.SOURCE, regex_dfa.SIGNATURE)):
                _build.load(source, signature)
        t1 = time.perf_counter()
        for path in self.boost_stores:
            self.device_boost(path)
        for field in self.all_fields:
            facet_relation(self, field)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self.last_warmup_breakdown = {"build_s": t1 - t0, "upload_s": t2 - t1}
        fields = sorted(self.key_base)
        if queries is None:
            queries = self._warmup_terms()
        reqs = []
        for term in queries if fields else ():
            for dist in (get_levenshteinn(term, None, None, False), 0):
                leaves = [SearchRequest.search(RequestSearchPart(path=f, terms=[term], levenshtein_distance=dist))
                          for f in fields]
                node = leaves[0] if len(leaves) == 1 else SearchRequest.or_(leaves)
                reqs.append(Request(search_req=node, top=top))
        if reqs:
            search_batch(reqs, self)
            last = reqs[-1]
            last.filter = last.search_req
            search(last, self, dense_only=True)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.last_warmup_breakdown["probe_s"] = time.perf_counter() - t2
        return time.perf_counter() - t0

    def _warmup_terms(self) -> List[str]:
        """The terms of the largest and of a median posting run, and, until
        there are three, of the 256 largest runs whose term has at most 10
        chars (the reference's probes, ``persistence.py:1033-1061``)."""
        num_keys = sum(nk for _base, nk in self.key_base.values())
        counts = np.diff(self.host_offsets[: num_keys + 1])
        if not len(counts):
            return []

        def term_of(gid):
            for field, (base, nk) in self.key_base.items():
                if base <= gid < base + nk:
                    return self.get_dictionary(field).terms[gid - base]
            return ""

        order = np.argsort(counts)
        probes = {int(order[-1]), int(order[len(counts) // 2])}
        for gid in order[::-1][:256].tolist():
            t = term_of(gid)
            if t.strip() and len(t) + 2 <= 12:
                probes.add(gid)
                if len(probes) > 2:
                    break
        return [t for t in map(term_of, probes) if t.strip()]


def load_index(directory, device=None) -> TorchIndex:
    """Read an index directory and upload it to ``device``, the default
    device (:func:`default_device`) when it is None."""
    return TorchIndex.from_persistence(Persistence.load(directory), device)


def as_index(persistence) -> TorchIndex:
    """The :class:`TorchIndex` an entry point searches: a Persistence's
    upload (:meth:`Persistence.index`), or the index itself."""
    return persistence.index() if isinstance(persistence, Persistence) else persistence
