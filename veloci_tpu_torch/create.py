"""Index creation pipeline: the port's copy of ``veloci_tpu/create.py``.
It writes the same index as the reference package for the same input.

Reproduces the reference's 3-pass build (reference: src/create.rs
`create_fulltext_index` 757-927 and §3.1 of SURVEY.md):

* **pass 0** — stream docs into the compressed doc store
  (src/create/write_docs.rs).
* **pass 1** — collect terms + token occurrence counts per field path
  (src/create/create_fulltext.rs:116-152 `get_allterms_per_path`), then sort
  terms and assign ids in sorted order (`set_ids`, :71-80) and detect anchor
  identity columns (:38-39).
* **pass 2** — re-walk the documents emitting all relation tuples per path
  (src/create.rs:172-321 `parse_json_and_prepare_indices`), with index-time
  scoring (src/create/calculate_score.rs).
* **pass 3** — convert raw tuples into packed columns
  (src/create.rs:575-721 `convert_raw_path_data_to_indices`), here as
  vectorised numpy sorts/group-reductions instead of external-sort k-merges.

Scores are computed in float32 to match the reference's Rust ``f32``
arithmetic bit-for-bit, then truncated to u32
(calculate_score.rs:34-49 `calculate_token_score_for_entry`).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .config import FieldsConfig, FulltextIndexOptions, IndexCreationType, config_from_string
from .doc_store import DocStoreWriter
from .error import VelociError
from .indices import (
    AnchorScoreCsr,
    Csr,
    Direct,
    PhraseCsr,
    TermDictionary,
    csr_from_pairs,
    direct_from_pairs,
)
from .json_flatten import IDProvider, for_each_element, to_line_delimited

__all__ = [
    "create_indices_from_str",
    "create_indices_from_docs",
    "add_token_values_to_tokens",
    "calculate_token_score_for_entry",
]

# Index path suffix constants (reference src/persistence.rs:23-36).
TOKENS_TO_TEXT_ID = ".tokens_to_text_id"
TEXT_ID_TO_TOKEN_IDS = ".text_id_to_token_ids"
TO_ANCHOR_ID_SCORE = ".to_anchor_id_score"
PHRASE_PAIR_TO_ANCHOR = ".phrase_pair_to_anchor"
VALUE_ID_TO_PARENT = ".value_id_to_parent"
PARENT_TO_VALUE_ID = ".parent_to_value_id"
TEXT_ID_TO_ANCHOR = ".text_id_to_anchor"
ANCHOR_TO_TEXT_ID = ".anchor_to_text_id"
BOOST_VALID_TO_VALUE = ".boost_valid_to_value"
VALUE_ID_TO_ANCHOR = ".value_id_to_anchor"
TEXTINDEX = ".textindex"
TOKEN_VALUES = ".token_values"


def calculate_token_score_for_entry(
    token_best_pos: np.ndarray,
    num_occurences: np.ndarray,
    num_tokens_in_text: np.ndarray,
    is_exact: bool,
) -> np.ndarray:
    """Vectorised index-time score (reference calculate_score.rs:34-49).

    All arithmetic in float32 for parity with the Rust f32 implementation;
    returns u32-truncated scores.
    """
    f32 = np.float32
    pos = np.asarray(token_best_pos, dtype=f32)
    occ = np.asarray(num_occurences, dtype=f32)
    ntok = np.asarray(num_tokens_in_text, dtype=f32)
    if is_exact:
        score = np.full(pos.shape, f32(400.0), dtype=f32)
    else:
        score = f32(2000.0) / (np.log2(pos + f32(10.0)) + f32(10.0))
    occ_mod = (np.log10(occ + f32(1000.0)) - f32(2.0)).astype(f32)
    occ_mod = occ_mod - (occ_mod - f32(1.0)) * f32(0.7)
    score = score / occ_mod
    tl_mod = np.log10(ntok + f32(10.0)).astype(f32)
    tl_mod = tl_mod - (tl_mod - f32(1.0)) * f32(0.7)
    score = score / tl_mod
    return score.astype(np.uint32)


@dataclass
class _TermData:
    """Per-path term map built in pass 1 (reference TermDataInPath)."""

    counts: Dict[str, int] = field(default_factory=dict)
    do_not_store_text_longer_than: int = 64
    id_counter_for_large_texts: int = 0
    # assigned after sort:
    ids: Dict[str, int] = field(default_factory=dict)
    num_occurences: Optional[np.ndarray] = None  # by term id


@dataclass
class _PathData:
    """Per-path raw tuple buffers for pass 2 (reference PathData)."""

    # relation tuple buffers
    tokens_to_text_id: Optional[Tuple[List[int], List[int]]] = None
    anchor_tuples: Optional[Tuple[List[int], List[int], List[int], List[int], List[int]]] = None
    # ^ (token_or_text_id, anchor, best_pos, num_occ, num_tokens); exact
    #   text-level entries carry pos=-1 as the is_exact marker
    phrase_tuples: Optional[Tuple[List[int], List[int], List[int]]] = None
    text_id_to_token_ids: Optional[Tuple[List[int], List[int]]] = None
    text_id_seen: Optional[set] = None
    text_id_to_parent: Optional[Tuple[List[int], List[int]]] = None
    parent_to_text_id: Optional[Tuple[List[int], List[int]]] = None
    value_id_to_anchor: Optional[Tuple[List[int], List[int]]] = None
    text_id_to_anchor: Optional[Tuple[List[int], List[int]]] = None
    anchor_to_text_id: Optional[Tuple[List[int], List[int]]] = None
    boost: Optional[Tuple[List[int], List[float]]] = None
    is_anchor_identity_column: bool = False
    fulltext: Optional[FulltextIndexOptions] = None
    term_data: Optional[_TermData] = None


@dataclass
class _PathDataIds:
    value_to_parent: Optional[Tuple[List[int], List[int]]] = None
    parent_to_value: Optional[Tuple[List[int], List[int]]] = None


class BuiltIndex:
    """The output of a build: all packed columns + metadata, ready to persist.

    This is the in-memory form consumed by
    :class:`veloci_tpu_torch.persistence.Persistence`.
    """

    def __init__(self) -> None:
        self.num_docs: int = 0
        self.bytes_indexed: int = 0
        self.doc_store: Optional[bytes] = None
        self.dictionaries: Dict[str, TermDictionary] = {}  # field -> dict
        self.key_value_stores: Dict[str, Csr | Direct] = {}  # full index path -> col
        self.anchor_scores: Dict[str, AnchorScoreCsr] = {}
        self.phrase_indices: Dict[str, PhraseCsr] = {}
        self.boost_stores: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        # ^ path -> (values f32 [num_keys], present bool [num_keys])
        self.columns: Dict[str, dict] = {}  # field -> FieldInfo-like dict


def _get_fulltext_options(config: FieldsConfig, path: str) -> FulltextIndexOptions:
    cfg = config.get(path)
    return cfg.fulltext if cfg.fulltext is not None else FulltextIndexOptions()


def _pass1_collect_terms(
    docs: List[Any], config: FieldsConfig
) -> Dict[str, _TermData]:
    """Reference: get_allterms_per_path (create_fulltext.rs:116-152)."""
    terms_in_path: Dict[str, _TermData] = {}
    id_provider = IDProvider()

    def cb_text(_anchor: int, value: str, path: str, _parent: int) -> None:
        td = terms_in_path.get(path)
        if td is None:
            options = _get_fulltext_options(config, path)
            td = _TermData(
                do_not_store_text_longer_than=options.do_not_store_text_longer_than
            )
            td._options = options  # type: ignore[attr-defined]
            terms_in_path[path] = td
        options = td._options  # type: ignore[attr-defined]
        # NB the reference compares *byte* length (value.len() in Rust)
        if td.do_not_store_text_longer_than < len(value.encode("utf-8")):
            td.id_counter_for_large_texts += 1
        else:
            td.counts[value] = td.counts.get(value, 0) + 1
        if options.tokenize:
            tokenizer = options.tokenizer
            toks = tokenizer.tokens(value)
            if len(toks) > 1:
                counts = td.counts
                for tok, _is_sep in toks:
                    counts[tok] = counts.get(tok, 0) + 1

    def cb_ids(_anchor: int, _path: str, _vid: int, _pid: int) -> None:
        pass

    for_each_element(docs, id_provider, cb_text, cb_ids)
    return terms_in_path


def create_indices_from_str(
    data_str: str,
    indices: str = "{}",
    *,
    line_delimited: bool = True,
    use_native: Optional[bool] = None,
) -> BuiltIndex:
    """Build an index from newline-delimited JSON (reference create.rs:929-941).

    ``use_native=None`` takes the C++ indexing core when it builds and
    loads, ``False`` the pure-Python pipeline; both write the same index.
    """
    if not line_delimited:
        data_str = to_line_delimited(data_str)
    if use_native is not False:
        try:
            from .native import native_available

            if native_available():
                from .create_native import build_native

                config = config_from_string(indices)
                config.features_to_indices()
                return build_native(data_str, config)
        except Exception:
            if use_native:  # explicit request -> surface the error
                raise
    lines = [ln for ln in data_str.split("\n") if ln.strip()]
    docs = [json.loads(ln) for ln in lines]
    return create_indices_from_docs(docs, lines, indices)


def create_indices_from_docs(
    docs: List[Any], raw_lines: Optional[List[str]], indices: str = "{}"
) -> BuiltIndex:
    """Full build pipeline over parsed docs (reference create.rs:943-965)."""
    config = config_from_string(indices)
    config.features_to_indices()

    out = BuiltIndex()

    # ----- pass 0: doc store (write_docs.rs:12-35) -----------------------
    writer = DocStoreWriter()
    if raw_lines is None:
        raw_lines = [json.dumps(d, ensure_ascii=False, separators=(",", ":")) for d in docs]
    writer.add_docs(raw_lines)
    out.doc_store = writer.finish()
    out.num_docs = writer.curr_id
    out.bytes_indexed = writer.bytes_indexed

    # ----- pass 1: term collection + id assignment -----------------------
    terms_in_path = _pass1_collect_terms(docs, config)
    for path, td in terms_in_path.items():
        sorted_terms = sorted(td.counts.keys())
        td.ids = {t: i for i, t in enumerate(sorted_terms)}
        td.num_occurences = np.array(
            [td.counts[t] for t in sorted_terms], dtype=np.uint32
        )
        dictionary = TermDictionary(sorted_terms)
        out.dictionaries[path] = dictionary
        # identity column detection (create_fulltext.rs:38-39)
        is_identity = (
            "[]" not in path
            and out.num_docs == len(sorted_terms)
            and bool(np.all(td.num_occurences == 1))
        )
        options = td._options  # type: ignore[attr-defined]
        out.columns[path] = {
            "name": path,
            "has_fst": True,
            "is_anchor_identity_column": is_identity,
            "textindex_metadata": {
                "num_text_ids": len(sorted_terms),
                "num_long_text_ids": 0,
                "options": options.to_dict(),
            },
            "indices": [],
        }
        # reset the large-text counter contribution is kept (the reference's
        # pass-2 counter continues from the pass-1 value; see get_text_info)

    # ----- pass 2: emit relation tuples ----------------------------------
    path_data, tuples_ids = _pass2_emit_relations(docs, config, terms_in_path, out)

    # ----- pass 3: pack columns ------------------------------------------
    _pass3_pack(path_data, tuples_ids, out)

    return out


def _pass2_emit_relations(
    docs: List[Any],
    config: FieldsConfig,
    terms_in_path: Dict[str, _TermData],
    out: BuiltIndex,
):
    """Reference: parse_json_and_prepare_indices (create.rs:172-321)."""
    path_data: Dict[str, _PathData] = {}
    tuples_ids: Dict[str, _PathDataIds] = {}
    id_provider = IDProvider()

    def prepare_path_data(path: str) -> _PathData:
        """Reference: prepare_path_data (create/path_data.rs:59-139)."""
        field_config = config.get(path)
        td = terms_in_path[path]
        data = _PathData(term_data=td)
        data.fulltext = (
            field_config.fulltext if field_config.fulltext else FulltextIndexOptions()
        )
        data.is_anchor_identity_column = out.columns.get(path, {}).get(
            "is_anchor_identity_column", False
        )
        en = field_config.is_index_enabled
        I = IndexCreationType
        if field_config.boost is not None:
            data.boost = ([], [])
            data.value_id_to_anchor = ([], [])
        if field_config.facet and "[]" in path:
            data.anchor_to_text_id = ([], [])
        if en(I.TokensToTextID):
            data.tokens_to_text_id = ([], [])
        if en(I.TextIDToParent):
            data.text_id_to_parent = ([], [])
        if en(I.TextIDToAnchor):
            data.text_id_to_anchor = ([], [])
        if en(I.PhrasePairToAnchor):
            data.phrase_tuples = ([], [], [])
        if en(I.TextIDToTokenIds):
            data.text_id_to_token_ids = ([], [])
            data.text_id_seen = set()
        if en(I.ParentToTextID):
            data.parent_to_text_id = ([], [])
        if en(I.TokenToAnchorIDScore):
            data.anchor_tuples = ([], [], [], [], [])
        return data

    def get_text_info(td: _TermData, value: str) -> Tuple[int, int]:
        """(id, num_occurences) — reference get_text_info (create.rs:141-160)."""
        if td.do_not_store_text_longer_than < len(value.encode("utf-8")):
            td.id_counter_for_large_texts += 1
            return len(td.ids) + 1 + td.id_counter_for_large_texts, 1
        tid = td.ids[value]
        return tid, int(td.num_occurences[tid])

    def cb_text(anchor_id: int, value: str, path: str, parent_val_id: int) -> None:
        data = path_data.get(path)
        if data is None:
            data = prepare_path_data(path)
            path_data[path] = data
        td = data.term_data
        text_id, text_occ = get_text_info(td, value)

        if data.text_id_to_parent is not None:
            data.text_id_to_parent[0].append(text_id)
            data.text_id_to_parent[1].append(parent_val_id)
        if data.parent_to_text_id is not None:
            data.parent_to_text_id[0].append(parent_val_id)
            data.parent_to_text_id[1].append(text_id)
        if data.text_id_to_anchor is not None and not data.is_anchor_identity_column:
            data.text_id_to_anchor[0].append(text_id)
            data.text_id_to_anchor[1].append(anchor_id)
        if data.anchor_to_text_id is not None:
            data.anchor_to_text_id[0].append(anchor_id)
            data.anchor_to_text_id[1].append(text_id)
        if data.boost is not None and value.strip() != "":
            num = float(value)  # reference panics on non-f32 too (create.rs:209)
            if not math.isnan(num):
                data.boost[0].append(parent_val_id)
                data.boost[1].append(num)
        if data.value_id_to_anchor is not None:
            data.value_id_to_anchor[0].append(parent_val_id)
            data.value_id_to_anchor[1].append(anchor_id)

        if data.anchor_tuples is not None:
            # exact text-level entry: pos=-1 marks is_exact (create.rs:217-221)
            t = data.anchor_tuples
            t[0].append(text_id)
            t[1].append(anchor_id)
            t[2].append(-1)
            t[3].append(text_occ)
            t[4].append(1)

        if data.fulltext.tokenize:
            tokenizer = data.fulltext.tokenizer
            toks = tokenizer.tokens(value)
            if len(toks) > 1:
                term_ids = td.ids
                occs = td.num_occurences
                token_ids_for_text: List[int] = []
                store_token_ids = (
                    data.text_id_to_token_ids is not None
                    and text_id not in data.text_id_seen
                )
                prev_token: Optional[int] = None
                # per-text grouping state for scoring (calculate_score.rs:6-31)
                first_pos: Dict[int, int] = {}
                pos = 0
                for tok, is_sep in toks:
                    token_id = term_ids[tok]
                    if store_token_ids:
                        token_ids_for_text.append(token_id)
                    if data.tokens_to_text_id is not None:
                        data.tokens_to_text_id[0].append(token_id)
                        data.tokens_to_text_id[1].append(text_id)
                    if data.anchor_tuples is not None:
                        if token_id not in first_pos:
                            first_pos[token_id] = pos
                        pos += 1
                    if not is_sep and data.phrase_tuples is not None:
                        if prev_token is not None:
                            data.phrase_tuples[0].append(prev_token)
                            data.phrase_tuples[1].append(token_id)
                            data.phrase_tuples[2].append(anchor_id)
                        prev_token = token_id
                if store_token_ids:
                    data.text_id_seen.add(text_id)
                    data.text_id_to_token_ids[0].append(text_id)
                    data.text_id_to_token_ids[1].append(token_ids_for_text)
                if data.anchor_tuples is not None:
                    t = data.anchor_tuples
                    num_tokens = pos
                    for token_id, best_pos in first_pos.items():
                        t[0].append(token_id)
                        t[1].append(anchor_id)
                        t[2].append(best_pos)
                        t[3].append(int(occs[token_id]))
                        t[4].append(num_tokens)

    def cb_ids(anchor_id: int, path: str, value_id: int, parent_val_id: int) -> None:
        tup = tuples_ids.get(path)
        if tup is None:
            field_config = config.get(path)
            tup = _PathDataIds(
                value_to_parent=([], [])
                if field_config.is_index_enabled(IndexCreationType.ValueIDToParent)
                else None,
                parent_to_value=([], [])
                if field_config.is_index_enabled(IndexCreationType.ParentToValueID)
                else None,
            )
            tuples_ids[path] = tup
        if tup.value_to_parent is not None:
            tup.value_to_parent[0].append(value_id)
            tup.value_to_parent[1].append(parent_val_id)
        if tup.parent_to_value is not None:
            tup.parent_to_value[0].append(parent_val_id)
            tup.parent_to_value[1].append(value_id)

    for_each_element(docs, id_provider, cb_text, cb_ids)
    return path_data, tuples_ids


def _num_keys(keys: List[int]) -> int:
    return (max(keys) + 1) if keys else 0


def _spill():
    from . import spill

    return spill


def _group_dedup_combo(k_sorted: np.ndarray, v_sorted: np.ndarray):
    """Group a sorted combined-key stream (token<<32|anchor, score): per-group
    max score + min(count,5) bonus when count>1 (create.rs:418-448). Works
    directly on memmap-backed runs — only group-sized arrays materialise."""
    if not len(k_sorted):
        e = np.empty(0, dtype=np.int64)
        return e, e.astype(np.uint32), np.empty(0, dtype=np.uint32)
    new_group = np.ones(len(k_sorted), dtype=bool)
    new_group[1:] = k_sorted[1:] != k_sorted[:-1]
    starts = np.flatnonzero(new_group)
    group_max = np.maximum.reduceat(v_sorted, starts).astype(np.uint32)
    counts = np.empty(len(starts), dtype=np.int64)
    np.subtract(starts[1:], starts[:-1], out=counts[:-1])
    counts[-1] = len(k_sorted) - starts[-1]
    bonus = np.minimum(counts, 5).astype(np.uint32)
    bonus = np.where(counts > 1, bonus, 0).astype(np.uint32)
    final = group_max + bonus
    g_keys = np.asarray(k_sorted[starts])
    g_ids = (g_keys >> np.uint64(32)).astype(np.int64)
    g_anchors = (g_keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return g_ids, g_anchors, final


def _pack_anchor_scores(
    tuples: Tuple[List[int], List[int], List[int], List[int], List[int]],
) -> AnchorScoreCsr:
    """Score + pack the hot index.

    Reference: stream_iter_to_anchor_score (create.rs:389-411): per token,
    entries sorted by anchor; equal anchors dedup to max score plus a
    multi-hit bonus of min(group_len, 5).
    """
    ids = np.asarray(tuples[0], dtype=np.int64)
    anchors = np.asarray(tuples[1], dtype=np.int64)
    pos = np.asarray(tuples[2], dtype=np.int64)
    occ = np.asarray(tuples[3], dtype=np.int64)
    ntok = np.asarray(tuples[4], dtype=np.int64)

    is_exact = pos < 0
    scores = np.zeros(len(ids), dtype=np.uint32)
    if is_exact.any():
        scores[is_exact] = calculate_token_score_for_entry(
            np.zeros(int(is_exact.sum())), occ[is_exact], ntok[is_exact], True
        )
    tok_mask = ~is_exact
    if tok_mask.any():
        scores[tok_mask] = calculate_token_score_for_entry(
            pos[tok_mask], occ[tok_mask], ntok[tok_mask], False
        )

    n = len(ids)
    small_keys = n and int(ids.max()) < (1 << 31) and int(anchors.max()) < (1 << 32)
    if small_keys and n > _spill().SPILL_PAIRS:
        # external sort: spill sorted runs to disk, merge as memmap streams
        # (reference BufferedIndexWriter, buffered_index_writer/src/lib.rs)
        with _spill().SpillSorter() as sorter:
            combo_u = (ids.astype(np.uint64) << np.uint64(32)) | anchors.astype(
                np.uint64
            )
            sorter.add(combo_u, scores.astype(np.uint64))
            del combo_u
            k_sorted, v_sorted = sorter.finish()
            g_ids, g_anchors, final = _group_dedup_combo(k_sorted, v_sorted)
    else:
        if small_keys:
            # combined-key argsort: one int64 key beats a 2-key lexsort
            combo = (ids << np.int64(32)) | anchors
            order = np.argsort(combo, kind="stable")
            combo = combo[order]
            ids = combo >> np.int64(32)
            anchors = combo & np.int64(0xFFFFFFFF)
            scores = scores[order]
        else:
            order = np.lexsort((anchors, ids))
            ids, anchors, scores = ids[order], anchors[order], scores[order]
        if len(ids):
            new_group = np.ones(len(ids), dtype=bool)
            new_group[1:] = (ids[1:] != ids[:-1]) | (anchors[1:] != anchors[:-1])
            starts = np.flatnonzero(new_group)
            group_max = (
                np.maximum.reduceat(scores, starts) if len(starts) else scores[:0]
            )
            counts = np.empty(len(starts), dtype=np.int64)
            np.subtract(starts[1:], starts[:-1], out=counts[:-1])
            counts[-1] = len(ids) - starts[-1]
            bonus = np.minimum(counts, 5).astype(np.uint32)
            bonus = np.where(counts > 1, bonus, 0).astype(np.uint32)
            final = group_max + bonus
            g_ids = ids[starts]
            g_anchors = anchors[starts].astype(np.uint32)
        else:
            final = scores
            g_ids = ids
            g_anchors = anchors.astype(np.uint32)

    nkeys = int(g_ids.max()) + 1 if len(g_ids) else 0
    counts_per_key = np.bincount(g_ids, minlength=nkeys) if len(g_ids) else np.zeros(0)
    offsets = np.zeros(nkeys + 1, dtype=np.uint64)
    if nkeys:
        np.cumsum(counts_per_key, out=offsets[1:])
    return AnchorScoreCsr(
        offsets=offsets,
        anchors=g_anchors,
        scores=np.minimum(final, 0xFFFF).astype(np.uint16),
    )


def _pack_phrase(tuples: Tuple[List[int], List[int], List[int]]) -> PhraseCsr:
    """Reference: stream_iter_to_phrase_index (create.rs:505-517) — values
    per (a, b) key sorted + deduped."""
    a = np.asarray(tuples[0], dtype=np.uint64)
    b = np.asarray(tuples[1], dtype=np.uint64)
    v = np.asarray(tuples[2], dtype=np.uint32)
    keys = (a << np.uint64(32)) | b
    if len(keys) > _spill().SPILL_PAIRS:
        # external lexicographic sort, LSD style: stable-sort by value first,
        # then stable-sort by key — two SpillSorter passes with bounded RAM
        # (the 96-bit (key, value) pair doesn't fit one combined u64 key)
        with _spill().SpillSorter() as s1:
            s1.add(v.astype(np.uint64), keys)
            v1, k1 = s1.finish()
            with _spill().SpillSorter() as s2:
                s2.add(np.asarray(k1), np.asarray(v1))
                k_s, v_s = s2.finish()
                keep = np.ones(len(k_s), dtype=bool)
                keep[1:] = (k_s[1:] != k_s[:-1]) | (v_s[1:] != v_s[:-1])
                keys = np.asarray(k_s[keep])
                v = np.asarray(v_s[keep]).astype(np.uint32)
    else:
        from . import native as _native

        keys = np.ascontiguousarray(keys)
        v = np.array(v, dtype=np.uint32, copy=True)
        packed = _native.pack_phrase(keys, v)
        if packed is not None:
            uniq_keys, offsets, vals = packed
            return PhraseCsr(keys=uniq_keys, offsets=offsets, values=vals)
        order = np.lexsort((v, keys))
        keys, v = keys[order], v[order]
        if len(keys):
            keep = np.ones(len(keys), dtype=bool)
            keep[1:] = (keys[1:] != keys[:-1]) | (v[1:] != v[:-1])
            keys, v = keys[keep], v[keep]
    if len(keys):
        new_key = np.ones(len(keys), dtype=bool)
        new_key[1:] = keys[1:] != keys[:-1]
        starts = np.flatnonzero(new_key)
        uniq_keys = keys[starts]
        counts = np.diff(np.append(starts, len(keys)))
        offsets = np.zeros(len(uniq_keys) + 1, dtype=np.uint64)
        np.cumsum(counts, out=offsets[1:])
    else:
        uniq_keys = keys
        offsets = np.zeros(1, dtype=np.uint64)
    return PhraseCsr(keys=uniq_keys, offsets=offsets, values=v)


def _pass3_pack(
    path_data: Dict[str, _PathData],
    tuples_ids: Dict[str, _PathDataIds],
    out: BuiltIndex,
) -> None:
    """Reference: convert_raw_path_data_to_indices (create.rs:575-721)."""

    def add_meta(field_path: str, index_path: str, category: str, cardinality: str, store) -> None:
        col = out.columns.setdefault(
            field_path,
            {
                "name": field_path,
                "has_fst": False,
                "is_anchor_identity_column": False,
                "textindex_metadata": {
                    "num_text_ids": 0,
                    "num_long_text_ids": 0,
                    "options": {"tokenize": False},
                },
                "indices": [],
            },
        )
        is_empty = (
            (hasattr(store, "values") and len(store.values) == 0)
            or (hasattr(store, "anchors") and len(store.anchors) == 0)
        )
        col["indices"].append(
            {
                "path": index_path,
                "index_category": category,
                "index_cardinality": cardinality,
                "is_empty": bool(is_empty),
            }
        )

    for path_col, data in path_data.items():
        p = path_col + TEXTINDEX

        if data.tokens_to_text_id is not None and data.tokens_to_text_id[0]:
            csr = csr_from_pairs(
                data.tokens_to_text_id[0],
                data.tokens_to_text_id[1],
                _num_keys(data.tokens_to_text_id[0]),
                sort_and_dedup=True,
            )
            out.key_value_stores[p + TOKENS_TO_TEXT_ID] = csr
            add_meta(path_col, p + TOKENS_TO_TEXT_ID, "KeyValue", "MultiValue", csr)

        if data.anchor_tuples is not None and data.anchor_tuples[0]:
            score_csr = _pack_anchor_scores(data.anchor_tuples)
            out.anchor_scores[p + TO_ANCHOR_ID_SCORE] = score_csr
            add_meta(path_col, p + TO_ANCHOR_ID_SCORE, "AnchorScore", "MultiValue", score_csr)

        if data.phrase_tuples is not None and data.phrase_tuples[0]:
            pcsr = _pack_phrase(data.phrase_tuples)
            out.phrase_indices[p + PHRASE_PAIR_TO_ANCHOR] = pcsr
            add_meta(path_col, p + PHRASE_PAIR_TO_ANCHOR, "Phrase", "MultiValue", pcsr)

        if data.text_id_to_token_ids is not None and data.text_id_to_token_ids[0]:
            keys: List[int] = []
            vals: List[int] = []
            for tid, toks in zip(*data.text_id_to_token_ids):
                keys.extend([tid] * len(toks))
                vals.extend(toks)
            csr = csr_from_pairs(keys, vals, _num_keys(keys), stable=True)
            out.key_value_stores[p + TEXT_ID_TO_TOKEN_IDS] = csr
            add_meta(path_col, p + TEXT_ID_TO_TOKEN_IDS, "KeyValue", "MultiValue", csr)

        if data.text_id_to_parent is not None and data.text_id_to_parent[0]:
            csr = csr_from_pairs(
                data.text_id_to_parent[0],
                data.text_id_to_parent[1],
                _num_keys(data.text_id_to_parent[0]),
            )
            out.key_value_stores[p + VALUE_ID_TO_PARENT] = csr
            add_meta(path_col, p + VALUE_ID_TO_PARENT, "KeyValue", "MultiValue", csr)

        if data.value_id_to_anchor is not None and data.value_id_to_anchor[0]:
            # NB: keyed off path_col WITHOUT .textindex (create.rs:649)
            csr = csr_from_pairs(
                data.value_id_to_anchor[0],
                data.value_id_to_anchor[1],
                _num_keys(data.value_id_to_anchor[0]),
            )
            out.key_value_stores[path_col + VALUE_ID_TO_ANCHOR] = csr
            add_meta(path_col, path_col + VALUE_ID_TO_ANCHOR, "KeyValue", "MultiValue", csr)

        if data.parent_to_text_id is not None and data.parent_to_text_id[0]:
            # 1:1 — every value id has exactly one text id (create.rs:652-661)
            direct = direct_from_pairs(
                data.parent_to_text_id[0],
                data.parent_to_text_id[1],
                _num_keys(data.parent_to_text_id[0]),
            )
            out.key_value_stores[p + PARENT_TO_VALUE_ID] = direct
            add_meta(path_col, p + PARENT_TO_VALUE_ID, "KeyValue", "SingleValue", direct)

        if data.text_id_to_anchor is not None and data.text_id_to_anchor[0]:
            csr = csr_from_pairs(
                data.text_id_to_anchor[0],
                data.text_id_to_anchor[1],
                _num_keys(data.text_id_to_anchor[0]),
                sort_and_dedup=True,
            )
            out.key_value_stores[p + TEXT_ID_TO_ANCHOR] = csr
            add_meta(path_col, p + TEXT_ID_TO_ANCHOR, "KeyValue", "MultiValue", csr)

        if data.anchor_to_text_id is not None and data.anchor_to_text_id[0]:
            csr = csr_from_pairs(
                data.anchor_to_text_id[0],
                data.anchor_to_text_id[1],
                _num_keys(data.anchor_to_text_id[0]),
            )
            out.key_value_stores[p + ANCHOR_TO_TEXT_ID] = csr
            add_meta(path_col, p + ANCHOR_TO_TEXT_ID, "KeyValue", "MultiValue", csr)

        if data.boost is not None and data.boost[0]:
            boost_path = path_col + BOOST_VALID_TO_VALUE
            nk = _num_keys(data.boost[0])
            vals = np.zeros(nk, dtype=np.float32)
            present = np.zeros(nk, dtype=bool)
            keys = np.asarray(data.boost[0], dtype=np.int64)
            bvals = np.asarray(data.boost[1], dtype=np.float32)
            # first value per key wins (reference uses get_value -> first)
            vals[keys[::-1]] = bvals[::-1]
            present[keys] = True
            out.boost_stores[boost_path] = (vals, present)
            add_meta(path_col, boost_path, "Boost", "MultiValue", Direct(values=vals))

    for path, tup in tuples_ids.items():
        if tup.value_to_parent is not None and tup.value_to_parent[0]:
            direct = direct_from_pairs(
                tup.value_to_parent[0],
                tup.value_to_parent[1],
                _num_keys(tup.value_to_parent[0]),
            )
            out.key_value_stores[path + VALUE_ID_TO_PARENT] = direct
            add_meta(path, path + VALUE_ID_TO_PARENT, "KeyValue", "SingleValue", direct)
        if tup.parent_to_value is not None and tup.parent_to_value[0]:
            csr = csr_from_pairs(
                tup.parent_to_value[0],
                tup.parent_to_value[1],
                _num_keys(tup.parent_to_value[0]),
            )
            out.key_value_stores[path + PARENT_TO_VALUE_ID] = csr
            add_meta(path, path + PARENT_TO_VALUE_ID, "KeyValue", "MultiValue", csr)


def add_token_values_to_tokens(persistence, data_str: str, config_str: str) -> None:
    """Post-hoc per-token boost column (reference
    src/create/token_values_to_tokens.rs:26-82).

    Looks each text up in the field dictionary (exact, case-sensitive) and
    writes ``token_id -> f32`` under ``<path>.textindex.token_values
    .boost_valid_to_value`` of the host :class:`Persistence`; upload the
    index afterwards."""
    data = json.loads(data_str)
    cfg = json.loads(config_str)
    path = cfg["path"]
    dictionary = persistence.dictionaries.get(path)
    if dictionary is None:
        raise VelociError(f"no dictionary for path {path!r}")
    keys: List[int] = []
    vals: List[float] = []
    for el in data:
        if el.get("value") is None:
            continue
        tid = dictionary.get(el["text"])
        if tid is not None:
            keys.append(tid)
            vals.append(float(el["value"]))
    boost_path = path + TEXTINDEX + TOKEN_VALUES + BOOST_VALID_TO_VALUE
    nk = _num_keys(keys)
    values = np.zeros(nk, dtype=np.float32)
    present = np.zeros(nk, dtype=bool)
    if keys:
        k = np.asarray(keys, dtype=np.int64)
        values[k[::-1]] = np.asarray(vals, dtype=np.float32)[::-1]
        present[k] = True
    persistence.boost_stores[boost_path] = (values, present)
    col = persistence.columns.setdefault(
        path,
        {
            "name": path,
            "has_fst": False,
            "is_anchor_identity_column": False,
            "textindex_metadata": {"num_text_ids": 0, "num_long_text_ids": 0, "options": {"tokenize": False}},
            "indices": [],
        },
    )
    col["indices"].append(
        {
            "path": boost_path,
            "index_category": "Boost",
            "index_cardinality": "SingleValue",
            "is_empty": not keys,
        }
    )
