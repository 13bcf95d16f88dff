"""Native-accelerated index build: C++ parse/tokenize/count
(:mod:`veloci_tpu_torch.native`) + vectorised numpy relational packing.

The port's copy of ``veloci_tpu/create_native.py``. Produces a
:class:`veloci_tpu_torch.create.BuiltIndex` identical to the pure-Python
pipeline and to the reference package's build (parity covered by
tests/test_torch_host.py). The C++ core replaces the per-token Python loops
of passes 1-2; everything relational (grouping, scoring, CSR packing) is
numpy over the flat leaf/token tables.
"""

from __future__ import annotations

import numpy as np

from .config import FieldsConfig, FulltextIndexOptions, IndexCreationType
from .create import (
    ANCHOR_TO_TEXT_ID,
    BOOST_VALID_TO_VALUE,
    PARENT_TO_VALUE_ID,
    PHRASE_PAIR_TO_ANCHOR,
    TEXT_ID_TO_ANCHOR,
    TEXT_ID_TO_TOKEN_IDS,
    TEXTINDEX,
    TO_ANCHOR_ID_SCORE,
    TOKENS_TO_TEXT_ID,
    VALUE_ID_TO_ANCHOR,
    VALUE_ID_TO_PARENT,
    BuiltIndex,
    _pack_anchor_scores,
    _pack_phrase,
)
from .doc_store import DocStoreWriter
from .indices import AnchorScoreCsr, TermDictionary, csr_from_pairs, direct_from_pairs
from .native import NativeIdPath, NativePath, index_ndjson
from .tokenizer import DEFAULT_SEPARATORS

__all__ = ["build_native"]


def _get_fulltext(config: FieldsConfig, path: str) -> FulltextIndexOptions:
    cfg = config.get(path)
    return cfg.fulltext if cfg.fulltext is not None else FulltextIndexOptions()


def build_native(data_str: str, config: FieldsConfig) -> BuiltIndex:
    out = BuiltIndex()

    # pass 0: doc store (the reference's one-pass native doc-store builder
    # writes the same bytes as this writer)
    writer = DocStoreWriter()
    writer.add_docs(line for line in data_str.split("\n") if line.strip())
    out.doc_store = writer.finish()
    out.num_docs = writer.curr_id
    out.bytes_indexed = writer.bytes_indexed

    def get_path_config(path: str):
        opts = _get_fulltext(config, path)
        seps = (
            "".join(opts.tokenize_on_chars)
            if opts.tokenize_on_chars is not None
            else DEFAULT_SEPARATORS
        )
        return opts.tokenize, opts.do_not_store_text_longer_than, seps

    def score_paths(name: str, n_entries: int) -> bool:
        # pack the hot anchor-score index in C++ unless the spill machinery
        # must engage (env-matrix spill runs keep the numpy external-sort
        # path) or the feature is disabled for this path
        from .create import _spill

        if n_entries > _spill().SPILL_PAIRS:
            return False
        cfg = config.get(name)
        return cfg.is_index_enabled(IndexCreationType.TokenToAnchorIDScore)

    num_docs, paths, id_paths = index_ndjson(
        data_str, get_path_config, score_paths=score_paths
    )
    if num_docs != out.num_docs:
        raise ValueError(f"native indexer counted {num_docs} docs, the doc store {out.num_docs}")

    # per-path packing in parallel (reference converts paths with rayon
    # into_par_iter, create.rs:612-614); each path writes disjoint keys into
    # `out`, and numpy releases the GIL for the heavy sorts
    if len(paths) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
            list(pool.map(lambda ps: _pack_path(out, ps, config), paths))
    else:
        for ps in paths:
            _pack_path(out, ps, config)
    for ip in id_paths:
        _pack_id_path(out, ip, config)
    return out


def _add_meta(out: BuiltIndex, field_path, index_path, category, cardinality, is_empty):
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
    col["indices"].append(
        {
            "path": index_path,
            "index_category": category,
            "index_cardinality": cardinality,
            "is_empty": bool(is_empty),
        }
    )


def _pack_path(out: BuiltIndex, ps: NativePath, config: FieldsConfig) -> None:
    path_col = ps.name
    p = path_col + TEXTINDEX
    field_config = config.get(path_col)
    en = field_config.is_index_enabled
    I = IndexCreationType
    opts = _get_fulltext(config, path_col)

    dictionary = TermDictionary(ps.terms)
    out.dictionaries[path_col] = dictionary
    is_identity = (
        "[]" not in path_col
        and out.num_docs == len(ps.terms)
        and bool(np.all(ps.occurrences == 1))
    )
    out.columns[path_col] = {
        "name": path_col,
        "has_fst": True,
        "is_anchor_identity_column": is_identity,
        "textindex_metadata": {
            "num_text_ids": len(ps.terms),
            "num_long_text_ids": 0,
            "options": opts.to_dict(),
        },
        "indices": [],
    }

    anchor = ps.leaf_anchor.astype(np.int64)
    parent = ps.leaf_parent.astype(np.int64)
    text_id = ps.leaf_text_id
    ntok = ps.leaf_ntokens.astype(np.int64)
    tok_off = ps.leaf_tok_offsets
    tokens = ps.tokens.astype(np.int64)
    is_sep = ps.token_is_sep.astype(bool)
    L = len(anchor)
    T = len(tokens)
    num_terms = len(ps.terms)

    def nk(arr) -> int:
        return int(arr.max()) + 1 if len(arr) else 0

    # --- text-level relations (cb_text, create.rs:196-215) ---------------
    if en(I.TextIDToParent) and L:
        csr = csr_from_pairs(text_id, parent, nk(text_id))
        out.key_value_stores[p + VALUE_ID_TO_PARENT] = csr
        _add_meta(out, path_col, p + VALUE_ID_TO_PARENT, "KeyValue", "MultiValue", False)
    if en(I.ParentToTextID) and L:
        direct = direct_from_pairs(parent, text_id.astype(np.uint32), nk(parent))
        out.key_value_stores[p + PARENT_TO_VALUE_ID] = direct
        _add_meta(out, path_col, p + PARENT_TO_VALUE_ID, "KeyValue", "SingleValue", False)
    if en(I.TextIDToAnchor) and not is_identity and L:
        csr = csr_from_pairs(text_id, anchor, nk(text_id), sort_and_dedup=True)
        out.key_value_stores[p + TEXT_ID_TO_ANCHOR] = csr
        _add_meta(out, path_col, p + TEXT_ID_TO_ANCHOR, "KeyValue", "MultiValue", False)
    if field_config.facet and "[]" in path_col and L:
        csr = csr_from_pairs(anchor, text_id, nk(anchor))
        out.key_value_stores[p + ANCHOR_TO_TEXT_ID] = csr
        _add_meta(out, path_col, p + ANCHOR_TO_TEXT_ID, "KeyValue", "MultiValue", False)

    if field_config.boost is not None and L:
        vals = np.zeros(nk(parent), dtype=np.float32)
        present = np.zeros(nk(parent), dtype=bool)
        # first value per parent wins; texts parse as f32 (create.rs:207-214).
        # Parse each UNIQUE term once (num_terms << L), then gather: the
        # per-leaf Python loop was an ingest hotspot.
        term_vals = np.full(num_terms + 1, np.nan, dtype=np.float32)
        for tid in np.unique(text_id[text_id < num_terms]):
            text = dictionary.terms[int(tid)]
            if text.strip() != "":
                term_vals[tid] = np.float32(float(text))
        leaf_vals = term_vals[np.minimum(text_id, num_terms)]
        ok = ~np.isnan(leaf_vals)
        # iterate first-wins: reversed assignment leaves the FIRST leaf's
        # value per parent in place
        vals[parent[ok][::-1]] = leaf_vals[ok][::-1]
        present[parent[ok]] = True
        boost_path = path_col + BOOST_VALID_TO_VALUE
        out.boost_stores[boost_path] = (vals, present)
        _add_meta(out, path_col, boost_path, "Boost", "MultiValue", False)
        csr = csr_from_pairs(parent, anchor, nk(parent))
        out.key_value_stores[path_col + VALUE_ID_TO_ANCHOR] = csr
        _add_meta(
            out, path_col, path_col + VALUE_ID_TO_ANCHOR, "KeyValue", "MultiValue", False
        )

    # --- token relations --------------------------------------------------
    leaf_of_token = (
        np.repeat(np.arange(L, dtype=np.int64), np.diff(tok_off)) if T else np.empty(0, np.int64)
    )
    if en(I.TokensToTextID) and T:
        csr = csr_from_pairs(
            tokens, text_id[leaf_of_token], nk(tokens), sort_and_dedup=True
        )
        out.key_value_stores[p + TOKENS_TO_TEXT_ID] = csr
        _add_meta(out, path_col, p + TOKENS_TO_TEXT_ID, "KeyValue", "MultiValue", False)

    if en(I.TextIDToTokenIds) and T:
        # first leaf per text id with tokens, token order preserved
        has_toks = ntok > 0
        leaf_idx = np.flatnonzero(has_toks)
        _uniq, first_pos = np.unique(text_id[leaf_idx], return_index=True)
        chosen = leaf_idx[np.sort(first_pos)]
        counts = tok_off[chosen + 1] - tok_off[chosen]
        keys = np.repeat(text_id[chosen], counts)
        # select the chosen leaves' token ranges with a prefix-sum mask
        mark = np.zeros(T + 1, dtype=np.int64)
        np.add.at(mark, tok_off[chosen], 1)
        np.add.at(mark, tok_off[chosen + 1], -1)
        in_mask = np.cumsum(mark[:-1]) > 0
        vals = tokens[in_mask]
        csr = csr_from_pairs(keys, vals, nk(keys), stable=True)
        out.key_value_stores[p + TEXT_ID_TO_TOKEN_IDS] = csr
        _add_meta(out, path_col, p + TEXT_ID_TO_TOKEN_IDS, "KeyValue", "MultiValue", False)

    if en(I.TokenToAnchorIDScore) and L and ps.packed_scores is not None:
        offs, ancs, vals = ps.packed_scores
        out.anchor_scores[p + TO_ANCHOR_ID_SCORE] = AnchorScoreCsr(
            offsets=offs, anchors=ancs, scores=vals
        )
        _add_meta(out, path_col, p + TO_ANCHOR_ID_SCORE, "AnchorScore", "MultiValue", False)
    elif en(I.TokenToAnchorIDScore) and L:
        # exact text-level entries (pos=-1 marker)
        if num_terms:
            text_occ = np.where(
                text_id < num_terms,
                ps.occurrences[np.minimum(text_id, num_terms - 1)],
                1,
            ).astype(np.int64)
        else:
            text_occ = np.ones(L, dtype=np.int64)
        ids_parts = [text_id]
        anchors_parts = [anchor]
        pos_parts = [np.full(L, -1, dtype=np.int64)]
        occ_parts = [text_occ]
        ntok_parts = [np.ones(L, dtype=np.int64)]
        if len(ps.grp_token):
            # per-(leaf, token) first positions — emitted by the C++ core
            to_ = ps.grp_token.astype(np.int64)
            lo = ps.grp_leaf.astype(np.int64)
            ids_parts.append(to_)
            anchors_parts.append(anchor[lo])
            pos_parts.append(ps.grp_pos.astype(np.int64))
            occ_parts.append(ps.occurrences[to_].astype(np.int64))
            ntok_parts.append(ntok[lo])
        score_csr = _pack_anchor_scores(
            (
                np.concatenate(ids_parts),
                np.concatenate(anchors_parts),
                np.concatenate(pos_parts),
                np.concatenate(occ_parts),
                np.concatenate(ntok_parts),
            )
        )
        out.anchor_scores[p + TO_ANCHOR_ID_SCORE] = score_csr
        _add_meta(out, path_col, p + TO_ANCHOR_ID_SCORE, "AnchorScore", "MultiValue", False)

    if en(I.PhrasePairToAnchor) and len(ps.pair_a):
        pcsr = _pack_phrase(
            (
                ps.pair_a.astype(np.int64),
                ps.pair_b.astype(np.int64),
                ps.pair_anchor,
            )
        )
        out.phrase_indices[p + PHRASE_PAIR_TO_ANCHOR] = pcsr
        _add_meta(
            out, path_col, p + PHRASE_PAIR_TO_ANCHOR, "Phrase", "MultiValue", False
        )


def _pack_id_path(out: BuiltIndex, ip: NativeIdPath, config: FieldsConfig) -> None:
    field_config = config.get(ip.name)
    if len(ip.value_id) == 0:
        return
    if field_config.is_index_enabled(IndexCreationType.ValueIDToParent):
        direct = direct_from_pairs(
            ip.value_id.astype(np.int64), ip.parent_id, int(ip.value_id.max()) + 1
        )
        out.key_value_stores[ip.name + VALUE_ID_TO_PARENT] = direct
        _add_meta(
            out, ip.name, ip.name + VALUE_ID_TO_PARENT, "KeyValue", "SingleValue", False
        )
    if field_config.is_index_enabled(IndexCreationType.ParentToValueID):
        csr = csr_from_pairs(
            ip.parent_id.astype(np.int64), ip.value_id, int(ip.parent_id.max()) + 1
        )
        out.key_value_stores[ip.name + PARENT_TO_VALUE_ID] = csr
        _add_meta(
            out, ip.name, ip.name + PARENT_TO_VALUE_ID, "KeyValue", "MultiValue", False
        )
