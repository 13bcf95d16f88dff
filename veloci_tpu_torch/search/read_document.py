"""Document reconstruction from indices alone ("select"): the port's copy of
``veloci_tpu/search/read_document.py``, reading a :class:`..persistence.TorchIndex`'s
host stores.

Reference: src/search/read_document.rs (`read_data` / `read_tree`) +
`join_and_get_text_for_ids` (src/search.rs:242-269), including the long-text
escape hatch: text ids beyond `num_text_ids` are rebuilt by concatenating
their token texts from `.text_id_to_token_ids`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..create import PARENT_TO_VALUE_ID, TEXT_ID_TO_TOKEN_IDS, TEXTINDEX
from ..error import MissingTextIdError
from ..indices import Direct
from ..utils import LEAF, NodeTree, extract_prop_name, get_all_steps_to_anchor, to_node_tree

__all__ = ["read_data", "read_tree", "get_read_tree_from_fields"]


def get_read_tree_from_fields(persistence, fields: List[str]) -> NodeTree:
    """Reference src/search.rs:272-279."""
    all_steps = [
        get_all_steps_to_anchor(field)
        for field in fields
        if persistence.has_index(field + TEXTINDEX + PARENT_TO_VALUE_ID)
    ]
    return to_node_tree(all_steps)


def _join_for_1_to_n(persistence, vid: int, path: str) -> Optional[List[int]]:
    store = persistence.key_value_stores.get(path)
    if store is None:
        return None
    vals = store.get_values(int(vid))
    return [int(v) for v in vals] if len(vals) else None


def _join_and_get_text_for_ids(persistence, vid: int, prop: str) -> Optional[str]:
    """Reference src/search.rs:242-269."""
    field_name = prop + TEXTINDEX
    store = persistence.key_value_stores.get(field_name + PARENT_TO_VALUE_ID)
    if store is None:
        return None
    if isinstance(store, Direct):
        text_value_id = store.get_value(int(vid))
    else:
        vals = store.get_values(int(vid))
        text_value_id = int(vals[0]) if len(vals) else None
    if text_value_id is None:
        return None
    num_text_ids = persistence.num_text_ids(prop)
    if text_value_id >= num_text_ids:
        # long-text escape hatch: rebuild from token ids
        t2t = persistence.key_value_stores.get(field_name + TEXT_ID_TO_TOKEN_IDS)
        if t2t is None or not t2t.has_values(text_value_id):
            raise MissingTextIdError(
                f"text id {text_value_id} missing in {field_name + TEXT_ID_TO_TOKEN_IDS}"
            )
        dictionary = persistence.get_dictionary(prop)
        return "".join(
            dictionary.ord_to_term(int(tok)) for tok in t2t.get_values(text_value_id)
        )
    dictionary = persistence.get_dictionary(prop)
    return dictionary.ord_to_term(text_value_id)


def read_tree(persistence, anchor_id: int, tree: NodeTree) -> Any:
    """Reference read_document.rs:14-59."""
    json_out: Dict[str, Any] = {}
    if tree == LEAF:
        return json_out
    for prop, sub_tree in tree.items():
        current_path = prop + PARENT_TO_VALUE_ID
        is_array = prop.endswith("[]")
        if sub_tree == LEAF:
            if is_array:
                sub_ids = _join_for_1_to_n(persistence, anchor_id, current_path)
                if sub_ids is not None:
                    sub_data = []
                    for sid in sub_ids:
                        texto = _join_and_get_text_for_ids(persistence, sid, prop)
                        if texto is not None:
                            sub_data.append(texto)
                    json_out[extract_prop_name(prop)] = sub_data
            else:
                texto = _join_and_get_text_for_ids(persistence, anchor_id, prop)
                if texto is not None:
                    json_out[extract_prop_name(prop)] = texto
        else:
            if not persistence.has_index(current_path):
                # object-in-object with no ids of its own
                json_out[extract_prop_name(prop)] = read_tree(
                    persistence, anchor_id, sub_tree
                )
            else:
                sub_ids = _join_for_1_to_n(persistence, anchor_id, current_path)
                if sub_ids is not None:
                    if is_array:
                        json_out[extract_prop_name(prop)] = [
                            read_tree(persistence, sid, sub_tree) for sid in sub_ids
                        ]
                    elif sub_ids:
                        json_out[extract_prop_name(prop)] = read_tree(
                            persistence, sub_ids[0], sub_tree
                        )
    return json_out


def read_data(persistence, anchor_id: int, fields: List[str]) -> Any:
    tree = get_read_tree_from_fields(persistence, fields)
    return read_tree(persistence, anchor_id, tree)
