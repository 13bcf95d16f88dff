"""Boost pieces: score expressions, the single-hit boost a token-value leaf
applies, matched ids -> anchors for filters, and the per-request executor's
boosts over a dense ``[num_docs]`` plane.

Counterpart of ``ScoreExpression`` (``veloci_tpu/search/boost.py:53``),
``apply_boost_scalar`` (``:102``), ``apply_boost_dense_device`` (``:176``),
``apply_anchor_boost_values_device`` (``:208``), ``scatter_factor_device``
(``:258``), ``_expr_vec_jnp`` (``:277``), ``resolve_ids_to_anchor``
(``:309``), ``boost_to_anchor_values`` (``:322``), ``anchor_boost_accs``
(``:382``), ``term_boost_factor_device`` (``:471``, B10) and
``text_locality_boost`` (``:515``); reference src/search/boost.rs and
src/expression.rs. On the
batched route the per-document boost columns apply at the tree route's
candidate anchors (:mod:`..ops.generic_step`,
:func:`..ops.tree_step._apply_boost_gathered`).

The 1:n boosts and the phrase factor take small ``(anchor, value)`` lists
that may name an anchor more than once. They are accumulated on the host,
in list order, per distinct anchor (as the reference's XLA scatters apply
them on the CPU), uploaded once and applied with a gather, so that the card
and the CPU give the same bits; logarithms are taken on the host too.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..create import (
    BOOST_VALID_TO_VALUE,
    TEXT_ID_TO_ANCHOR,
    TEXTINDEX,
    TOKENS_TO_TEXT_ID,
    VALUE_ID_TO_ANCHOR,
    VALUE_ID_TO_PARENT,
)
from ..error import VelociError
from ..indices import EMPTY, Direct
from ..ops.generic_step import _HIT_EPS

__all__ = [
    "ScoreExpression",
    "anchor_boost_accs",
    "apply_anchor_boost_values_device",
    "apply_boost_dense_device",
    "apply_boost_scalar",
    "boost_to_anchor_values",
    "expr_vec",
    "resolve_ids_to_anchor",
    "scatter_factor_device",
    "resolve_part_anchors",
    "term_boost_anchors",
    "term_boost_factor_device",
    "text_locality_boost",
]

_F32 = np.float32


class ScoreExpression:
    """Tiny `x op y` interpreter with `$SCORE` (reference src/expression.rs)."""

    def __init__(self, expression: str):
        self.expression = expression
        ops: List = []
        current = ""
        for ch in expression:
            if ch == " ":
                try:
                    ops.append(float(current))
                except ValueError:
                    pass
                current = ""
                continue
            current += ch
            if current in ("+", "-", "/", "*", "$SCORE"):
                ops.append(current)
                current = ""
        try:
            ops.append(float(current))
        except ValueError:
            pass
        self.ops = ops

    def get_score(self, rank: float) -> float:
        """IEEE-754 f32 arithmetic as the reference evaluates it
        (expression.rs:26-46): division by zero yields +/-inf, 0/0 NaN."""

        def val(op):
            return rank if op == "$SCORE" else op

        left = _F32(val(self.ops[0]))
        right = _F32(val(self.ops[2]))
        op = self.ops[1]
        with np.errstate(divide="ignore", invalid="ignore"):
            if op == "/":
                return float(left / right)
            if op == "*":
                return float(left * right)
            if op == "+":
                return float(left + right)
            if op == "-":
                return float(left - right)
        raise VelociError(f"invalid expression {self.expression!r}")


def apply_boost_scalar(score: float, boost_value: float, boost_part) -> float:
    """Single-hit boost application (reference boost.rs:283-379 `apply_boost`)."""
    param = _F32(boost_part.param or 0.0)
    bv = _F32(boost_value) + param
    fun = boost_part.boost_fun
    score = _F32(score)
    # IEEE f32: log of 0 is -inf, of negatives NaN (Rust f32::log10)
    with np.errstate(divide="ignore", invalid="ignore"):
        if fun == "Log10":
            score = score * _F32(np.log10(bv))
        elif fun == "Log2":
            score = score * _F32(np.log2(bv))
        elif fun == "Multiply":
            score = score * bv
        elif fun == "Add":
            score = score + bv
        elif fun == "Replace":
            score = bv
    if boost_part.expression:
        score = score + _F32(ScoreExpression(boost_part.expression).get_score(boost_value))
    return float(score)


def expr_vec(expr: ScoreExpression, ranks):
    """The expression over an f32 tensor of ranks ($SCORE = each boost
    value), in f32."""

    def val(op):
        return ranks if op == "$SCORE" else torch.full_like(ranks, float(_F32(op)))

    a, b = val(expr.ops[0]), val(expr.ops[2])
    op = expr.ops[1]
    if op == "/":
        return a / b
    if op == "*":
        return a * b
    if op == "+":
        return a + b
    return a - b


def resolve_ids_to_anchor(index, path: str, ids: np.ndarray) -> np.ndarray:
    """Matched text ids -> anchor ids (ids-only path of
    `resolve_token_to_anchor`, search_field.rs:467-495)."""
    if len(ids) == 0:
        return np.empty(0, dtype=np.int64)
    if index.is_anchor_identity_column(path):
        return np.asarray(ids, dtype=np.int64)
    tia = index.key_value_stores.get(path + TEXT_ID_TO_ANCHOR)
    if tia is None:
        return np.empty(0, dtype=np.int64)
    return tia.get_values_multi(np.asarray(ids)).astype(np.int64)


def apply_boost_dense_device(dense: torch.Tensor, pre) -> torch.Tensor:
    """A boost column over the dense plane (``apply_boost_dense_device``,
    ``:176``; ``pre`` from :func:`..ops.generic_step._precompute_boost`,
    its factors computed on the host): only hits (score > 0) with a present
    value are boosted, ``skip_when_score`` exempts scores within 1e-5 of a
    listed value, and a boosted score floors at 1e-30."""
    mode, fac, pres, skip, expr_add, _folded = pre
    if mode == "mul":
        boosted = dense * fac
    elif mode == "add":
        boosted = dense + fac
    elif mode == "replace":
        boosted = fac
    else:
        boosted = dense
    if expr_add is not None:
        boosted = boosted + expr_add
    apply_mask = (dense > 0) & pres
    for sv in skip:
        apply_mask &= torch.abs(dense - float(np.float32(sv))) >= 1e-5
    return torch.where(apply_mask, torch.clamp(boosted, min=_HIT_EPS), dense)


def _has_values(store, keys: np.ndarray) -> np.ndarray:
    """Per key of a relation column: whether it holds a value."""
    ok = (keys >= 0) & (keys < store.num_keys)
    safe = np.where(ok, keys, 0)
    if isinstance(store, Direct):
        return ok & (store.values[safe] != EMPTY)
    return ok & (store.offsets[safe + 1] != store.offsets[safe])


def boost_to_anchor_values(index, field_path: str, boost_part, matched_term_ids):
    """The 1:n boost chain (``boost_to_anchor_values``, ``:322``; plan step
    ``BoostToAnchor``, plan_steps.rs:207-233): token ids -> text ids ->
    parent value ids -> boost values -> anchors. Returns ``(anchors int64,
    boost values f32)`` in parent value id order, the anchor of a value its
    first one in the boost field's ``.value_id_to_anchor``."""
    path = field_path if field_path.endswith(TEXTINDEX) else field_path + TEXTINDEX
    none = np.empty(0, np.int64), np.empty(0, _F32)
    ids = np.asarray(matched_term_ids, dtype=np.int64)
    tta = index.key_value_stores.get(path + TOKENS_TO_TEXT_ID)
    if index.tokenize_enabled(path) and tta is not None and len(ids):
        # a token with text ids maps to them, one without stays itself
        has = _has_values(tta, ids)
        ids = np.unique(np.concatenate([tta.get_values_multi(ids[has]).astype(np.int64), ids[~has]]))
    v2p = index.key_value_stores.get(path + VALUE_ID_TO_PARENT)
    if v2p is None:
        return none
    value_ids = np.unique(v2p.get_values_multi(ids).astype(np.int64))
    boost_field = boost_part.path
    if boost_field.endswith(BOOST_VALID_TO_VALUE):
        boost_field = boost_field[: -len(BOOST_VALID_TO_VALUE)]
    vals, present = index.get_boost(boost_field + BOOST_VALID_TO_VALUE)
    keep = value_ids[value_ids < len(vals)]
    keep = keep[present[keep]]
    v2a = index.key_value_stores.get(boost_field + VALUE_ID_TO_ANCHOR)
    if v2a is None:
        return none
    has = _has_values(v2a, keep)
    keep = keep[has]
    if isinstance(v2a, Direct):
        anchors = v2a.values[keep]
    else:
        anchors = v2a.values[v2a.offsets[keep].astype(np.int64)]
    return anchors.astype(np.int64), vals[keep].astype(_F32)


class AnchorBoost(NamedTuple):
    """A 1:n boost accumulated per distinct anchor, on the host: each plane
    None when the boost function does not use it."""

    anchors: np.ndarray  # [U] int64, ascending
    factor: Optional[np.ndarray]  # [U] f32 product of the factors (Log10 / Log2 / Multiply)
    add: Optional[np.ndarray]  # [U] f32 sum of value + param (Add)
    replace: Optional[np.ndarray]  # [U] f32 last value + param (Replace), NaN = none
    expr_add: Optional[np.ndarray]  # [U] f32 sum of the expression's values


def anchor_boost_accs(n: int, anchors, boost_vals, boost_part, host_sums: bool = False) -> AnchorBoost:
    """Per distinct anchor below ``n``, the 1:n boost's accumulations in list
    order (``anchor_boost_accs``, ``:382``, and the scatters of
    ``apply_anchor_boost_values_device``, ``:208-255``): products of the
    factors, sums of the added values, the last replacement, and sums of the
    expression's values, each in f32. With ``host_sums`` and an ``Add``
    boost, the expression's values are added on to the sums of the added
    values (the reference's one host accumulator) and ``expr_add`` is None."""
    anchors = np.asarray(anchors, dtype=np.int64)
    keep = anchors < n
    anchors = anchors[keep]
    boost_vals = np.asarray(boost_vals, dtype=_F32)[keep]
    b = boost_vals + _F32(boost_part.param or 0.0)
    u, inv = np.unique(anchors, return_inverse=True)
    fun = boost_part.boost_fun
    factor = add = replace = expr_add = None
    with np.errstate(divide="ignore", invalid="ignore"):
        if fun in ("Log10", "Log2", "Multiply"):
            if fun == "Log10":
                factors = np.log10(b, dtype=_F32)
            elif fun == "Log2":
                factors = np.log2(b, dtype=_F32)
            else:
                factors = b
            factor = np.ones(len(u), dtype=_F32)
            np.multiply.at(factor, inv, factors)
        elif fun == "Add":
            add = np.zeros(len(u), dtype=_F32)
            np.add.at(add, inv, b)
        elif fun == "Replace":
            replace = np.full(len(u), np.nan, dtype=_F32)
            last = len(anchors) - 1 - np.unique(anchors[::-1], return_index=True)[1]
            replace[:] = b[last]
    if boost_part.expression:
        expr = ScoreExpression(boost_part.expression)
        adds = expr_vec(expr, torch.from_numpy(boost_vals)).numpy()
        if host_sums and add is not None:
            np.add.at(add, inv, adds)
        else:
            expr_add = np.zeros(len(u), dtype=_F32)
            np.add.at(expr_add, inv, adds)
    return AnchorBoost(u, factor, add, replace, expr_add)


def apply_anchor_boost_values_device(dense: torch.Tensor, anchors, boost_vals, boost_part,
                                     host_sums: bool = False) -> torch.Tensor:
    """A 1:n boost's ``(anchor, value)`` lists over the dense plane
    (``apply_anchor_boost_values_device``, ``:208``): accumulated per anchor
    on the host (:func:`anchor_boost_accs`), uploaded once and applied at
    their anchors with a gather; at hits only, the factor, then the sum, the
    replacement, the expression's sum, in that order, each rounded apart.
    Then every hit floors at 1e-30; empty lists leave the plane as it is.

    ``host_sums``: the reference's host form (``apply_anchor_boost_values``,
    ``:421``, which its executor takes with explain) instead, whose one
    accumulator adds the expression's values after the ``Add`` values, in
    list order, before the plane does."""
    if not len(anchors):
        return dense
    dev = dense.device
    acc = anchor_boost_accs(dense.shape[0], anchors, boost_vals, boost_part, host_sums)
    out = torch.where(dense > 0, torch.clamp(dense, min=_HIT_EPS), dense)
    if not len(acc.anchors):
        return out
    a = torch.from_numpy(acc.anchors).to(dev)
    cur = dense[a]
    hit = cur > 0
    val = cur
    if acc.factor is not None:
        val = torch.where(hit, val * torch.from_numpy(acc.factor).to(dev), val)
    if acc.add is not None:
        val = torch.where(hit, val + torch.from_numpy(acc.add).to(dev), val)
    if acc.replace is not None:
        repl = torch.from_numpy(acc.replace).to(dev)
        val = torch.where(hit & ~torch.isnan(repl), repl, val)
    if acc.expr_add is not None:
        val = torch.where(hit, val + torch.from_numpy(acc.expr_add).to(dev), val)
    out[a] = torch.where(hit, torch.clamp(val, min=_HIT_EPS), val)
    return out


def scatter_factor_device(dense: torch.Tensor, anchors, factor: float) -> torch.Tensor:
    """The plane times ``factor`` once for each time an anchor below
    ``num_docs`` appears in ``anchors`` (``scatter_factor_device``,
    ``:258``); the product per distinct anchor is taken on the host, in
    f32, one multiply at a time."""
    anchors = np.asarray(anchors, dtype=np.int64)
    u, inv = np.unique(anchors[anchors < dense.shape[0]], return_inverse=True)
    if not len(u):
        return dense
    prod = np.ones(len(u), dtype=_F32)
    np.multiply.at(prod, inv, _F32(factor))
    a = torch.from_numpy(u).to(dense.device)
    out = dense.clone()
    out[a] = dense[a] * torch.from_numpy(prod).to(dense.device)
    return out


TERM_BOOST_CACHE_LIMIT = 512  # entries; the cache is emptied past it, as the reference's


def resolve_part_anchors(index, part, ids):
    """A ``boost_term`` part's matched term ``ids`` resolved to its anchors
    below ``num_docs``, on the device, with the most times one anchor
    appears among them: ``(anchors, most)``."""
    path = part.path if part.path.endswith(TEXTINDEX) else part.path + TEXTINDEX
    anchors = resolve_ids_to_anchor(index, path, ids)
    anchors = anchors[anchors < index.num_docs]
    most = int(np.unique(anchors, return_counts=True)[1].max(initial=0))
    return torch.from_numpy(anchors).to(index.device), most


def term_boost_anchors(index, boost_terms, fuzzy) -> list:
    """Each ``boost_term`` part's ``(anchors, most)``
    (:func:`resolve_part_anchors` of its matched ids), cached per part key in
    ``index.term_boost_cache`` (reference ``term_boost_cache``,
    persistence.rs:67) and emptied past 512 entries; hits and misses are
    counted on ``index.path_counts``.

    Every part is looked up before anything is inserted, so a part found
    cached keeps its anchors when a later part's miss (or another request)
    empties the cache. A missed part's fuzzy matches come from ``fuzzy``, the
    request's prefetch, where they are there; the rest are swept here in one
    prefetch."""
    from .field_search import fuzzy_spec, match_term_ids, prefetch_fuzzy_matches  # it imports this module

    cache = index.term_boost_cache
    found = {}
    missing = {}  # key -> its first part
    for part in boost_terms:
        key = part.key()
        repeat = key in found  # resolved once for the request, as the reference's second lookup hits
        if not repeat:
            found[key] = cache.get(key)
            if found[key] is None:
                missing[key] = part
        index.count_path("term_boost_cache_hit" if repeat or key not in missing else "term_boost_cache_miss")
    specs = {s for s in map(fuzzy_spec, missing.values()) if s is not None and s not in fuzzy}
    if specs:
        fuzzy = {**fuzzy, **prefetch_fuzzy_matches(index, specs)}
    for key, part in missing.items():
        found[key] = resolve_part_anchors(index, part, match_term_ids(index, part, fuzzy)[0])
        if len(cache) > TERM_BOOST_CACHE_LIMIT:
            cache.clear()
        cache[key] = found[key]
    return [found[p.key()] for p in boost_terms]


def term_boost_factor_device(index, boost_terms, anchors) -> torch.Tensor:
    """The ``boost_term`` factor, ``[num_docs]`` f32 on the index's device
    (B10; ``term_boost_factor_device``, ``:471``; reference
    apply_boost_term, boost.rs:89-196): per part, in order, its
    ``(anchors, most)`` from :func:`term_boost_anchors`, each anchor's
    occurrences counted on the device, and the factor multiplied by
    ``boost ** count`` (boost 2.0 by default). The powers are
    ``np.power`` in f32 on the host for the counts 0..most, gathered at
    each anchor's count: the factor is the reference's ``term_boost_factor``
    bit for bit, whatever the device's ``powf``."""
    n = index.num_docs
    factor = torch.ones(n, dtype=torch.float32, device=index.device)
    for part, (part_anchors, most) in zip(boost_terms, anchors):
        if not len(part_anchors):
            continue
        boost = _F32(part.boost if part.boost is not None else 2.0)
        powers = np.power(boost, np.arange(most + 1, dtype=_F32), dtype=_F32)
        counts = torch.bincount(part_anchors, minlength=n)
        factor = factor * torch.from_numpy(powers).to(index.device)[counts]
    return factor


def text_locality_boost(index, term_id_hits_in_field, num_docs: int) -> np.ndarray:
    """The text-locality factor per anchor, ``[num_docs]`` f32 on the host
    (``text_locality_boost``, ``:515``; reference boost_text_locality,
    boost.rs:11-87): on a path where two or more leaves hit, a text that
    n of their matched terms land in gets ``2 * n * n``; an anchor takes the
    least such boost of its texts (the reference's reversed comparator),
    every other anchor 1."""
    all_anchors, all_boosts = [], []
    for path, term_with_ids in term_id_hits_in_field.items():
        if len(term_with_ids) <= 1:
            continue
        tta = index.key_value_stores.get(path + TOKENS_TO_TEXT_ID)
        if tta is None:
            continue
        concat = np.concatenate(
            [tta.get_values_multi(np.asarray(ids, np.int64)) for ids in term_with_ids.values()]
        )
        if len(concat) == 0:
            continue
        counts = np.bincount(concat.astype(np.int64))
        text_ids = np.flatnonzero(counts > 1)
        if len(text_ids) == 0:
            continue
        n_hits = counts[text_ids].astype(_F32)
        boosts = _F32(2.0) * n_hits * n_hits
        if index.is_anchor_identity_column(path):
            all_anchors.append(text_ids.astype(np.int64))
            all_boosts.append(boosts)
            continue
        tia = index.key_value_stores.get(path + TEXT_ID_TO_ANCHOR)
        if tia is None:
            continue
        for tid, bv in zip(text_ids, boosts):
            anchors = tia.get_values(int(tid))
            if len(anchors):
                all_anchors.append(anchors.astype(np.int64))
                all_boosts.append(np.full(len(anchors), bv, dtype=_F32))
    factor = np.ones(num_docs, dtype=_F32)
    if not all_anchors:
        return factor
    anchors, boosts = np.concatenate(all_anchors), np.concatenate(all_boosts)
    keep = anchors < num_docs
    best = np.full(num_docs, np.inf, dtype=_F32)
    np.minimum.at(best, anchors[keep], boosts[keep])
    has = np.isfinite(best)
    factor[has] = best[has]
    return factor
