"""Boost pieces of the batched route: score expressions, the single-hit boost
a token-value leaf applies, and matched ids -> anchors for filters.

Counterpart of ``ScoreExpression`` (``veloci_tpu/search/boost.py:53``),
``apply_boost_scalar`` (``:102``), ``_expr_vec_jnp`` (``:277``) and
``resolve_ids_to_anchor`` (``:309``); reference src/search/boost.rs and
src/expression.rs. The per-document boost columns themselves apply at the
tree route's candidate anchors (:mod:`..ops.generic_step`,
:func:`..ops.tree_step._apply_boost_gathered`).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..create import TEXT_ID_TO_ANCHOR
from ..error import VelociError

__all__ = ["ScoreExpression", "apply_boost_scalar", "expr_vec", "resolve_ids_to_anchor"]

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
