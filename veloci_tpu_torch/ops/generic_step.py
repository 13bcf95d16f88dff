"""Per-document boost factors of the batched tree route.

Counterpart of ``_precompute_boost`` (``veloci_tpu/ops/generic_step.py:46``)
for :func:`.tree_step._apply_boost_gathered`, which reads the factors at
candidate anchors only. The dense-plane forms of that module
(``tree_dense*``, ``phrase_factor``, ``batched_generic_topk``) serve the
reference's mesh route and are not ported here.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["_precompute_boost", "_HIT_EPS"]

# boosted hits floor here, so a boost that yields 0 or less keeps the hit
_HIT_EPS = float(np.float32(1e-30))


def _precompute_boost(bv, pres, spec):
    """Per-doc boost factor arrays, computed once per boost column and spec.

    ``bv [num_docs]`` f32 boost values, ``pres [num_docs]`` bool presence,
    ``spec = (fun, param, skip_when_score tuple, expression add vector or
    None)`` (reference boost.rs:283-379). Returns ``(mode, fac, pres, skip,
    expr_add, folded)``: with no ``skip_when_score`` and a mul / add / no
    function the presence folds into the factors (absent -> multiplier 1,
    adder 0), ``folded = (m, a)``, either may be None."""
    fun, param, skip, expr_add = spec
    b = bv + float(np.float32(param or 0.0))
    if fun in ("Log10", "Log2"):
        # numpy's f32 logarithm, as the reference's host boost takes it
        # (torch's rounds otherwise on some values)
        with np.errstate(divide="ignore", invalid="ignore"):
            log = np.log10 if fun == "Log10" else np.log2
            fac, mode = torch.from_numpy(log(b.cpu().numpy(), dtype=np.float32)).to(b.device), "mul"
    elif fun == "Multiply":
        fac, mode = b, "mul"
    elif fun == "Add":
        fac, mode = b, "add"
    elif fun == "Replace":
        fac, mode = b, "replace"
    else:
        fac, mode = None, "none"
    folded = None
    if not skip and mode in ("mul", "add", "none"):
        if mode == "mul":
            m = torch.where(pres, fac, 1.0)
            a = torch.where(pres, expr_add, 0.0) if expr_add is not None else None
        else:  # add / none
            base = fac if mode == "add" else torch.zeros_like(bv)
            add_vec = base + expr_add if expr_add is not None else base
            m = None
            a = torch.where(pres, add_vec, 0.0)
        folded = (m, a)
    return (mode, fac, pres, tuple(skip or ()), expr_add, folded)
