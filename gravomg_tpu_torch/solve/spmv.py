"""ELL sparse matrix-vector products (counterpart of
``gravomg_tpu/solve/spmv.py``): a fixed-shape gather, multiply and
row reduce.  A stack of operators (leading mesh axis,
``parallel/batch.py``) takes a (B, V) x, one row per mesh."""

from __future__ import annotations

import torch

from gravomg_tpu_torch.types import EllOperator, batched_take


def spmv(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A x for (V,) or (V, D) x; for a stack of operators, (B, V) x."""
    safe = op.safe_neighbors()
    w = torch.where(op.mask, op.offdiag, torch.zeros_like(op.offdiag))
    if op.diag.ndim == 2:
        return op.diag * x + torch.sum(w * batched_take(x, safe), dim=2)
    if x.ndim == 1:
        return op.diag * x + torch.sum(w * x[safe], dim=1)
    return op.diag[:, None] * x + torch.einsum("vk,vkd->vd", w, x[safe])


def residual(op: EllOperator, x: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    return b - spmv(op, x)
