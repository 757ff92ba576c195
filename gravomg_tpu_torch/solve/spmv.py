"""ELL sparse matrix-vector products (counterpart of
``gravomg_tpu/solve/spmv.py``): a fixed-shape gather, multiply and
row reduce."""

from __future__ import annotations

import torch

from gravomg_tpu_torch.types import EllOperator


def spmv(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A x for (V,) or (V, D) x."""
    safe = op.safe_neighbors()
    w = torch.where(op.mask, op.offdiag, torch.zeros_like(op.offdiag))
    if x.ndim == 1:
        return op.diag * x + torch.sum(w * x[safe], dim=1)
    return op.diag[:, None] * x + torch.einsum("vk,vkd->vd", w, x[safe])


def residual(op: EllOperator, x: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    return b - spmv(op, x)
