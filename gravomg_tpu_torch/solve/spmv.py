"""ELL sparse matrix-vector products (counterpart of
``gravomg_tpu/solve/spmv.py``).  A stack of operators (leading mesh
axis, ``parallel/batch.py``) takes a (B, V) x, one row per mesh.

:func:`spmv` sends one operator with float32 values and a (V,) or
(V, D) float32 x on the card to the kernel E1 (``ops/ell_cuda.py``), one
launch a product; stacks, other dtypes (the f64 refinement of
``solve/vcycle.py``) and CPU tensors take :func:`spmv_plain`, the
kernel's twin: a fixed-shape gather, multiply and row reduce."""

from __future__ import annotations

import torch

from gravomg_tpu_torch.ops.ell_cuda import ell_spmv_cuda
from gravomg_tpu_torch.types import EllOperator, batched_take


def spmv(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A x for (V,) or (V, D) x; for a stack of operators, (B, V) x."""
    if (x.is_cuda and op.diag.ndim == 1 and x.dtype == torch.float32
            and op.offdiag.dtype == torch.float32):
        return ell_spmv_cuda(op, x.contiguous())
    return spmv_plain(op, x)


def spmv_plain(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """:func:`spmv` in plain torch, any dtype and device."""
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
