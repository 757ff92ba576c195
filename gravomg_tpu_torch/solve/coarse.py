"""Coarsest-level direct solve: dense Cholesky on the device
(counterpart of ``gravomg_tpu/solve/coarse.py``)."""

from __future__ import annotations

import torch

from gravomg_tpu_torch.types import EllOperator


def factor_coarse(op: EllOperator,
                  shift_scales=(1e-10, 1e-6, 1e-4)) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrised, densified operator.

    Deep f32 Galerkin chains can leave the coarsest operator slightly
    asymmetric and indefinite in the last digits, so the smallest
    relative diagonal shift from ``shift_scales`` whose factorisation
    succeeds is taken (``cholesky_ex`` reports failure in ``info``).
    Raises if none does; a failed factor is never returned.
    """
    a = op.as_dense()
    a = 0.5 * (a + a.T)
    base = torch.max(torch.abs(op.diag))
    eye = torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    for s in shift_scales:
        chol, info = torch.linalg.cholesky_ex(a + (s * base) * eye)
        if int(info) == 0:
            return chol
    raise RuntimeError(
        f"factor_coarse: no shift in {shift_scales} makes the "
        f"{a.shape[0]}x{a.shape[0]} coarsest operator positive definite")


def coarse_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b for (n,) or (n, D) b; for a stack of factors
    (B, n, n), (B, n) b, each mesh against its own factor."""
    vec = b.ndim == chol.ndim - 1
    rhs = b[..., None] if vec else b
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.mT, y, upper=True)
    return x[..., 0] if vec else x
