"""Jacobi-preconditioned conjugate gradients, one independent recursion
per column of a (V, C) right-hand side, in the operator's dtype."""

from __future__ import annotations

import torch

from benchmark.reference.graph import RefOperator

CHECK_EVERY = 25         # iterations between the host's convergence tests


def cg(a: RefOperator, b: torch.Tensor, tol: float = 1e-12,
       max_iters: int = 40_000) -> torch.Tensor:
    """x with ||b - A x|| <= ``tol`` ||b|| in every column, or after
    ``max_iters`` iterations (a dtype that cannot reach ``tol`` runs them
    all).  ``b`` (V, C) is cast to the operator's dtype."""
    b = b.to(a.diag.dtype)
    dinv = (1.0 / a.diag)[:, None]
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z
    rz = (r * z).sum(dim=0)
    bnorm = torch.linalg.norm(b.float(), dim=0)
    for it in range(max_iters):
        ap = a(p)
        alpha = rz / (p * ap).sum(dim=0)
        x = x + alpha * p
        r = r - alpha * ap
        if it % CHECK_EVERY == 0 and bool(
                (torch.linalg.norm(r.float(), dim=0) <= tol * bnorm).all()):
            break
        z = dinv * r
        rz_new = (r * z).sum(dim=0)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x
