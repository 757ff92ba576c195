"""Geodesic distance by the heat method, as the port's
``heat_geodesics`` states it (module doc of ``apps/heat.py``):

  1. (M + t L) u = M delta_source, t = t_factor x (mean edge length)^2;
  2. X_ij = -sign((u_j - u_i) / d_ij) on the directed edges, the
     divergence div_i = sum_j X_ij / d_ij;
  3. (L + eps M) phi = div - mean(div), eps = 1e-4 mean(diag) / mean(M);
  4. phi <- phi[source] - phi, scaled to a mean |edge gradient| of 1.

Both solves are direct Jacobi-CG on the operators themselves (no
hierarchy), one column per source.
"""

from __future__ import annotations

from typing import Sequence

import torch

from benchmark.reference.graph import (RefGraph, RefOperator, laplacian,
                                       mean_edge_length, screened)
from benchmark.reference.solve import cg


def heat_distances(g: RefGraph, sources: Sequence[int], t_factor: float,
                   dtype=torch.float64, tol: float = 1e-12,
                   max_iters: int = 40_000) -> torch.Tensor:
    """(V, len(sources)) distances, computed in ``dtype``."""
    lap, mass = laplacian(g)
    t = t_factor * mean_edge_length(g) ** 2
    v, c = mass.shape[0], len(sources)
    cols = torch.arange(c, device=mass.device)
    src = torch.as_tensor(list(sources), device=mass.device)
    rhs = torch.zeros((v, c), dtype=mass.dtype, device=mass.device)
    rhs[src, cols] = mass[src]
    heat_op = RefOperator(lap.neighbors, lap.offdiag * t, lap.diag * t + mass)
    u = cg(heat_op.to(dtype), rhs, tol, max_iters)

    mask = g.mask[:, :, None]
    d = g.distances.to(dtype)[:, :, None]
    nbr = g.safe_neighbors()
    x = -torch.sign((u[nbr] - u[:, None, :]) / d)
    w = torch.where(mask, 1.0 / torch.clamp(d, min=1e-8), torch.zeros_like(d))
    div = torch.sum(w * torch.where(mask, x, torch.zeros_like(x)), dim=1)
    phi = cg(screened(lap, mass).to(dtype), div - div.mean(dim=0), tol,
             max_iters)
    phi = phi[src, cols][None, :] - phi
    grad = torch.abs(phi[nbr] - phi[:, None, :]) / d
    grad = torch.where(mask, grad, torch.zeros_like(grad))
    mean_grad = grad.sum(dim=(0, 1)) / g.mask.sum()
    return phi / torch.clamp(mean_grad, min=1e-12)
