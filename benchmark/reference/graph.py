"""The front end, worked out again: the symmetrised kNN graph of the
points (a SciPy k-d tree on the host, in float64), its inverse-distance
Laplacian L = D - W and lumped mass (the mean squared edge length at a
vertex), and the screened-Poisson operator L + alpha M with the shift
"auto" (1e-4 of the mean diagonal over the mean mass)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial import cKDTree


class RefGraph(NamedTuple):
    """Rows padded to the largest degree: neighbours ascending, -1 in
    padding; edge lengths, +inf in padding."""
    neighbors: torch.Tensor      # (V, D) int64
    distances: torch.Tensor      # (V, D)

    @property
    def mask(self) -> torch.Tensor:
        return self.neighbors >= 0

    def safe_neighbors(self) -> torch.Tensor:
        return torch.clamp(self.neighbors, min=0)


class RefOperator:
    """A x = diag * x + sum over a row of offdiag * x[neighbours]:
    ``neighbors`` (V, D) int64, -1 in padding; ``offdiag`` (V, D), 0 in
    padding; ``diag`` (V,).  In float64 the sum is one sparse CSR
    product; in any other dtype (the bfloat16 control, which the sparse
    product does not take) a gather."""

    def __init__(self, neighbors: torch.Tensor, offdiag: torch.Tensor,
                 diag: torch.Tensor):
        self.neighbors, self.offdiag, self.diag = neighbors, offdiag, diag
        self.csr = None
        if diag.dtype == torch.float64:
            mask = neighbors >= 0
            crow = torch.zeros(diag.shape[0] + 1, dtype=torch.int64,
                               device=diag.device)
            crow[1:] = torch.cumsum(mask.sum(dim=1), 0)
            self.csr = torch.sparse_csr_tensor(
                crow, neighbors[mask], offdiag[mask],
                size=(diag.shape[0], diag.shape[0]))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """A @ x for x (V,) or (V, C)."""
        d = self.diag if x.ndim == 1 else self.diag[:, None]
        if self.csr is not None:
            return d * x + self.csr @ x
        nbr = torch.clamp(self.neighbors, min=0)
        off = self.offdiag if x.ndim == 1 else self.offdiag[:, :, None]
        return d * x + torch.sum(off * x[nbr], dim=1)

    def to(self, dtype) -> "RefOperator":
        return RefOperator(self.neighbors, self.offdiag.to(dtype),
                           self.diag.to(dtype))


def knn_graph(points: np.ndarray, k: int, device) -> RefGraph:
    """The symmetrised graph of each point's ``k`` nearest others: the
    k-d tree on the host, the rest on ``device``."""
    p = np.asarray(points, np.float64)
    v = p.shape[0]
    _, idx = cKDTree(p).query(p, k=k + 1, workers=-1)
    # Drop each point itself (the last column where a duplicate point
    # pushed it out of its own list).
    own = idx == np.arange(v)[:, None]
    own[~own.any(axis=1), k] = True
    cols = torch.as_tensor(idx[~own], device=device)
    rows = torch.arange(v, device=device).repeat_interleave(k)
    keys = torch.unique(torch.cat([rows * v + cols, cols * v + rows]))
    r, c = keys // v, keys % v
    deg = torch.bincount(r, minlength=v)
    pos = torch.arange(keys.numel(), device=device) - (
        torch.cumsum(deg, 0) - deg)[r]
    nbr = torch.full((v, int(deg.max())), -1, dtype=torch.int64,
                     device=device)
    nbr[r, pos] = c
    pt = torch.as_tensor(p, device=device)
    dist = torch.full(nbr.shape, float("inf"), dtype=torch.float64,
                      device=device)
    dist[r, pos] = torch.linalg.norm(pt[r] - pt[c], dim=1)
    return RefGraph(nbr, dist)


def laplacian(g: RefGraph):
    """(L as a RefOperator, lumped mass (V,)), float64."""
    mask = g.mask
    d = torch.where(mask, g.distances, torch.zeros_like(g.distances))
    w = torch.where(mask, 1.0 / torch.clamp(d, min=1e-8), torch.zeros_like(d))
    deg = torch.clamp(mask.sum(dim=1), min=1)
    mass = torch.clamp((d * d).sum(dim=1) / deg, min=1e-12)
    return RefOperator(g.neighbors, -w, w.sum(dim=1)), mass


def screened(lap: RefOperator, mass: torch.Tensor,
             rel: float = 1e-4) -> RefOperator:
    """L + alpha M, alpha = ``rel`` x mean(diag) / mean(mass)."""
    alpha = rel * lap.diag.mean() / mass.mean()
    return RefOperator(lap.neighbors, lap.offdiag, lap.diag + alpha * mass)


def mean_edge_length(g: RefGraph) -> torch.Tensor:
    return g.distances[g.mask].mean()
