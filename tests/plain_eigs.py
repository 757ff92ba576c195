"""A plain float64 reference for the lowest Laplace eigenpairs of a point
cloud, in PyTorch alone: it imports neither JAX nor any module of the
port, and takes nothing the port made.

From the points: the symmetrised graph of each point's k nearest others
by brute force (an edge where either end chose the other), the
inverse-distance Laplacian L = D - W (w_ij = 1 / max(d_ij, 1e-8)) and
the lumped mass (the mean squared edge length at a vertex, at least
1e-12), as ``benchmark/reference/graph.py`` defines them; then the
smallest pairs of the pencil L v = lam M v by a dense ``eigh`` of
M^-1/2 L M^-1/2.  Small clouds only (dense V x V matrices).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# A float32 product on a card may otherwise run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Pencil(NamedTuple):
    lap: torch.Tensor            # (V, V) L, float64
    mass: torch.Tensor           # (V,) lumped mass, float64


def knn_adjacency(points, k: int) -> torch.Tensor:
    """(V, V) bool: the symmetrised graph of the k nearest others."""
    p = torch.as_tensor(points, dtype=torch.float64)
    d = torch.cdist(p, p)
    d.fill_diagonal_(float("inf"))
    idx = torch.topk(d, k, dim=1, largest=False).indices
    adj = torch.zeros(d.shape, dtype=torch.bool)
    adj[torch.arange(p.shape[0])[:, None], idx] = True
    return adj | adj.T


def pencil(points, k: int) -> Pencil:
    """L and M of the points' kNN graph."""
    p = torch.as_tensor(points, dtype=torch.float64)
    adj = knn_adjacency(p, k)
    d = torch.where(adj, torch.cdist(p, p), torch.zeros(()))
    w = torch.where(adj, 1.0 / torch.clamp(d, min=1e-8), torch.zeros(()))
    deg = torch.clamp(adj.sum(dim=1), min=1)
    mass = torch.clamp((d * d).sum(dim=1) / deg, min=1e-12)
    return Pencil(torch.diag(w.sum(dim=1)) - w, mass)


def lowest_pairs(pen: Pencil, n: int):
    """(lam (n,), v (V, n)): the n smallest pairs, v M-orthonormal."""
    s = torch.rsqrt(pen.mass)
    lam, u = torch.linalg.eigh(s[:, None] * pen.lap * s[None, :])
    return lam[:n], s[:, None] * u[:, :n]


def pencil_residual(pen: Pencil, lam, v) -> torch.Tensor:
    """Per pair, ||L v - lam M v||_{M^-1} / ||v||_M: the residual of the
    normalised problem M^-1/2 L M^-1/2 u = lam u, u = M^1/2 v, which
    does not grow or shrink with the cloud's spacing."""
    v = torch.as_tensor(v, dtype=torch.float64)
    lam = torch.as_tensor(lam, dtype=torch.float64)
    r = pen.lap @ v - pen.mass[:, None] * v * lam[None, :]
    num = torch.sqrt((r * r / pen.mass[:, None]).sum(dim=0))
    return num / torch.sqrt((pen.mass[:, None] * v * v).sum(dim=0))
