"""Laplacian operators in padded ELL form (counterpart of
``gravomg_tpu/geometry/laplacian.py``): a weighted graph Laplacian for
point clouds, a cotan Laplacian for triangle meshes, and the distance
graph of an operator's sparsity pattern."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gravomg_tpu_torch.ops.segment import build_ell_rows
from gravomg_tpu_torch.types import INVALID_INDEX, EllOperator, Graph


def graph_laplacian(graph: Graph, weighting: str = "invdist",
                    sigma: Optional[float] = None
                    ) -> Tuple[EllOperator, torch.Tensor]:
    """L = D - W plus a lumped mass vector.

    Weights: "uniform" w_ij = 1; "invdist" w_ij = 1 / max(d_ij, 1e-8);
    "gaussian" w_ij = exp(-d_ij^2 / sigma^2), sigma the mean edge length
    unless given.  The mass is the mean squared neighbour distance (a
    local-area proxy for point clouds), floored at 1e-12.
    """
    mask = graph.mask
    zero = torch.zeros_like(graph.distances)
    d = torch.where(mask, graph.distances, zero)
    if weighting == "uniform":
        w = mask.to(d.dtype)
    elif weighting == "invdist":
        w = torch.where(mask, 1.0 / torch.clamp(d, min=1e-8), zero)
    elif weighting == "gaussian":
        if sigma is None:
            sigma = torch.sum(d) / torch.sum(mask).clamp(min=1)
        w = torch.where(mask, torch.exp(-(d * d) / (sigma * sigma)), zero)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    diag = torch.sum(w, dim=1)
    lap = EllOperator(neighbors=graph.neighbors, offdiag=-w, diag=diag)
    deg = torch.clamp(torch.sum(mask, dim=1), min=1)
    mass = torch.clamp(torch.sum(d * d, dim=1) / deg, min=1e-12)
    return lap, mass


def cotan_laplacian(points: torch.Tensor, faces: torch.Tensor,
                    max_degree: Optional[int] = None
                    ) -> Tuple[EllOperator, torch.Tensor]:
    """Cotan-weighted Laplacian and barycentric lumped mass of a mesh:
    L_ij = -(cot a + cot b) / 2 over the one or two triangles at edge
    (i, j), diagonal = -(row sum); mass_i = a third of the areas of the
    triangles at i, floored at 1e-12.  The table is ``max_degree`` wide,
    wider if a vertex has more neighbours."""
    v = points.shape[0]
    f = faces.long()
    p0, p1, p2 = points[f[:, 0]], points[f[:, 1]], points[f[:, 2]]

    def cot(a, b):
        cross = torch.linalg.norm(torch.linalg.cross(a, b), dim=-1)
        return torch.sum(a * b, dim=-1) / cross.clamp(min=1e-12)

    # The angle at vertex k is opposite the edge of the other two.
    cot0 = cot(p1 - p0, p2 - p0)
    cot1 = cot(p0 - p1, p2 - p1)
    cot2 = cot(p0 - p2, p1 - p2)
    rows = torch.cat([f[:, 1], f[:, 2], f[:, 0], f[:, 2], f[:, 0], f[:, 1]])
    cols = torch.cat([f[:, 2], f[:, 1], f[:, 2], f[:, 0], f[:, 1], f[:, 0]])
    w = 0.5 * torch.cat([cot0, cot0, cot1, cot1, cot2, cot2])
    res = build_ell_rows(rows, cols, torch.ones_like(rows, dtype=torch.bool),
                         v, values=-w, combine="add")
    columns, offdiag = res.columns, res.values
    if max_degree is not None and columns.shape[1] < max_degree:
        extra = max_degree - columns.shape[1]
        columns = torch.cat([columns, columns.new_full((v, extra),
                                                       INVALID_INDEX)], dim=1)
        offdiag = torch.cat([offdiag, offdiag.new_zeros((v, extra))], dim=1)
    diag = -torch.sum(offdiag, dim=1)
    area = 0.5 * torch.linalg.norm(torch.linalg.cross(p1 - p0, p2 - p0),
                                   dim=-1)
    mass = points.new_zeros((v,))
    for k in range(3):
        mass = mass.index_add(0, f[:, k], area / 3.0)
    return EllOperator(columns, offdiag, diag), mass.clamp(min=1e-12)


def to_edge_distance_graph(op: EllOperator, points: torch.Tensor) -> Graph:
    """The graph of an operator's sparsity pattern with Euclidean edge
    lengths (the reference's ``toEdgeDistanceMatrix``, without its
    explicit zero diagonal)."""
    mask = op.mask
    dist = torch.linalg.norm(
        points[:, None, :] - points[op.safe_neighbors().long()], dim=-1)
    dist = torch.where(mask, dist, torch.full_like(dist, float("inf")))
    return Graph(neighbors=op.neighbors, distances=dist, points=points)


def extract_edges(graph: Graph):
    """The graph as a COO list (the reference's ``extractEdges``):
    (edges (V*K, 2) int32, lengths (V*K,), valid mask), directed, each
    undirected edge twice."""
    v, k = graph.neighbors.shape
    rows = torch.arange(v, dtype=torch.int32,
                        device=graph.neighbors.device)[:, None].expand(v, k)
    edges = torch.stack([rows.reshape(-1),
                         graph.safe_neighbors().reshape(-1)], dim=1)
    return edges, graph.distances.reshape(-1), graph.mask.reshape(-1)
