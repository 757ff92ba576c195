"""Coarse graph from the fine graph and the parent partition
(counterpart of ``gravomg_tpu/coarsen/graph.py``).

Every fine edge whose endpoints have different parents induces a coarse
edge between those parents.  Only the sparsity pattern matters
downstream (the reference's stored edge weights are never read), so the
pattern is built by one sort and the coarse graph carries clean
Euclidean distances between coarse points.
"""

from __future__ import annotations

from typing import Optional

import torch

from gravomg_tpu_torch.ops.segment import build_ell_rows
from gravomg_tpu_torch.types import INVALID_INDEX, Graph


def extract_coarse_edges(graph: Graph, parents: torch.Tensor, n_coarse: int,
                         degree_multiple: Optional[int] = None
                         ) -> torch.Tensor:
    """The coarse adjacency pattern: (n_coarse, Kc) int32 columns,
    ascending per row, INVALID_INDEX padding.  Kc is the largest coarse
    degree, rounded up to ``degree_multiple`` (and at least 4) if one is
    given."""
    rows = parents[:, None].expand_as(graph.neighbors)
    cols = parents[graph.safe_neighbors().long()]
    valid = graph.mask & (rows != cols)
    columns = build_ell_rows(rows.reshape(-1), cols.reshape(-1),
                             valid.reshape(-1), n_coarse).columns
    if degree_multiple is not None:
        width = -(-max(columns.shape[1], 4) // degree_multiple) \
            * degree_multiple
        pad = columns.new_full((n_coarse, width - columns.shape[1]),
                               INVALID_INDEX)
        columns = torch.cat([columns, pad], dim=1)
    return columns


def coarse_graph(columns: torch.Tensor, coarse_points: torch.Tensor) -> Graph:
    """The coarse level's Graph, with Euclidean edge lengths."""
    mask = columns != INVALID_INDEX
    safe = torch.where(mask, columns, torch.zeros_like(columns)).long()
    dist = torch.linalg.norm(coarse_points[:, None, :] - coarse_points[safe],
                             dim=-1)
    dist = torch.where(mask, dist, torch.full_like(dist, float("inf")))
    return Graph(neighbors=columns, distances=dist, points=coarse_points)
