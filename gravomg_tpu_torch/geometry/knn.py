"""Symmetric kNN graph construction (counterpart of
``gravomg_tpu/geometry/knn.py``): a blocked brute-force top-k over
squared distances by the |x|^2 + |y|^2 - 2<x, y> expansion in f32, then
a sort-based union symmetrisation into the padded ELL
:class:`~gravomg_tpu_torch.types.Graph`.
"""

from __future__ import annotations

from typing import Optional

import torch

from gravomg_tpu_torch.ops.segment import build_ell_rows
from gravomg_tpu_torch.types import INVALID_INDEX, Graph

# Squared distances (query rows x all points) one block holds.
_BLOCK_ELEMS = 1 << 26


def knn_indices(points: torch.Tensor, k: int) -> torch.Tensor:
    """(V, k) int32 ids of the k nearest neighbours of every point (self
    excluded), each row by ascending distance; INVALID_INDEX where the
    cloud has fewer than k other points."""
    v = points.shape[0]
    p32 = points.float()
    sq = torch.sum(p32 * p32, dim=1)
    block = max(1, _BLOCK_ELEMS // max(v, 1))
    kk = min(k, v)
    out = torch.full((v, k), INVALID_INDEX, dtype=torch.int32,
                     device=points.device)
    for r0 in range(0, v, block):
        q = p32[r0:r0 + block]
        d2 = sq[r0:r0 + block, None] + sq[None, :] - 2.0 * (q @ p32.T)
        rows = torch.arange(q.shape[0], device=points.device)
        d2[rows, r0 + rows] = float("inf")
        neg, idx = torch.topk(-d2, kk, dim=1)
        idx = torch.where(torch.isfinite(neg), idx,
                          torch.full_like(idx, INVALID_INDEX))
        out[r0:r0 + block, :kk] = idx.to(torch.int32)
    return out


def graph_from_pairs(points: torch.Tensor, rows: torch.Tensor,
                     cols: torch.Tensor, valid: torch.Tensor,
                     max_degree: Optional[int], grow: bool) -> Graph:
    """The graph with an undirected edge for every valid (row, col)
    pair, rows ascending, Euclidean lengths recomputed from the
    positions.  The table is ``max_degree`` wide; if a vertex has more
    edges it is as wide as the largest degree when ``grow``, else this
    raises ValueError."""
    v = points.shape[0]
    res = build_ell_rows(torch.cat([rows, cols]), torch.cat([cols, rows]),
                         torch.cat([valid, valid]), v)
    columns = res.columns
    degree = int(res.counts.max()) if v else 0
    if max_degree is not None:
        if degree > max_degree and not grow:
            raise ValueError(f"some vertex degree ({degree}) exceeds "
                             f"max_degree={max_degree}; pass a larger "
                             f"max_degree")
        if columns.shape[1] < max_degree:
            pad = columns.new_full((v, max_degree - columns.shape[1]),
                                   INVALID_INDEX)
            columns = torch.cat([columns, pad], dim=1)
    mask = columns != INVALID_INDEX
    safe = torch.where(mask, columns, torch.zeros_like(columns)).long()
    dist = torch.linalg.norm(points[:, None, :] - points[safe], dim=-1)
    dist = torch.where(mask, dist, torch.full_like(dist, float("inf")))
    return Graph(neighbors=columns, distances=dist, points=points)


def symmetrized_knn_graph(points: torch.Tensor, idx: torch.Tensor,
                          max_degree: Optional[int]) -> Graph:
    """The union-symmetrised graph of (V, k) neighbour ids: an edge
    exists if either endpoint selected the other.  ``max_degree``
    defaults to 2k and grows to the largest union degree."""
    v, k = idx.shape
    rows = torch.arange(v, dtype=torch.int32,
                        device=idx.device).repeat_interleave(k)
    cols = idx.reshape(-1)
    valid = cols != INVALID_INDEX
    return graph_from_pairs(points, rows,
                            torch.where(valid, cols, torch.zeros_like(cols)),
                            valid, 2 * k if max_degree is None else max_degree,
                            grow=True)


def knn_graph(points: torch.Tensor, k: int,
              max_degree: Optional[int] = None) -> Graph:
    """Symmetrised kNN graph of ``points`` (on their device) with
    Euclidean edge lengths, rows ascending by neighbour index.  The
    table is ``max_degree`` wide (default 2k), wider if a hub vertex's
    union degree needs it."""
    return symmetrized_knn_graph(points, knn_indices(points, k), max_degree)


def graph_from_edges(points: torch.Tensor, edges: torch.Tensor,
                     max_degree: int) -> Graph:
    """A Graph from an explicit undirected (E, 2) edge list (mesh edges,
    tests).  Self loops are dropped; a vertex of more than
    ``max_degree`` edges raises ValueError."""
    e0 = edges[:, 0].to(torch.int32)
    e1 = edges[:, 1].to(torch.int32)
    return graph_from_pairs(points, e0, e1, e0 != e1, max_degree, grow=False)
