"""Vertex ordering for memory locality (counterpart of
``gravomg_tpu/geometry/order.py``): the Morton (Z-order) permutation
(host-side NumPy, a copy of the JAX package's), the renumbering of a
graph by a permutation, and its bandwidth.  After a Morton order,
neighbours lie nearby in memory, which is what the block-window operator
forms and the halo exchange's small cuts need."""

from __future__ import annotations

import numpy as np
import torch

from gravomg_tpu_torch.ops.segment import build_ell_rows
from gravomg_tpu_torch.types import INVALID_INDEX, Graph


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integers with two zero bits (for 3-D Morton)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """Permutation sorting points along a 3-D Z-order curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    scale = (2**bits - 1) / np.maximum(hi - lo, 1e-30)
    q = ((p - lo) * scale).astype(np.uint64)
    code = (_spread_bits(q[:, 0]) << np.uint64(2)) \
        | (_spread_bits(q[:, 1]) << np.uint64(1)) | _spread_bits(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def permute_graph(graph: Graph, perm) -> Graph:
    """Renumber a graph: new vertex i = old vertex perm[i] (``perm`` a
    numpy array or tensor).  Rows are re-sorted ascending by their new
    neighbour ids and the distances recomputed from the moved points, as
    in the JAX package."""
    v, k = graph.neighbors.shape
    dev = graph.neighbors.device
    perm_t = torch.as_tensor(np.asarray(perm), dtype=torch.long, device=dev)
    inv = torch.empty(v, dtype=torch.int32, device=dev)
    inv[perm_t] = torch.arange(v, dtype=torch.int32, device=dev)
    old_nbr = graph.neighbors[perm_t]             # rows in the new order
    mask = old_nbr != INVALID_INDEX
    new_nbr = torch.where(mask, inv[torch.where(mask, old_nbr, 0).long()],
                          INVALID_INDEX)
    rows = torch.arange(v, dtype=torch.int32,
                        device=dev)[:, None].expand(v, k).reshape(-1)
    res = build_ell_rows(rows, new_nbr.reshape(-1), mask.reshape(-1), v, k)
    new_points = graph.points[perm_t]
    m2 = res.columns != INVALID_INDEX
    safe = torch.where(m2, res.columns, 0).long()
    dist = torch.linalg.norm(new_points[:, None, :] - new_points[safe],
                             dim=-1)
    dist = torch.where(m2, dist, torch.full_like(dist, float("inf")))
    return Graph(neighbors=res.columns, distances=dist, points=new_points)


def bandwidth(graph: Graph) -> int:
    """Max |i - j| over the graph's edges, the locality figure of
    merit."""
    nbr = graph.neighbors.long()
    rows = torch.arange(nbr.shape[0], device=nbr.device)[:, None]
    cols = torch.where(nbr != INVALID_INDEX, nbr, rows)
    return int((cols - rows).abs().max())
