"""Spatial-hash kNN for large point clouds (counterpart of
``gravomg_tpu/geometry/gridknn.py``).

Points are binned into a uniform grid by one sort; each point gathers
the candidates of its 3x3x3 cell neighbourhood and keeps the k nearest
(``torch.topk``), chunk by chunk.  The grid is sized on the host from a
query subsample exactly as in the JAX package
(:func:`grid_knn_graph_nosync`), or from the bounding box's density with
retries on a shortfall (:func:`grid_knn_graph`).
"""

from __future__ import annotations

import numpy as np
import torch

from gravomg_tpu_torch.geometry.knn import knn_graph, symmetrized_knn_graph
from gravomg_tpu_torch.types import INVALID_INDEX, Graph
from gravomg_tpu_torch.utils.device import resolve_device

# Bytes of candidate temporaries one chunk may hold (ids, squared
# distances, gathered positions: ~32 bytes per candidate).
_CHUNK_BYTES = 1 << 30


def _grid_knn_indices(points: torch.Tensor, k: int, cell_edge: float,
                      origin: torch.Tensor, grid_dim: int,
                      cell_capacity: int, chunk: int):
    """Returns ((V, k) int32 neighbour ids, shortfall flag)."""
    v = points.shape[0]
    dev = points.device
    h = grid_dim
    edge = torch.tensor(cell_edge, dtype=points.dtype, device=dev)
    coords = torch.clamp(((points - origin) / edge).to(torch.int32), 0, h - 1)
    cell = ((coords[:, 0].long() * h + coords[:, 1]) * h + coords[:, 2])
    order = torch.argsort(cell, stable=True)
    counts = torch.bincount(cell, minlength=h ** 3)
    starts = torch.cumsum(counts, 0) - counts
    over_capacity = bool(counts.max() > cell_capacity)
    ids_ext = torch.cat([order, order.new_zeros((1,))])

    offs = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                        dtype=torch.int64, device=dev)          # (27, 3)
    slot = torch.arange(cell_capacity, device=dev)
    out = torch.empty((v, k), dtype=torch.int32, device=dev)
    short = torch.zeros((), dtype=torch.bool, device=dev)
    limit = edge * edge
    for c0 in range(0, v, chunk):
        p = points[c0:c0 + chunk]
        b = p.shape[0]
        my_id = torch.arange(c0, c0 + b, device=dev)
        nc = coords[c0:c0 + b].long()[:, None, :] + offs[None]  # (B, 27, 3)
        in_grid = torch.all((nc >= 0) & (nc < h), dim=-1)
        ncell = (nc[..., 0] * h + nc[..., 1]) * h + nc[..., 2]
        ncell = torch.where(in_grid, ncell, torch.zeros_like(ncell))
        cand_pos = starts[ncell][:, :, None] + slot[None, None, :]
        cand_ok = in_grid[:, :, None] & (slot[None, None, :]
                                         < counts[ncell][:, :, None])
        cand_pos = torch.where(cand_ok, cand_pos, torch.full_like(cand_pos, v))
        cand_id = ids_ext[cand_pos.reshape(b, -1)]              # (B, 27M)
        cand_ok = cand_ok.reshape(b, -1) & (cand_id != my_id[:, None])
        d2 = torch.sum((p[:, None, :] - points[cand_id]) ** 2, dim=-1)
        d2 = torch.where(cand_ok, d2, torch.full_like(d2, float("inf")))
        neg, pos = torch.topk(-d2, k, dim=1)
        idx = torch.gather(cand_id, 1, pos)
        idx = torch.where(torch.isfinite(neg), idx,
                          torch.full_like(idx, INVALID_INDEX))
        out[c0:c0 + b] = idx.to(torch.int32)
        # The 27-cell window covers a ball of radius cell_edge around the
        # query: the result is the true kNN only if the kth distance fits.
        kth = -neg[:, -1]
        short |= torch.any(~torch.isfinite(kth) | (kth >= limit))
    return out, bool(short) or over_capacity


def grid_knn_graph_nosync(points_np: np.ndarray, k: int,
                          max_degree: int | None = None,
                          margin: float = 2.0, device=None) -> Graph:
    """Symmetrised grid kNN graph of ``points_np`` on ``device`` (the
    card unless the caller names another, e.g. ``"cpu"``).

    One conservatively sized attempt (cell edge = ``margin`` x the
    largest kth-neighbour distance of a host subsample), as in the JAX
    package.  Raises RuntimeError if some point's k nearest are not
    certified by the cell window.  The table is ``max_degree`` wide
    (default 2k), wider where some vertex's symmetrised degree needs it
    (a hub that many points count among their k nearest).
    """
    device = resolve_device(device)
    v = points_np.shape[0]
    lo = points_np.min(axis=0)
    hi = points_np.max(axis=0)
    extent = float((hi - lo).max()) + 1e-12
    rng = np.random.default_rng(0)
    nq = min(256, v)
    queries = points_np[rng.choice(v, nq, replace=False)].astype(np.float32)
    kth = np.empty(nq, np.float32)
    refs = points_np.astype(np.float32)
    for i in range(nq):
        d2 = np.sum((refs - queries[i]) ** 2, axis=1)
        kth[i] = np.sqrt(np.partition(d2, k)[k])
    edge = float(margin / 2.0 * 1.3 * kth.max())
    grid_dim = 1 << max(1, int(np.ceil(extent / edge)) + 1).bit_length()
    grid_dim = max(2, min(512, grid_dim))
    if grid_dim * edge < extent:
        edge = extent / grid_dim * 1.0001
    coords = np.clip(((points_np - lo) / edge).astype(np.int64),
                     0, grid_dim - 1)
    cid = (coords[:, 0] * grid_dim + coords[:, 1]) * grid_dim + coords[:, 2]
    cap = int(np.bincount(cid, minlength=grid_dim**3).max())
    cap = ((cap + 15) // 16) * 16
    # Bound the (chunk, 27*cap) candidate temporaries.
    chunk = max(1, min(v, _CHUNK_BYTES // (27 * cap * 32)))

    points = torch.as_tensor(points_np, device=device)
    origin = torch.as_tensor(lo, dtype=points.dtype, device=device)
    idx, short = _grid_knn_indices(points, k, edge, origin, grid_dim, cap,
                                   chunk)
    if short:
        raise RuntimeError("grid kNN shortfall: some point's k nearest "
                           "are not certified by its 27-cell window")
    return symmetrized_knn_graph(points, idx, max_degree)


def grid_knn_graph(points: torch.Tensor, k: int,
                   max_degree: int | None = None,
                   target_per_cell: float = 3.0) -> Graph:
    """Symmetrised kNN graph by spatial hashing, on the points' device;
    the brute-force :func:`~gravomg_tpu_torch.geometry.knn.knn_graph`
    for clouds of at most 20,000 points.  Same output contract as
    ``knn_graph``.  The cell edge starts at about 1.5x the kth-neighbour
    distance a uniform surface cloud of this density would have, grows
    1.5x while some point's k nearest are not certified by its 27-cell
    window, and shrinks while a cell holds too many candidates; after 12
    attempts the brute-force path takes over."""
    v = points.shape[0]
    if v <= 20000:
        return knn_graph(points, k, max_degree=max_degree)
    pts_np = points.cpu().numpy()
    lo = pts_np.min(axis=0)
    extent = float((pts_np.max(axis=0) - lo).max()) + 1e-12
    area_density = v / (extent * extent)
    edge = float(1.5 * np.sqrt(max(k, 9) / (np.pi * area_density))
                 / max(target_per_cell / 3.0, 1e-6) ** 0.5)
    origin = torch.as_tensor(lo, dtype=points.dtype, device=points.device)
    for _ in range(12):
        grid_dim = 1 << max(1, int(np.ceil(extent / edge)) + 1).bit_length()
        grid_dim = max(2, min(512, grid_dim))
        if grid_dim * edge < extent:
            edge = extent / grid_dim * 1.0001
        coords = np.clip(((pts_np - lo) / edge).astype(np.int64),
                         0, grid_dim - 1)
        cid = (coords[:, 0] * grid_dim + coords[:, 1]) * grid_dim \
            + coords[:, 2]
        cap = int(np.bincount(cid, minlength=grid_dim ** 3).max())
        if cap * 27 * 8 > 64 * 1024:   # keep the candidate tensors sane
            edge *= 0.7
            continue
        cap = ((cap + 15) // 16) * 16
        chunk = max(1, min(v, _CHUNK_BYTES // (27 * cap * 32)))
        idx, short = _grid_knn_indices(points, k, edge, origin, grid_dim,
                                       cap, chunk)
        if not short:
            return symmetrized_knn_graph(points, idx, max_degree)
        edge *= 1.5
    return knn_graph(points, k, max_degree=max_degree)
