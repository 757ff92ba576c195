"""Voronoi-triangle enumeration on the coarse graph (counterpart of
``gravomg_tpu/prolong/triangles.py``).

For each vertex v0, every pair of its neighbours (v1, v2) with
v0 < v1 < v2 that are themselves adjacent forms a triangle, with normal
``normalize((p1 - p0) x (p2 - p0))`` (the winding, and so the normal's
sign, is arbitrary; the prolongation is robust to it).  Triangle ids are
given in (v0, slot of v1, slot of v2) enumeration order and the
per-vertex association lists are ascending, both as in the reference:
the prolongation's first-hit tie-break walks the lists in order.

The adjacency test "v2 in neighbours(v1)" is a ``torch.searchsorted`` of
the key (v1, v2) in the sorted keys of all edges, over the candidate
pairs of one chunk of rows at a time.
"""

from __future__ import annotations

import torch

from gravomg_tpu_torch.ops.segment import group_ordered
from gravomg_tpu_torch.types import INVALID_INDEX, Graph, TriangleSet

# Candidate (row, slot, slot) triples one chunk holds.
_CHUNK_ELEMS = 1 << 25


def _enumerate(coarse: Graph):
    """(v0, v1, v2) of every triangle, each (T,) int64, in enumeration
    order."""
    c, k = coarse.neighbors.shape
    dev = coarse.neighbors.device
    m = coarse.mask
    nbr = coarse.safe_neighbors().long()
    rows = torch.arange(c, device=dev)
    # Rows are ascending and come in row order, so the flattened keys of
    # the valid entries are sorted.
    edge_keys = (rows[:, None] * c + nbr)[m]
    slot = torch.arange(k, device=dev)
    slot_ok = slot[:, None] < slot[None, :]
    chunk = max(1, _CHUNK_ELEMS // (k * k))
    out = []
    for c0 in range(0, c, chunk):
        cn, cm = nbr[c0:c0 + chunk], m[c0:c0 + chunk]
        idx = rows[c0:c0 + chunk]
        # Slot order is index order, so v2 > v1 comes with k1 < k2 and
        # the reference's skip of smaller vertices reduces to v1 > v0.
        upper = cm & (cn > idx[:, None])
        b, k1, k2 = torch.nonzero(upper[:, :, None] & cm[:, None, :]
                                  & slot_ok, as_tuple=True)
        v1, v2 = cn[b, k1], cn[b, k2]
        key = v1 * c + v2
        pos = torch.searchsorted(edge_keys, key).clamp(
            max=max(edge_keys.numel() - 1, 0))
        hit = edge_keys[pos] == key if edge_keys.numel() else key < 0
        out.append(torch.stack([idx[b][hit], v1[hit], v2[hit]]))
    return torch.cat(out, dim=1)


def construct_voronoi_triangles(coarse: Graph) -> TriangleSet:
    """All triangles of the coarse graph (rows ascending) with their
    normals and the per-vertex association lists.  The list width is the
    largest number of triangles at one vertex (at least one column)."""
    c = coarse.num_vertices
    points = coarse.points
    t_v0, t_v1, t_v2 = _enumerate(coarse)
    n_tri = t_v0.numel()
    vertices = torch.stack([t_v0, t_v1, t_v2], dim=1).to(torch.int32)

    p0 = points[t_v0]
    cr = torch.linalg.cross(points[t_v1] - p0, points[t_v2] - p0)
    normals = cr / torch.linalg.norm(cr, dim=1, keepdim=True).clamp(min=1e-30)

    # The payload 3 * tid + slot sorts like tid (a vertex is in a
    # triangle at most once), and carries the slot of this vertex along.
    tid = torch.arange(n_tri, device=points.device)
    enc, _ = group_ordered(
        torch.cat([t_v0, t_v1, t_v2]),
        torch.cat([3 * tid, 3 * tid + 1, 3 * tid + 2]),
        torch.ones((3 * n_tri,), dtype=torch.bool, device=points.device), c)
    valid = enc != INVALID_INDEX
    assoc = torch.where(valid, enc // 3, enc)
    assoc_rot = torch.where(valid, enc % 3, torch.zeros_like(enc))
    return TriangleSet(vertices=vertices, normals=normals, assoc=assoc,
                       assoc_rot=assoc_rot)
