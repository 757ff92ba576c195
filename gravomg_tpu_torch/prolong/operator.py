"""Prolongation: assembly of U and the grid transfers (counterpart of
``gravomg_tpu/prolong/operator.py``).

Assembly follows the reference's ``constructProlongation``.  Per fine
point, with its parent p's coarse neighbourhood:

  1. p has no coarse neighbour: weight 1 on p;
  2. exactly one neighbour: clamped projection onto the segment from p
     to it;
  3. general: scan p's incident Voronoi triangles in association-list
     order and take the FIRST whose plane projection contains the point
     (barycentric coordinates by signed sub-area ratios against the
     triangle's normal);
  4. fallback A: the lowest-indexed coarse neighbour that appears in
     slot 1 or 2 of some scanned triangle and was never "killed" by a
     negative coordinate there (the reference's ``insideEdge`` map,
     reduced to what survives in it), weighted by clamped projection
     onto that edge;
  5. fallback B: inverse-distance weights over p and the two coarse
     neighbours nearest to the fine point, whatever the scheme.

All five cases are mask algebra over (fine point, candidate triangle)
pairs, evaluated in blocks of fine points so that peak memory is
O(block x A); the fallbacks are evaluated only for the points of a block
that hit no triangle.  The arithmetic runs in the points' dtype, in f64
with ``precise_weights``.

The transfers are prolongation by U and restriction by U^T, in scatter
form and in the precomputed gather form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gravomg_tpu_torch.config import BARYCENTRIC, UNIFORM
from gravomg_tpu_torch.types import (INVALID_INDEX, Prolongation,
                                     Restriction, TriangleSet,
                                     safe_gather_index)

# (fine point, candidate triangle) pairs one block holds.
_BLOCK_ELEMS = 1 << 21


def _inverse_distance_weights(points, p, cols):
    """Normalised 1 / max(1e-8, |p - points[cols]|) per row of ``cols``
    (the reference's ``inverseDistanceWeights``)."""
    d = torch.linalg.norm(p[:, None, :] - points[cols], dim=-1)
    w = 1.0 / d.clamp(min=1e-8)
    return w / w.sum(dim=1, keepdim=True)


def _first_true(mask):
    """(any True in the row, slot of the first True), for (B, N) bool."""
    n = mask.shape[1]
    slots = torch.arange(n, device=mask.device)
    first = torch.where(mask, slots, slots.new_full((), n)).min(dim=1).values
    return first < n, first.clamp(max=n - 1)


def _segment_weight(p, pc, e):
    """Clamped projection of p - pc onto the segment pc -> e.  The
    reference normalises by the true norm and divides by the clamped
    length; both are kept."""
    seg = e - pc
    length = torch.linalg.norm(seg, dim=1)
    w = torch.sum((p - pc) * (seg / length[:, None]), dim=1)
    return (w / length.clamp(min=1e-8)).clamp(0.0, 1.0)


def _two_point_weights(scheme, points, p, w_far, c0, c1):
    """(B, 2) weights over (c0, c1), given the clamped projection weight
    of the far endpoint (cases 2 and 4)."""
    if scheme == BARYCENTRIC:
        return torch.stack([1.0 - w_far, w_far], dim=1)
    if scheme == UNIFORM:
        return torch.full((p.shape[0], 2), 0.5, dtype=p.dtype,
                          device=p.device)
    return _inverse_distance_weights(points, p, torch.stack([c0, c1], dim=1))


def _scan_triangles(p, c, coarse_points, triangles: TriangleSet):
    """The triangle scan of one block: barycentric coordinates of every
    (point, candidate) pair against the candidate rotated so that the
    parent sits in slot 0.  Returns (b0, b1, b2, rotated vertex ids
    (B, A, 3), candidate validity)."""
    ts = triangles.assoc[c]                                  # (B, A)
    tvalid = ts != INVALID_INDEX
    ts_safe = safe_gather_index(ts).long()
    shift = (triangles.assoc_rot[c].long()[:, :, None]
             + torch.arange(3, device=p.device)) % 3
    rt = torch.gather(triangles.vertices[ts_safe].long(), 2, shift)
    tn = triangles.normals[ts_safe]                          # (B, A, 3)
    tri = coarse_points[rt]                                  # (B, A, 3, 3)
    v1, v2, v3 = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    pp = p[:, None, :]
    dist_plane = torch.sum((pp - v1) * tn, dim=-1)
    p_proj = pp - dist_plane[:, :, None] * tn
    double_area = torch.sum(torch.linalg.cross(v2 - v1, v3 - v1) * tn, dim=-1)
    b0 = torch.sum(torch.linalg.cross(v3 - v2, p_proj - v2) * tn,
                   dim=-1) / double_area
    b1 = torch.sum(torch.linalg.cross(v1 - v3, p_proj - v3) * tn,
                   dim=-1) / double_area
    return b0, b1, 1.0 - b0 - b1, rt, tvalid


def _fallback_rows(p, c, b0, b1, b2, rt, tvalid, coarse_points, coarse_nbr,
                   scheme):
    """Cases 1, 2, 4 and 5 for the points that hit no triangle.  Returns
    (cols (S, 3), weights (S, 3), edge-fallback flags, point-fallback
    flags)."""
    rows = torch.arange(p.shape[0], device=p.device)
    nbr_row = coarse_nbr[c]
    nmask = nbr_row != INVALID_INDEX
    nbrs = safe_gather_index(nbr_row).long()                 # (S, Kc)
    npts = coarse_points[nbrs]                               # (S, Kc, 3)
    pc = coarse_points[c]
    deg = nmask.sum(dim=1)
    zero = torch.zeros_like(p[:, 0])

    # Case 2: a single neighbour.
    nb0 = nbrs[:, 0]
    w2 = _two_point_weights(scheme, coarse_points, p,
                            _segment_weight(p, pc, npts[:, 0]), c, nb0)
    single_cols = torch.stack([c, nb0, c], dim=1)
    single_wts = torch.stack([w2[:, 0], w2[:, 1], zero], dim=1)

    # Fallback A: the kill rules act across ALL scanned triangles (no
    # triangle hit, so every associated triangle was processed).
    kill1 = (b0 < 0.0) | (b1 < 0.0)           # the slot-1 edge is killed
    kill2 = (b0 < 0.0) | (b2 < 0.0)           # the slot-2 edge is killed
    in1 = tvalid[:, None, :] & (rt[:, None, :, 1] == nbrs[:, :, None])
    in2 = tvalid[:, None, :] & (rt[:, None, :, 2] == nbrs[:, :, None])
    present = torch.any(in1 | in2, dim=2)
    killed = torch.any((in1 & kill1[:, None, :]) | (in2 & kill2[:, None, :]),
                       dim=2)
    has_edge, e_slot = _first_true(nmask & present & ~killed)
    e_idx = nbrs[rows, e_slot]
    we2 = _two_point_weights(
        scheme, coarse_points, p,
        _segment_weight(p, pc, npts[rows, e_slot]), c, e_idx)
    edge_cols = torch.stack([c, e_idx, c], dim=1)
    edge_wts = torch.stack([we2[:, 0], we2[:, 1], zero], dim=1)

    # Fallback B: the two nearest neighbours, ties to the lower slot (the
    # reference's sort of (distance, index) pairs on ascending rows).
    nd = torch.linalg.norm(p[:, None, :] - npts, dim=-1)
    inf = torch.full_like(nd, float("inf"))
    nd = torch.where(nmask, nd, inf)
    _, s1 = _first_true(nd == nd.min(dim=1, keepdim=True).values)
    nd2 = nd.scatter(1, s1[:, None], inf[:, :1])
    _, s2 = _first_true(nd2 == nd2.min(dim=1, keepdim=True).values)
    fb_cols = torch.stack([c, nbrs[rows, s1], nbrs[rows, s2]], dim=1)
    fb_wts = _inverse_distance_weights(coarse_points, p, fb_cols)

    general = deg >= 2
    cols = torch.where(has_edge[:, None], edge_cols, fb_cols)
    wts = torch.where(has_edge[:, None], edge_wts, fb_wts)
    cols = torch.where((deg == 1)[:, None], single_cols, cols)
    wts = torch.where((deg == 1)[:, None], single_wts, wts)
    one = torch.stack([zero + 1.0, zero, zero], dim=1)
    cols = torch.where((deg == 0)[:, None], torch.stack([c, c, c], dim=1),
                       cols)
    wts = torch.where((deg == 0)[:, None], one, wts)
    return cols, wts, general & has_edge, general & ~has_edge


def _prolongation_block(p, c, coarse_points, coarse_nbr, triangles, scheme):
    """U rows of one block of fine points ``p`` with parents ``c``:
    (cols (B, 3) int64, weights (B, 3), case counts (3,))."""
    b0, b1, b2, rt, tvalid = _scan_triangles(p, c, coarse_points, triangles)
    has_hit, first = _first_true(tvalid & (b0 >= 0.0) & (b1 >= 0.0)
                                 & (b2 >= 0.0))
    rows = torch.arange(p.shape[0], device=p.device)
    cols = rt[rows, first]                                   # (B, 3)
    if scheme == BARYCENTRIC:
        wts = torch.stack([b0[rows, first], b1[rows, first],
                           b2[rows, first]], dim=1)
    elif scheme == UNIFORM:
        wts = torch.full_like(p, 1.0 / 3.0)
    else:
        wts = _inverse_distance_weights(coarse_points, p, cols)
    miss = torch.nonzero(~has_hit).reshape(-1)
    n_hit = has_hit.sum()
    n_edge = n_point = torch.zeros_like(n_hit)
    if miss.numel():
        fcols, fwts, edge, point = _fallback_rows(
            p[miss], c[miss], b0[miss], b1[miss], b2[miss], rt[miss],
            tvalid[miss], coarse_points, coarse_nbr, scheme)
        cols = cols.index_copy(0, miss, fcols)
        wts = wts.index_copy(0, miss, fwts)
        n_edge, n_point = edge.sum(), point.sum()
    return cols, wts, torch.stack([n_hit, n_edge, n_point])


def construct_prolongation(fine_points: torch.Tensor, parents: torch.Tensor,
                           coarse_points: torch.Tensor,
                           coarse_nbr: torch.Tensor, triangles: TriangleSet,
                           scheme: int = BARYCENTRIC,
                           precise_weights: bool = False
                           ) -> Tuple[Prolongation, torch.Tensor]:
    """Assemble U.  Returns (Prolongation, case counts (3,) int64 =
    [triangle hits, edge fallbacks, point fallbacks] over the fine points
    whose parent has two or more coarse neighbours; the reference
    computes these counters and never prints them).

    ``precise_weights`` runs the weight arithmetic in f64 on the same
    discrete hierarchy (the normals recomputed in f64 from the same
    triangles) and rounds the weights back to the input dtype: pure f32
    weights land a few 1e-6 from the f64 reference, this mode within
    1e-6.
    """
    out_dtype = fine_points.dtype
    if precise_weights:
        fine_points = fine_points.double()
        coarse_points = coarse_points.double()
        tv = triangles.vertices.long()
        p0 = coarse_points[tv[:, 0]]
        nrm = torch.linalg.cross(coarse_points[tv[:, 1]] - p0,
                                 coarse_points[tv[:, 2]] - p0)
        nn = torch.linalg.norm(nrm, dim=1, keepdim=True)
        nrm = torch.where(nn > 0, nrm / torch.where(nn > 0, nn,
                                                    torch.ones_like(nn)), nrm)
        triangles = triangles._replace(normals=nrm)
    vf = fine_points.shape[0]
    par = parents.long()
    block = max(256, _BLOCK_ELEMS // max(triangles.assoc.shape[1], 1))
    cols, wts = [], []
    counts = torch.zeros((3,), dtype=torch.int64, device=fine_points.device)
    for r0 in range(0, vf, block):
        bc, bw, bn = _prolongation_block(
            fine_points[r0:r0 + block], par[r0:r0 + block], coarse_points,
            coarse_nbr, triangles, scheme)
        cols.append(bc)
        wts.append(bw)
        counts = counts + bn
    u = Prolongation(cols=torch.cat(cols).to(torch.int32),
                     weights=torch.cat(wts).to(out_dtype),
                     n_coarse=coarse_points.shape[0])
    return u, counts


def projected_points(u_op: Prolongation,
                     coarse_points: torch.Tensor) -> torch.Tensor:
    """U @ coarse_points, the reference demo's visual sanity oracle."""
    return prolong(u_op, coarse_points)


def prolong(u_op: Prolongation, coarse_values: torch.Tensor) -> torch.Tensor:
    """fine = U @ coarse; coarse_values is (n_coarse,) or (n_coarse, D)."""
    gathered = coarse_values[u_op.cols]            # (Vf, 3[, D])
    if coarse_values.ndim == 1:
        return torch.sum(u_op.weights * gathered, dim=1)
    return torch.sum(u_op.weights[:, :, None] * gathered, dim=1)


def restrict(u_op: Prolongation, fine_values: torch.Tensor) -> torch.Tensor:
    """coarse = U^T @ fine, scatter form (``index_add_``)."""
    cols = u_op.cols.reshape(-1)
    if fine_values.ndim == 1:
        contrib = (u_op.weights * fine_values[:, None]).reshape(-1)
        out = fine_values.new_zeros((u_op.n_coarse,))
        return out.index_add_(0, cols, contrib)
    d = fine_values.shape[1]
    contrib = u_op.weights[:, :, None] * fine_values[:, None, :]
    out = fine_values.new_zeros((u_op.n_coarse, d))
    return out.index_add_(0, cols, contrib.reshape(-1, d))


def build_restriction(u_op: Prolongation,
                      max_children: int) -> Tuple[Restriction, bool]:
    """Gather-form U^T: per coarse vertex, the (fine row, U weight) pairs
    that contribute to it, in ascending (fine row, slot) order.

    Zero-weight U entries are dropped.  Returns (Restriction, overflow):
    overflow means some coarse vertex has more than ``max_children``
    entries and the table is incomplete.
    """
    vf, nc = u_op.n_fine, u_op.n_coarse
    dev = u_op.cols.device
    cols = u_op.cols.reshape(-1).long()
    w = u_op.weights.reshape(-1)
    # Flat (fine row, slot) ids in ascending order; a stable sort by
    # coarse column keeps that order inside each group.
    flat = torch.nonzero(w != 0.0).reshape(-1)
    col_v = cols[flat]
    col_s, order = torch.sort(col_v, stable=True)
    flat_s = flat[order]
    counts = torch.bincount(col_s, minlength=nc)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(flat_s.numel(), device=dev) - starts[col_s]
    overflow = bool(counts.max() > max_children) if nc else False
    keep = slot < max_children
    rows = torch.full((nc, max_children), INVALID_INDEX, dtype=torch.int32,
                      device=dev)
    weights = torch.zeros((nc, max_children), dtype=u_op.weights.dtype,
                          device=dev)
    rows[col_s[keep], slot[keep]] = (flat_s[keep] // 3).to(torch.int32)
    weights[col_s[keep], slot[keep]] = w[flat_s[keep]]
    return Restriction(rows=rows, weights=weights, n_fine=vf), overflow


def restrict_gather(rt: Restriction,
                    fine_values: torch.Tensor) -> torch.Tensor:
    """U^T via the children table: a fixed-shape gather + row reduce."""
    safe = rt.safe_rows()
    if fine_values.ndim == 1:
        return torch.sum(rt.weights * fine_values[safe], dim=1)
    return torch.einsum("ck,ckd->cd", rt.weights, fine_values[safe])
