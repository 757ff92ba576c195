"""Grid transfers (counterpart of the transfer half of
``gravomg_tpu/prolong/operator.py``): prolongation by U, restriction by
U^T in scatter form and in the precomputed gather form.

Constructing U itself (``construct_prolongation``) is not ported yet;
hierarchies come from ``gravomg_tpu_torch.hierarchy`` or from a saved
solver.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gravomg_tpu_torch.types import INVALID_INDEX, Prolongation, Restriction


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
