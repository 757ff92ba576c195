"""Group (row, col[, value]) triplets into padded ELL rows (counterpart
of ``gravomg_tpu/ops/segment.py::build_ell_rows``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gravomg_tpu_torch.types import INVALID_INDEX


class EllScatterResult(NamedTuple):
    columns: torch.Tensor            # (num_rows, K) int32, INVALID padding
    values: Optional[torch.Tensor]   # (num_rows, K) float or None
    counts: torch.Tensor             # (num_rows,) unique entries per row
    overflow: bool                   # some row had more than K entries


def build_ell_rows(rows: torch.Tensor, cols: torch.Tensor,
                   valid: torch.Tensor, num_rows: int, max_cols: int,
                   values: Optional[torch.Tensor] = None,
                   combine: str = "add") -> EllScatterResult:
    """Padded ELL table of the valid triplets.

    Duplicate (row, col) pairs merge, their values combined with
    ``combine`` ("add" or "min"); rows come out ascending by column.
    Entries beyond ``max_cols`` per row are dropped and flagged in
    ``overflow``.
    """
    if combine not in ("add", "min"):
        raise ValueError(f"unknown combine mode {combine!r}")
    dev = rows.device
    r = rows[valid].long()
    c = cols[valid].long()
    key = r * 2**31 + c
    uniq, inverse = torch.unique(key, sorted=True, return_inverse=True)
    ur = uniq // 2**31
    uc = uniq % 2**31
    counts = torch.bincount(ur, minlength=num_rows)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(uniq.numel(), device=dev) - starts[ur]
    keep = slot < max_cols
    overflow = bool((counts > max_cols).any())
    columns = torch.full((num_rows, max_cols), INVALID_INDEX,
                         dtype=torch.int32, device=dev)
    columns[ur[keep], slot[keep]] = uc[keep].to(torch.int32)

    out_values = None
    if values is not None:
        v = values[valid]
        if combine == "add":
            merged = v.new_zeros((uniq.numel(),)).index_add_(0, inverse, v)
            fill = 0.0
        else:
            merged = v.new_full((uniq.numel(),), float("inf")).scatter_reduce_(
                0, inverse, v, reduce="amin")
            fill = float("inf")
        out_values = torch.full((num_rows, max_cols), fill, dtype=v.dtype,
                                device=dev)
        out_values[ur[keep], slot[keep]] = merged[keep]
    return EllScatterResult(columns, out_values,
                            torch.clamp(counts, max=max_cols).to(torch.int32),
                            overflow)
