"""Sort-based group-by primitives (counterparts of
``gravomg_tpu/ops/segment.py``): (row, col[, value]) triplets into
padded ELL rows, and payload ids grouped by row in ascending order.

Table widths come from the data where the caller names none, so there
is no overflow to flag on those calls.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gravomg_tpu_torch.types import INVALID_INDEX


class EllScatterResult(NamedTuple):
    columns: torch.Tensor            # (num_rows, K) int32, INVALID padding
    values: Optional[torch.Tensor]   # (num_rows, K) float or None
    counts: torch.Tensor             # (num_rows,) unique entries per row
    overflow: bool                   # some row had more than K entries


def lexsort_pairs(primary: torch.Tensor,
                  secondary: torch.Tensor) -> torch.Tensor:
    """Stable ascending sort order by (primary, secondary)."""
    by_secondary = torch.argsort(secondary, stable=True)
    return by_secondary[torch.argsort(primary[by_secondary], stable=True)]


def _row_slots(sorted_rows: torch.Tensor, num_rows: int):
    """(counts per row, slot of each entry inside its row) for row ids
    sorted ascending."""
    counts = torch.bincount(sorted_rows, minlength=num_rows)
    starts = torch.cumsum(counts, 0) - counts
    slot = (torch.arange(sorted_rows.numel(), device=sorted_rows.device)
            - starts[sorted_rows])
    return counts, slot


def build_ell_rows(rows: torch.Tensor, cols: torch.Tensor,
                   valid: torch.Tensor, num_rows: int,
                   max_cols: Optional[int] = None,
                   values: Optional[torch.Tensor] = None,
                   combine: str = "add") -> EllScatterResult:
    """Padded ELL table of the valid triplets.

    Duplicate (row, col) pairs merge, their values combined with
    ``combine`` ("add" or "min"); rows come out ascending by column.
    ``max_cols=None`` sizes the table to the longest row (at least one
    column).  Entries beyond a given ``max_cols`` per row are dropped
    and flagged in ``overflow``.
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
    counts, slot = _row_slots(ur, num_rows)
    if max_cols is None:
        max_cols = max(int(counts.max()) if num_rows else 0, 1)
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


def group_ordered(rows: torch.Tensor, payload: torch.Tensor,
                  valid: torch.Tensor, num_rows: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Payload ids grouped by row, ascending inside each row, no dedup.

    Returns (table (num_rows, W) int32 with INVALID_INDEX padding, counts
    (num_rows,)); W is the longest row (at least one column).  Used for
    the triangle association lists, which the reference builds in
    triangle-id order.
    """
    r = rows[valid].long()
    key, _ = torch.sort(r * 2**31 + payload[valid].long())
    sr = key // 2**31
    counts, slot = _row_slots(sr, num_rows)
    width = max(int(counts.max()) if num_rows else 0, 1)
    table = torch.full((num_rows, width), INVALID_INDEX, dtype=torch.int32,
                       device=rows.device)
    table[sr, slot] = (key % 2**31).to(torch.int32)
    return table, counts.to(torch.int32)
