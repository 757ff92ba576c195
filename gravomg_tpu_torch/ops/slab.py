"""Bucketed variable-window (slab) SpMV (counterpart of
``gravomg_tpu/ops/slab.py``): pay only for the windows each row block
needs.

Row blocks are partitioned into buckets by their greedy first-fit
window count, permuted so each bucket is contiguous, and each bucket is
one aligned BlockDenseOperator whose window count is the bucket cap.
The matvec takes one launch of a kernel for all buckets, which writes y
in row order through ``inv_block_perm``: the block-window kernel K1 for
a (n_cols,) x, the batched kernel B1 for a (n_cols, D) x, the
transposed-tile kernel for that form (the JAX package runs its kernel
once per bucket and un-permutes the output at block granularity, the
same function).  Each bucket's block count is
padded to a multiple of 8 (32 above 32 blocks) as in the JAX package, so
the converted arrays, ``inv_block_perm`` included, equal the JAX
package's.

``mxu=True`` selects the JAX package's transposed-tile form: 128-row
blocks, each bucket's ``m`` stored as (NBP, cap, 128, 128) tiles with
``m[b, s, l, r] = A[b*128 + r, win_start[b, s] + l]``, applied by the
kernel of ``ops/mxu_cuda.py`` (which rounds x to m's dtype, as the TPU
kernel does) from the form's work table ``plan``, built here once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              blockdense_from_ell,
                                              trim_escape)
from gravomg_tpu_torch.ops.blockdense_cuda import (slab_matmat_fast,
                                                   slab_matvec_1d_fast)
from gravomg_tpu_torch.ops.mxu_cuda import (MxuPlan, mxu_plan,
                                            mxu_slab_matvec_fast)

_IMAX = 2**31 - 1

# The slab geometry: 8-row blocks (128 in the transposed-tile form),
# 128-wide windows at 128-aligned starts (what both kernels take), at
# most 24 windows a block.  Counts round up to the nearest bucket cap.
BLOCK, MXU_BLOCK, WINDOW, NW_MAX = 8, 128, 128, 24
_BUCKET_CAPS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24)


class SlabOperator(NamedTuple):
    """y = diag*x + concat_k(bucket_k(x))[inv_block_perm] (module doc)."""

    diag: Optional[torch.Tensor]
    buckets: Tuple[BlockDenseOperator, ...]
    inv_block_perm: torch.Tensor       # (NBLK,) into concatenated blocks
    n_rows: int
    n_cols: int
    block: int
    mxu: bool = False                  # transposed-tile form (module doc)
    plan: Optional[MxuPlan] = None     # its work table (ops/mxu_cuda.py)

    @property
    def m_bytes(self) -> int:
        return sum(b.m.numel() * b.m.element_size() for b in self.buckets)


def window_counts(cols: torch.Tensor, valid: torch.Tensor, block: int,
                  window: int, nw_max: int = 24, align: int = 0):
    """Per-block greedy first-fit window counts (the rule of
    blockdense_from_ell's far-window placement).  Returns ((NBLK,)
    counts, (NBLK,) first-window start, overflow)."""
    r, k = cols.shape
    nblk = -(-r // block)
    bc = torch.full((nblk * block, k), _IMAX, dtype=torch.int64,
                    device=cols.device)
    bc[:r] = torch.where(valid, cols.long(), torch.full_like(bc[:r], _IMAX))
    remaining = bc.reshape(nblk, block * k)
    imax_t = torch.full_like(remaining, _IMAX)
    counts = torch.zeros((nblk,), dtype=torch.int32, device=cols.device)
    first = torch.zeros((nblk,), dtype=torch.int64, device=cols.device)
    for wi in range(nw_max):
        s = torch.min(remaining, dim=1).values
        if align:
            s = torch.where(s < _IMAX, (s // align) * align, s)
        has = s < _IMAX
        if wi == 0:
            first = torch.where(has, s, torch.zeros_like(s))
        counts = counts + has.to(torch.int32)
        remaining = torch.where(remaining < s[:, None] + window, imax_t,
                                remaining)
    overflow = bool((torch.min(remaining, dim=1).values < _IMAX).any())
    return counts, first.to(torch.int32), overflow


def slab_from_ell(cols: torch.Tensor, vals: torch.Tensor,
                  valid: torch.Tensor, n_cols: int,
                  diag: Optional[torch.Tensor] = None,
                  escape_cap: int = 4096, mxu: bool = False) -> SlabOperator:
    """Build a SlabOperator from (R, K) ELL columns/values/mask; ``mxu``
    selects the transposed-tile form (128-row blocks).

    Raises ValueError if ``NW_MAX`` windows cannot cover some block
    (the cloud is not spatially ordered) or a bucket's escape chute
    overflows ``escape_cap`` (the message then says "escape overflow").
    """
    dev = cols.device
    r, k = cols.shape
    block, window = (MXU_BLOCK if mxu else BLOCK), WINDOW
    valid = valid & (vals != 0.0)
    counts, first, ovf = window_counts(cols, valid, block, window, NW_MAX,
                                       align=window)
    if ovf:
        raise ValueError(
            f"slab_from_ell: >{NW_MAX} windows needed for some block; "
            "is the cloud spatially ordered?")
    counts_h = counts.cpu().numpy()
    nblk = counts_h.shape[0]
    caps = np.asarray(_BUCKET_CAPS, np.int32)
    # Empty blocks ride in the smallest bucket.
    cap_idx = np.searchsorted(caps, np.maximum(counts_h, 1))
    perm = np.argsort(cap_idx, kind="stable").astype(np.int64)

    # Rows in bucket order.
    rpad = nblk * block
    cols_p = torch.zeros((rpad, k), dtype=cols.dtype, device=dev)
    cols_p[:r] = torch.where(valid, cols, torch.zeros_like(cols))
    vals_p = torch.zeros((rpad, k), dtype=vals.dtype, device=dev)
    vals_p[:r] = vals
    valid_p = torch.zeros((rpad, k), dtype=torch.bool, device=dev)
    valid_p[:r] = valid
    perm_t = torch.as_tensor(perm, device=dev)
    row_perm = (perm_t[:, None] * block
                + torch.arange(block, device=dev)[None, :]).reshape(-1)
    cols_s, vals_s, valid_s = cols_p[row_perm], vals_p[row_perm], \
        valid_p[row_perm]
    first_s = first.cpu().numpy().astype(np.int64)[perm]

    buckets, out_blocks = [], []
    start = 0
    bpad = 32
    inv = np.empty((nblk,), np.int32)
    pad_off = 0
    for ci in range(len(caps)):
        nb = int(np.sum(cap_idx == ci))
        if nb == 0:
            continue
        cap = int(caps[ci])
        nbp = -(-nb // bpad) * bpad if nb > bpad else -(-nb // 8) * 8
        lo, hi = start * block, (start + nb) * block
        c_b, v_b, m_b = cols_s[lo:hi], vals_s[lo:hi], valid_s[lo:hi]
        anch = first_s[start:start + nb]
        if nbp > nb:
            padn = (nbp - nb) * block
            c_b = torch.cat([c_b, c_b.new_zeros((padn, k))])
            v_b = torch.cat([v_b, v_b.new_zeros((padn, k))])
            m_b = torch.cat([m_b, m_b.new_zeros((padn, k))])
            anch = np.pad(anch, (0, nbp - nb))
        # Window 0 anchors at each block's first-fit start, so placement
        # matches window_counts exactly.
        bop, b_ovf = blockdense_from_ell(
            c_b, v_b, m_b, n_cols, diag=None, block=block, window=window,
            nw=cap, escape_cap=escape_cap, window0=window,
            anchors=torch.as_tensor(anch + window // 2, device=dev),
            align=window)
        if b_ovf:
            raise ValueError("slab_from_ell: escape overflow in bucket "
                             f"cap={cap} (escape_cap={escape_cap})")
        bop = trim_escape(bop)
        if mxu:
            # (NBP, 128, cap*128) row-major -> (NBP, cap, 128, 128) tiles
            # [b, s, l, r].
            bop = bop._replace(m=bop.m.reshape(nbp, block, cap, window)
                               .permute(0, 2, 3, 1).contiguous())
        buckets.append(bop)
        out_blocks.append(np.concatenate(
            [perm[start:start + nb], np.full(nbp - nb, -1, np.int64)]))
        inv[perm[start:start + nb]] = pad_off + np.arange(nb)
        start += nb
        pad_off += nbp

    plan = None
    if mxu:
        plan = mxu_plan([tuple(b.win_start.shape) for b in buckets],
                        out_blocks, dev)
    return SlabOperator(diag=diag, buckets=tuple(buckets),
                        inv_block_perm=torch.as_tensor(inv, device=dev),
                        n_rows=r, n_cols=n_cols, block=block, mxu=mxu,
                        plan=plan)


def slab_matvec(op: SlabOperator, x: torch.Tensor) -> torch.Tensor:
    """y = A x for x (n_cols,) or, on the 8-row form, (n_cols, D).

    Each takes one launch of a kernel over all buckets of the form, which
    writes y in row order: an ``mxu`` form the transposed-tile kernel; an
    8-row form with a 1-D x the block-window kernel K1, the diagonal
    fused into its store; an 8-row form with a 2-D x the batched kernel
    B1; on the CPU their plain twins.  An ``mxu`` form refuses a 2-D x:
    the cycle sends it the ELL gather."""
    if op.mxu:
        if x.ndim != 1:
            raise ValueError("the transposed-tile (mxu) slab form takes a "
                             "1-D x only")
        y = mxu_slab_matvec_fast(op, x)
    elif x.ndim == 2:
        y = slab_matmat_fast(op, x)
    else:
        return slab_matvec_1d_fast(op, x)
    if op.diag is not None:
        y = y + (op.diag if x.ndim == 1 else op.diag[:, None]) * x
    return y


def slab_from_operator(op, **kw) -> SlabOperator:
    """Square-operator wrapper (keeps the diagonal exact)."""
    return slab_from_ell(op.neighbors, op.offdiag, op.mask,
                         op.num_vertices, diag=op.diag, **kw)
