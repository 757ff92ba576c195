"""Block-window dense SpMV format (counterpart of
``gravomg_tpu/ops/blockdense.py``).

For a row block b (BLK consecutive rows after spatial ordering) the
operator stores NW column windows: window 0 of width WIN0 anchored on
the block, the rest of width WIN greedily covering the block's remaining
columns.  ``m[b]`` is a dense (BLK, WIN0 + (NW-1)*WIN) matrix holding the
entries at their window-local positions; columns no window covers go to
an exact sorted-COO escape chute.  Then

    y = diag*x + sum_w m[b, :, window w] @ x[win_start[b, w] : +width]
        + escape.

The conversion reproduces the JAX package's arrays exactly (same window
placement, same escape order), so converted operators can be compared
array for array.  The kernels that apply the aligned slab buckets on the
card are in ``ops/blockdense_cuda.py`` and ``ops/mxu_cuda.py``.  The
uniform forms that ``attach_fast_operators`` builds for the levels the
slab forms do not take (unaligned windows, window 0 anchored at
:func:`block_anchors` or the scaled diagonal) run through
:func:`blockdense_matvec`, the plain torch port of the JAX package's
XLA matvec, which rounds the gathered x to m's dtype; the JAX package
runs these forms through XLA, never through a Pallas kernel.  That
matvec also takes D right-hand sides at once, and a stack of
same-shape operators (``parallel/batch.py``).  One form on a 1-D x on
the card takes the uniform kernel instead (``ops/uniform_cuda.py``),
one launch for the same function.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gravomg_tpu_torch.types import EllOperator, batched_take

_IMAX = 2**31 - 1


class BlockDenseOperator(NamedTuple):
    """y = diag*x + blockdense(m, x) + escape (see module doc).

    diag:      (R,) or None (rectangular operators have no diagonal).
    m:         (NBLK, BLK, WIN0 + (NW-1)*WIN) window-local entries.
    win_start: (NBLK, NW) int32 window starts into x.
    esc_rows/esc_cols/esc_w: sorted-COO escape chute; padding slots hold
      row ``n_rows`` and weight 0.
    """

    diag: Optional[torch.Tensor]
    m: torch.Tensor
    win_start: torch.Tensor
    esc_rows: torch.Tensor
    esc_cols: torch.Tensor
    esc_w: torch.Tensor
    n_rows: int
    n_cols: int
    block: int
    window: int
    window0: int
    align: int = 0      # window starts are multiples of this (0: any)

    @property
    def nw(self) -> int:
        return self.win_start.shape[-1]

    @property
    def stacked(self) -> bool:
        """A stack of same-shape operators (leading mesh axis on every
        tensor, ``parallel/batch.py``)."""
        return self.win_start.ndim == 3


def blockdense_from_ell(cols: torch.Tensor, vals: torch.Tensor,
                        valid: torch.Tensor, n_cols: int,
                        diag: Optional[torch.Tensor] = None,
                        block: int = 64, window: int = 256, nw: int = 4,
                        escape_cap: int = 8192,
                        window0: Optional[int] = None,
                        anchors: Optional[torch.Tensor] = None,
                        align: int = 0
                        ) -> Tuple[BlockDenseOperator, bool]:
    """Build a BlockDenseOperator from (R, K) ELL columns/values/mask.

    Window 0 anchors at ``anchors`` (per-block centres) when given, else
    at the block's scaled diagonal; windows 1..NW-1 greedily cover the
    remaining columns.  ``align`` (e.g. 128) floors every window start to
    that multiple; the CUDA kernel needs 128.  Returns (op, overflow):
    overflow means the escape chute exceeded ``escape_cap``.
    """
    if window0 is None:
        window0 = window
    dev = cols.device
    r, k = cols.shape
    valid = valid & (vals != 0.0)       # zero entries contribute nothing
    nblk = -(-r // block)
    rpad = nblk * block
    cols64 = cols.long()

    # Greedy window placement, in int64 so that s + window never wraps.
    bc = torch.full((rpad, k), _IMAX, dtype=torch.int64, device=dev)
    bc[:r] = torch.where(valid, cols64, torch.full_like(cols64, _IMAX))
    bc = bc.reshape(nblk, block * k)
    if anchors is not None:
        anchor = anchors.long() - window0 // 2
    else:
        ratio = n_cols / r
        anchor = ((torch.arange(nblk, device=dev, dtype=torch.float64)
                   * block * ratio).long()
                  - (window0 - int(block * ratio)) // 2)
    if align:
        if align > window:
            raise ValueError("alignment must not exceed the window width")
        # x is padded past n_cols by the matvec, so window 0 may run off
        # the right edge.
        w0 = torch.clamp(anchor, 0, max(n_cols - 1, 0))
        w0 = (w0 // align) * align
    else:
        w0 = torch.clamp(anchor, 0, max(n_cols - window0, 0))
    starts = [w0]
    imax_t = torch.full_like(bc, _IMAX)
    remaining = torch.where((bc >= w0[:, None]) & (bc < w0[:, None] + window0),
                            imax_t, bc)
    for _ in range(nw - 1):
        s = torch.min(remaining, dim=1).values
        if align:
            s = torch.where(s < _IMAX, (s // align) * align, s)
        starts.append(s)
        remaining = torch.where(remaining < s[:, None] + window, imax_t,
                                remaining)
    win_start = torch.stack(starts, dim=1)
    if align:
        win_start = torch.where(win_start > n_cols - 1,
                                torch.zeros_like(win_start), win_start)
    else:
        widths = torch.tensor([window0] + [window] * (nw - 1),
                              dtype=torch.int64, device=dev)
        lims = torch.clamp(n_cols - widths, min=0)[None, :]
        win_start = torch.where(win_start > n_cols - 1,
                                torch.zeros_like(win_start),
                                torch.minimum(win_start, lims))
    win_start = torch.clamp(win_start, min=0)

    # First-hit window assignment per entry.
    rows = torch.arange(r, device=dev)[:, None].expand(r, k)
    c_s = torch.where(valid, cols64, torch.zeros_like(cols64))
    row_blk = torch.arange(r, device=dev) // block
    sel = torch.full((r, k), -1, dtype=torch.int64, device=dev)
    pos = torch.zeros((r, k), dtype=torch.int64, device=dev)
    offsets = [0] + [window0 + wi * window for wi in range(nw - 1)]
    for wi in range(nw):
        width = window0 if wi == 0 else window
        ws_w = win_start[:, wi][row_blk][:, None]
        hit = valid & (sel < 0) & (c_s >= ws_w) & (c_s < ws_w + width)
        sel = torch.where(hit, wi, sel)
        pos = torch.where(hit, offsets[wi]
                          + torch.clamp(c_s - ws_w, 0, width - 1), pos)
    covered = sel >= 0

    nww = window0 + (nw - 1) * window
    m = torch.zeros((rpad * nww,), dtype=vals.dtype, device=dev)
    m.index_put_(((rows * nww + pos)[covered],), vals[covered],
                 accumulate=True)
    m = m.reshape(nblk, block, nww)

    # Escape chute, stably sorted by row; padding rows point at r.
    esc = valid & ~covered
    overflow = int(esc.sum()) > escape_cap
    flat_rows = torch.where(esc, rows, torch.full_like(rows, r)).reshape(-1)
    order = torch.argsort(flat_rows, stable=True)[:escape_cap]
    esc_rows = flat_rows[order].to(torch.int32)
    esc_cols = torch.where(esc, c_s, torch.zeros_like(c_s)).reshape(-1)[
        order].to(torch.int32)
    esc_w = torch.where(esc, vals, torch.zeros_like(vals)).reshape(-1)[order]

    return (BlockDenseOperator(diag=diag, m=m,
                               win_start=win_start.to(torch.int32),
                               esc_rows=esc_rows, esc_cols=esc_cols,
                               esc_w=esc_w, n_rows=r, n_cols=n_cols,
                               block=block, window=window, window0=window0,
                               align=align),
            overflow)


def trim_escape(op: BlockDenseOperator,
                align: int = 128) -> BlockDenseOperator:
    """Slice the escape COO down to its fill, rounded up to ``align``
    slots (sorted padding sits at the tail)."""
    if not op.esc_rows.shape[0]:
        return op
    n = int((op.esc_rows < op.n_rows).sum())
    cap = 0 if n == 0 else min(-(-n // align) * align, op.esc_rows.shape[0])
    if cap == op.esc_rows.shape[0]:
        return op
    return op._replace(esc_rows=op.esc_rows[:cap],
                       esc_cols=op.esc_cols[:cap], esc_w=op.esc_w[:cap])


def window_index(op: BlockDenseOperator, n_x: int) -> torch.Tensor:
    """(NBLK, NWW) indices into x zero-padded to :func:`padded_length`,
    window by window in m's column order ((B, NBLK, NWW) for a stack)."""
    dev = op.win_start.device
    xlen = padded_length(op, n_x)
    parts = []
    for wi in range(op.nw):
        width = op.window0 if wi == 0 else op.window
        # Starts clamp like a dynamic slice: the window stays in bounds.
        s = torch.clamp(op.win_start[..., wi].long(), 0, xlen - width)
        parts.append(s[..., None] + torch.arange(width, device=dev))
    return torch.cat(parts, dim=-1)


def padded_length(op: BlockDenseOperator, n_x: int) -> int:
    """Length of x zero-padded so every window reads in bounds: n_x plus
    the widest window, rounded up to a multiple of 128."""
    return -(-(n_x + max(op.window, op.window0)) // 128) * 128


def pad_x(op: BlockDenseOperator, x: torch.Tensor) -> torch.Tensor:
    """x (n_cols,) or (n_cols, D) zero-padded along its rows to
    :func:`padded_length`, contiguous; for a stack of operators, x (B,
    n_cols) padded along its last axis."""
    if op.stacked:
        n = x.shape[1]
        return torch.nn.functional.pad(x, (0, padded_length(op, n) - n))
    xp = x.new_zeros((padded_length(op, x.shape[0]),) + x.shape[1:])
    xp[:x.shape[0]] = x
    return xp


def add_escape(op: BlockDenseOperator, y: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """y + the escape chute's sorted-COO contributions (y has n_rows;
    x and y are (n,), (n, D), or (B, n) for a stack of operators).

    ``index_add_`` adds in no fixed order on the card; compare at a
    tolerance."""
    if not op.esc_w.shape[-1]:
        return y
    cols = torch.clamp(op.esc_cols, max=op.n_cols - 1)
    if op.stacked:
        r = y.shape[1]
        contrib = (op.esc_w * batched_take(x, cols)).to(x.dtype)
        acc = x.new_zeros((x.shape[0], r + 1))
        acc.scatter_add_(1, torch.clamp(op.esc_rows, max=r).long(), contrib)
        return y + acc[:, :r]
    r = y.shape[0]
    w = op.esc_w if x.ndim == 1 else op.esc_w[:, None]
    contrib = (w * x[cols]).to(x.dtype)
    acc = x.new_zeros((r + 1,) + x.shape[1:])
    acc.index_add_(0, torch.clamp(op.esc_rows, max=r), contrib)
    return y + acc[:r]


def slab_escape(op, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y (rows in row order, as many as the slab form ``op``'s output
    blocks hold) plus its buckets' escape chutes, for x (n_cols,) or
    (n_cols, D).  The forms ``slab_from_ell`` builds today have none; a
    bucket's chute rows are in bucket order, placed by inv_block_perm."""
    if not any(b.esc_w.shape[0] for b in op.buckets):
        return y
    tail = tuple(x.shape[1:])
    parts = [add_escape(b, x.new_zeros((b.m.shape[0] * op.block,) + tail),
                        x).reshape(-1, op.block, *tail)
             for b in op.buckets]
    return y + torch.cat(parts)[op.inv_block_perm].reshape(-1, *tail)


def blockdense_matvec(op: BlockDenseOperator, x: torch.Tensor
                      ) -> torch.Tensor:
    """y = A x, plain torch: x (n_cols,), or (n_cols, D) for D
    right-hand sides, or (B, n_cols) for a stack of operators, one row
    per mesh.

    As in the JAX package's non-kernel path, the gathered windows are
    rounded to m's dtype (for bf16 m this differs from the block-window
    kernel, which multiplies by f32 x).  The products are formed and
    summed in f32, as the JAX package's jitted solvers form them: XLA
    drops the bf16 rounding of the product under jit (excess precision),
    which moves a bf16 matvec by ~1e-3 relative against JAX's op-by-op
    result on the 24k fixture.  A 2-D x, and a stack, take one batched
    f32 product of m with the gathered windows (TF32 must be off, as it
    is by default), which is the function JAX's vmap of the 1-D matvec
    computes."""
    r = op.n_rows
    acc = torch.promote_types(op.m.dtype, torch.float32)
    m = op.m.to(acc)
    idx = window_index(op, x.shape[-1] if op.stacked else x.shape[0])
    if op.stacked:
        wins = batched_take(pad_x(op, x), idx)          # (B, NBLK, NWW)
        y = torch.matmul(m, wins.to(op.m.dtype).to(acc)[..., None])
        y = y.reshape(x.shape[0], -1)[:, :r].to(x.dtype)
        diag = op.diag
    elif x.ndim == 2:
        wins = pad_x(op, x)[idx]                        # (NBLK, NWW, D)
        y = torch.matmul(m, wins.to(op.m.dtype).to(acc))
        y = y.reshape(-1, x.shape[1])[:r].to(x.dtype)
        diag = None if op.diag is None else op.diag[:, None]
    else:
        wins = pad_x(op, x)[idx].to(op.m.dtype).to(acc)
        y = torch.sum(m * wins[:, None, :], dim=2)
        y = y.reshape(-1)[:r].to(x.dtype)
        diag = op.diag
    y = add_escape(op, y, x)
    if diag is not None:
        y = y + diag * x
    return y


def blockdense_from_operator(op: EllOperator, **kw
                             ) -> Tuple[BlockDenseOperator, bool]:
    """Square-operator wrapper (keeps the diagonal exact)."""
    return blockdense_from_ell(op.neighbors, op.offdiag, op.mask,
                               op.num_vertices, diag=op.diag, **kw)


def block_anchors(cols: torch.Tensor, valid: torch.Tensor,
                  block: int) -> torch.Tensor:
    """Per-block window-0 anchor: the median of each row's first valid
    column (its largest valid column when slot 0 is empty, 0 when the row
    is empty; pad rows count as 0), 0 for a block with no valid column.
    The median of an even count is the mean of the middle two in float32,
    truncated, as ``jnp.median`` gives it."""
    r, k = cols.shape
    nblk = -(-r // block)
    dev = cols.device
    cols64 = cols.long()
    has = valid.any(dim=1)
    top = torch.where(valid, cols64, torch.full_like(cols64, -1)).amax(dim=1)
    first = torch.where(valid[:, 0], cols64[:, 0],
                        torch.where(has, top, torch.zeros_like(top)))
    fb = torch.zeros((nblk * block,), dtype=torch.int64, device=dev)
    fb[:r] = first
    srt = torch.sort(fb.reshape(nblk, block), dim=1).values.to(torch.float32)
    med = ((srt[:, (block - 1) // 2] + srt[:, block // 2]) * 0.5).to(
        torch.int32)
    blk_has = torch.zeros((nblk * block,), dtype=torch.bool, device=dev)
    blk_has[:r] = has
    return torch.where(blk_has.reshape(nblk, block).any(dim=1), med,
                       torch.zeros_like(med))
