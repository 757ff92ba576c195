"""What the probes and ``chip_smoke.py`` share to time a kernel on the
card and to hold the time against the card's bound.

A kernel's bound is the least time the card could take for the same
work: the bytes the function must move (each input read once, each
output written once) over the H100's published device-memory rate, or
its operations over the published f32 rate of the CUDA cores (a
multiply-add counts two), whichever is larger.  A device-memory bound
holds only for a call that finds its inputs in device memory: a working
set that fits in the 50 MB L2 and is timed again and again would be read
from L2.  So ``cold=True`` runs every timed call after writing a buffer
four times the L2's size, as a caller that walks other data in between
finds it.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from gravomg_tpu_torch.ops.blockdense import pad_x, padded_length

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published device-memory rate
F32_FLOPS = 67e12              # H100 SXM, published f32 rate, CUDA cores
L2_BYTES = 50 * 2**20          # H100 SXM, L2 cache
_flush_buffer = []             # the buffer flush_l2 writes, made at first use


def flush_l2() -> None:
    """Write four L2's worth of bytes on the current device, so that
    nothing read before stays in L2."""
    if not _flush_buffer:
        _flush_buffer.append(torch.empty(4 * L2_BYTES, dtype=torch.uint8,
                                         device="cuda"))
    _flush_buffer[0].zero_()


def cuda_ms(fn, reps: int = 10, warmup: int = 2, cold: bool = False) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events);
    with ``cold``, L2 flushed before each run (outside the events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cold:
            flush_l2()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_events(fn, match: str = "", cold: bool = False):
    """[(name, microseconds)] of the device kernels of one call of ``fn``
    whose name contains ``match``, in launch order, as torch.profiler saw
    them; [] if it saw none in two tries (now and then a trace comes back
    without its kernels).  With ``cold``, L2 is flushed before the traced
    call (outside the trace)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        if cold:
            flush_l2()
            torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evts = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and match in e.name),
                      key=lambda e: e.time_range.start)
        if evts:
            return [(e.name, e.time_range.elapsed_us()) for e in evts]
    return []


def kernel_ms(fn, match: str, reps: int = 5, cold: bool = False):
    """Median milliseconds, over ``reps`` calls of ``fn`` traced in one
    profiler session, of the device kernels whose name contains
    ``match`` in a call; None if the profiler saw none, or not the same
    number in every call, in two tries (a time that was not measured is
    not a zero).  One traced call is not enough: now and then the
    profiler reports a kernel's time range far off its true length.
    With ``cold``, L2 is flushed before each traced call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if cold:
                    flush_l2()
                fn()
                torch.cuda.synchronize()
        evts = sorted((e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and match in e.name),
                      key=lambda e: e.time_range.start)
        if evts and len(evts) % reps == 0:
            per = len(evts) // reps
            return statistics.median(
                sum(e.time_range.elapsed_us() for e in evts[i:i + per])
                for i in range(0, len(evts), per)) / 1e3
    return None


def bound(nbytes: int, flops: int):
    """(milliseconds, "bytes" or "operations"): the least time the card
    could take to move ``nbytes`` once and do ``flops`` f32 operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / F32_FLOPS * 1e3
    return (max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def nonzero_pairs(buckets) -> int:
    """(block, position) pairs of 8-row buckets where any of the block's
    rows holds a nonzero of m: the positions B1 multiplies."""
    return sum(int((b.m != 0).any(dim=1).sum()) for b in buckets)


def matvec_bound(buckets, x, plan=None):
    """Bound of one slab matvec over ``buckets``: (ms, bound_by, bytes).

    Without ``plan`` (the block-window kernels): m, win_start and the
    padded x read once, y written once (every block of every bucket).
    For x (n_cols,) one multiply-add per entry of m (the per-bucket
    route; one launch of K1: :func:`slab_matvec_bound`).  For x (n_cols,
    D) (B1, which skips the positions where all 8 rows of a block are
    zero) 8 * D multiply-adds
    per (block, position) pair with a nonzero (:func:`nonzero_pairs`),
    counted on these buckets' own m: the work these inputs need.  With
    the transposed-tile kernel's work table ``plan``: what that table
    makes the kernel read and write (``plan_bytes``: a bucket's padding
    blocks have no item and are not counted), one multiply-add per entry
    of the tiles read."""
    if plan is not None:
        from gravomg_tpu_torch.ops.mxu_cuda import plan_bytes
        pb = plan_bytes(buckets, plan)
        ms, by = bound(pb["io"],
                       2 * pb["tiles"] // buckets[0].m.element_size())
        return ms, by, pb["io"]
    d = 1 if x.ndim == 1 else x.shape[1]
    nbytes = (sum(b.m.numel() * b.m.element_size()
                  + b.win_start.numel() * b.win_start.element_size()
                  for b in buckets)
              + 4 * d * padded_length(buckets[0], x.shape[0])
              + 4 * d * sum(b.m.shape[0] * b.block for b in buckets))
    if x.ndim == 1:
        madds = sum(b.m.numel() for b in buckets)
    else:
        madds = 8 * d * nonzero_pairs(buckets)
    ms, by = bound(nbytes, 2 * madds)
    return ms, by, nbytes


def used_blocks(op) -> list:
    """Per bucket of an 8-row slab form, the blocks its inv_block_perm
    names: what one launch of K1 or B1 reads (a bucket's padding blocks
    are not read)."""
    inv = op.inv_block_perm.long()
    ends = np.cumsum([b.m.shape[0] for b in op.buckets])
    return [int(((inv >= hi - b.m.shape[0]) & (inv < hi)).sum())
            for b, hi in zip(op.buckets, ends)]


def slab_m_read(op) -> int:
    """Bytes of m one launch of K1 or B1 reads on an 8-row slab form."""
    return sum(u * b.m[0].numel() * b.m.element_size()
               for u, b in zip(used_blocks(op), op.buckets))


def slab_matvec_bound(op, x):
    """Bound of one launch of K1 over the 8-row slab form ``op`` on x
    (n_cols,): (ms, bound_by, bytes).  The launch reads m and win_start
    of the blocks inv_block_perm names (:func:`used_blocks`),
    inv_block_perm, x unpadded and the diagonal once, and writes y's
    n_rows entries once; one multiply-add per entry of m it reads and per
    row of the diagonal."""
    used = used_blocks(op)
    n_diag = 0 if op.diag is None else op.diag.shape[0]
    nbytes = (slab_m_read(op)
              + sum(u * b.win_start.shape[1] * b.win_start.element_size()
                    for u, b in zip(used, op.buckets))
              + op.inv_block_perm.numel() * op.inv_block_perm.element_size()
              + x.shape[0] * x.element_size()
              + (0 if op.diag is None
                 else n_diag * op.diag.element_size())
              + op.n_rows * x.element_size())
    madds = sum(u * b.m[0].numel() for u, b in zip(used, op.buckets))
    ms, by = bound(nbytes, 2 * (madds + n_diag))
    return ms, by, nbytes


def library_bmm(buckets, x):
    """One ``torch.bmm`` per bucket on already gathered windows: the
    library's time for the same products (f32 m only; the gather of x,
    the escape chute and the un-permutation are not in it).  For a
    (n_cols, D) x on 8-row blocks: m (NBLK, 8, NWW) @ windows (NBLK,
    NWW, D).  The port never calls it.  Returns the function to time."""
    if x.ndim == 2:
        d = x.shape[1]
        x3 = pad_x(buckets[0], x).view(-1, 128, d)
        pairs = [(b.m, x3[b.win_start.long() // 128]
                  .reshape(b.m.shape[0], -1, d).contiguous())
                 for b in buckets]
        return lambda: [torch.bmm(m, w) for m, w in pairs]
    x2 = pad_x(buckets[0], x).view(-1, 128)
    pairs = []
    for b in buckets:
        nblk = b.m.shape[0]
        wins = x2[b.win_start.long() // 128].reshape(nblk, -1)
        if b.m.ndim == 4:       # transposed tiles: (1, L) @ (L, 128)
            pairs.append((wins[:, None, :].contiguous(),
                          b.m.reshape(nblk, -1, 128)))
        else:                   # 8-row blocks: (8, L) @ (L, 1)
            pairs.append((b.m, wins[:, :, None].contiguous()))

    def run():
        for left, right in pairs:
            torch.bmm(left, right)
    return run


def bucket_loop(fn, buckets, x):
    """One slab matvec's bucket calls of ``fn(bucket, x, xp)``, x ((n,)
    or (n, D)) padded once per matvec as ``slab_matvec`` pads it.
    Returns the function to time."""
    def run():
        xp = pad_x(buckets[0], x)
        for b in buckets:
            fn(b, x, xp)
    return run
