"""The block-window SpMV kernels: K1 (``csrc/blockdense_matvec.cu``) for
one right-hand side and B1 (``csrc/blockdense_matmat.cu``) for D of them
at once; each with its wrappers, its plain torch twins and the dispatch
between them.  Both take all buckets of an 8-row slab form in one launch
and write y in row order, streaming m once through the shared ring of
``csrc/block_ring.cuh``.

K1 replaces the TPU kernel ``_matvec_kernel`` of
``gravomg_tpu/ops/pallas_blockdense.py``, which the JAX package's
``slab_matvec`` launches once per bucket.  For an 8-row slab form and x
(n_cols,) one launch computes

    y[o*8 + r] = sum_l m[c, r, l] * x[window column of l]
                 + diag[o*8 + r] * x[o*8 + r]

for output block o in row order and c = inv_block_perm[o] its block in
the buckets laid end to end, in f32, with m in f32 or bf16 (upcast
exactly) and x in f32, never rounded to m's dtype; the form's diagonal is
fused into the store, the escape chute added here in torch
(:func:`slab_matvec_cuda`, its twin :func:`slab_matvec_plain`, the
dispatch :func:`slab_matvec_1d_fast`).  :func:`blockdense_matvec_cuda`
runs the same kernel over one bucket, with :func:`blockdense_matvec_plain`
its twin and :func:`blockdense_matvec_fast` the dispatch; its
``launches`` counts every launch of K1.

B1 replaces the same TPU kernel as the JAX package runs it under
``jax.vmap`` over the columns of X (the c5 recipe of
``scripts/bench_configs.py``): for an 8-row aligned operator and X
(n_cols, D) zero-padded by :func:`pad_x`,

    Y[b*8 + r, j] = sum_l m[b, r, l] * Xp[window column of l, j]

in f32 with X never rounded, m read once for all columns, and only the
positions where a block's 8 rows hold a nonzero multiplied.  One launch
applies all buckets of an 8-row slab form and writes Y in row order
(:func:`slab_matmat_cuda`, its twin :func:`slab_matmat_plain`, the
dispatch :func:`slab_matmat_fast`); :func:`blockdense_matmat_cuda` runs
the same kernel over one bucket.  Skipping a zero position is exact for
finite X: where X holds an Inf or a NaN at a position whose 8 entries of
m are all zero, the twin gives NaN (0 * Inf) and the kernel does not.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the
twin.  The shared libraries are built with ``nvcc`` at first use from the
sources in the package into ``gravomg_tpu_torch/_build/`` and bound with
ctypes (plain C interface, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              add_escape, pad_x,
                                              padded_length, slab_escape)
from gravomg_tpu_torch.utils.build import CudaLibrary

# The buckets of one launch (base pointers, window starts, caps, first
# blocks, count), inv_block_perm, n_out, x's entries and their count.
_BUCKET_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
_ARGS = _BUCKET_ARGS + [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                        ctypes.c_void_p]        # diag, n_diag, y, stream
LIBRARY = CudaLibrary("blockdense_matvec.cu",
                      {"gmg_blockdense_matvec_f32": _ARGS,
                       "gmg_blockdense_matvec_bf16": _ARGS})
_MM_ARGS = _BUCKET_ARGS + [ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]     # y, D, stream
MATMAT_LIBRARY = CudaLibrary("blockdense_matmat.cu",
                             {"gmg_blockdense_matmat_f32": _MM_ARGS,
                              "gmg_blockdense_matmat_bf16": _MM_ARGS})
MAX_BUCKETS = 12            # buckets one launch of K1 or B1 takes
# Window entries (blocks x NWW x D) the twin gathers at a time.
_TWIN_CHUNK = 1 << 28


def _check_aligned_op(op: BlockDenseOperator) -> None:
    if op.align != 128 or op.window != 128 or op.window0 != 128:
        raise ValueError("the block-window kernel needs 128-wide windows "
                         "with 128-aligned starts (build with align=128, "
                         "window=window0=128)")


def _check_slab(op) -> None:
    if op.mxu or op.block != 8:
        raise ValueError("K1 and B1 take the 8-row slab form, not the "
                         "transposed-tile (mxu) one")


def _launch_buckets(buckets: Sequence[BlockDenseOperator],
                    inv: Optional[torch.Tensor], n_out: int,
                    x: torch.Tensor, name: str):
    """Checks the buckets of one launch of K1 or B1 (``name``) against x
    (n_cols, ...) and ``inv`` (int32 (n_out,), or None for one bucket);
    returns m's dtype and the arguments the C functions take for them,
    up to x's entries.  One pass over the buckets: it runs before every
    launch, on the host, ahead of the kernel."""
    dev = x.device
    dtype = buckets[0].m.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m must be float32 or bfloat16, got {dtype}")
    nb = len(buckets)
    if not 0 < nb <= MAX_BUCKETS:
        raise ValueError(f"{name} takes 1 to {MAX_BUCKETS} buckets, got {nb}")
    ms, wss, caps, firsts = [], [], [], []
    first = 0
    for b in buckets:
        _check_aligned_op(b)
        m, ws = b.m, b.win_start
        if m.dim() != 3:
            raise ValueError(f"{name} takes 8-row blocks: m={tuple(m.shape)}")
        nblk, blk, nww = m.shape
        if m.dtype != dtype:
            raise ValueError("the buckets' m must share one dtype")
        if ws.dtype != torch.int32 or ws.shape != (nblk, nww // 128):
            raise ValueError("win_start must be int32 (NBLK, NW)")
        if nww % 128 or blk != 8 or x.shape[0] != b.n_cols:
            raise ValueError(f"{name} takes 8-row blocks: m={tuple(m.shape)} "
                             f"x={tuple(x.shape)} n_cols={b.n_cols}")
        if not (m.is_contiguous() and ws.is_contiguous()):
            raise ValueError("m and win_start must be contiguous")
        ptr = m.data_ptr()
        if ptr % 16 or m.device != dev or ws.device != dev:
            raise ValueError("m must be 16-byte aligned, on x's device")
        ms.append(ptr)
        wss.append(ws.data_ptr())
        caps.append(nww // 128)
        firsts.append(first)
        first += nblk
    if inv is not None and not (inv.dtype == torch.int32 and inv.dim() == 1
                                and inv.shape[0] == n_out
                                and inv.is_contiguous() and inv.device == dev):
        raise ValueError("inv_block_perm must be int32 (n_out,), "
                         "contiguous, on x's device")
    return dtype, ((ctypes.c_void_p * nb)(*ms), (ctypes.c_void_p * nb)(*wss),
                   (ctypes.c_int * nb)(*caps), (ctypes.c_int * nb)(*firsts),
                   nb, None if inv is None else inv.data_ptr(), n_out)


def _row_order(op, xp: torch.Tensor, windows) -> torch.Tensor:
    """(n_out, 8, ...) window products of an 8-row slab form in row
    order: each output block takes its block's products from its bucket
    (``windows(bucket, xp)``), as one launch of K1 or B1 does; padding
    blocks are not computed."""
    inv = op.inv_block_perm.long()
    y, first = None, 0
    for b in op.buckets:
        _check_aligned_op(b)
        nblk = b.m.shape[0]
        out = torch.nonzero((inv >= first) & (inv < first + nblk))[:, 0]
        blocks = inv[out] - first
        yb = windows(b._replace(m=b.m[blocks], win_start=b.win_start[blocks]),
                     xp)
        if y is None:
            y = yb.new_empty((inv.shape[0],) + tuple(yb.shape[1:]))
        y[out] = yb
        first += nblk
    return y


def _windows_plain(op: BlockDenseOperator,
                   xp: torch.Tensor) -> torch.Tensor:
    """(NBLK, BLK) window products as the kernel defines them."""
    nblk, blk, nww = op.m.shape
    acc = torch.promote_types(op.m.dtype, torch.float32)
    segs = op.win_start.long() // 128                       # (NBLK, NW)
    wins = xp.view(-1, 128)[segs].reshape(nblk, 1, nww).to(acc)
    return torch.sum(op.m.to(acc) * wins, dim=2)


def _matvec_launch(buckets: Sequence[BlockDenseOperator],
                   inv: Optional[torch.Tensor], n_out: int,
                   x: torch.Tensor, xs: torch.Tensor,
                   diag: Optional[torch.Tensor]) -> torch.Tensor:
    """(n_out*8,) f32 from one launch of K1 over ``buckets``: output
    block o from block ``inv[o]`` of the buckets laid end to end, or from
    block o of the one bucket where ``inv`` is None; rows below len(diag)
    plus diag * x.  The kernel reads x's entries from ``xs`` (x itself,
    or x as :func:`pad_x` pads it) and takes entries from n_cols on as
    zero.  Raises on anything it does not take; launches on the current
    stream and counts the launch in ``blockdense_matvec_cuda.launches``."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("K1 needs CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError(f"x must be 1-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    dtype, args = _launch_buckets(buckets, inv, n_out, x, "K1")
    if not (xs.dtype == torch.float32 and xs.ndim == 1
            and xs.shape[0] >= x.shape[0] and xs.is_contiguous()
            and xs.data_ptr() % 16 == 0 and xs.device == dev):
        raise ValueError("x's entries must be 1-D float32, contiguous, "
                         "16-byte aligned, on x's device")
    n_diag = 0
    if diag is not None:
        n_diag = diag.shape[0]
        if not (diag.dtype == torch.float32 and diag.ndim == 1
                and diag.is_contiguous() and diag.device == dev
                and n_diag <= min(8 * n_out, x.shape[0])):
            raise ValueError("the diagonal must be 1-D float32, contiguous, "
                             "on x's device, no longer than x or y")
    lib = LIBRARY.load()
    fn = (lib.gmg_blockdense_matvec_f32 if dtype == torch.float32
          else lib.gmg_blockdense_matvec_bf16)
    y = torch.empty((n_out * 8,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, xs.data_ptr(), x.shape[0],
                 None if diag is None else diag.data_ptr(), n_diag,
                 y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"blockdense_matvec kernel launch failed: "
                           f"cudaError {err}")
    blockdense_matvec_cuda.launches += 1
    return y


def blockdense_matvec_plain(op: BlockDenseOperator, x: torch.Tensor,
                            xp: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of K1 on one bucket, plus escape chute and
    diagonal.  ``xp`` is x as :func:`pad_x` pads it."""
    _check_aligned_op(op)
    y = _windows_plain(op, xp).reshape(-1)[:op.n_rows].to(x.dtype)
    y = add_escape(op, y, x)
    if op.diag is not None:
        y = y + op.diag * x
    return y


def blockdense_matvec_cuda(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """K1 on the card over one bucket, plus escape chute and diagonal.

    ``xp`` is x as :func:`pad_x` pads it.  Raises on anything the kernel
    does not take; launches on the current stream.
    ``blockdense_matvec_cuda.launches`` counts every launch of K1,
    through this wrapper or through :func:`slab_matvec_cuda`.
    """
    if not x.is_cuda:
        raise ValueError("blockdense_matvec_cuda needs CUDA tensors")
    if not (xp.dtype == torch.float32 and xp.ndim == 1
            and xp.is_contiguous() and xp.device == x.device
            and xp.shape[0] >= padded_length(op, op.n_cols)):
        raise ValueError("xp must be x zero-padded by pad_x (1-D float32, "
                         "contiguous, on x's device)")
    y = _matvec_launch((op,), None, op.m.shape[0], x, xp, None)
    y = add_escape(op, y[:op.n_rows], x)
    if op.diag is not None:
        y = y + op.diag * x
    return y


blockdense_matvec_cuda.launches = 0


def blockdense_matvec_fast(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """K1 over one bucket for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return blockdense_matvec_cuda(op, x, xp)
    return blockdense_matvec_plain(op, x, xp)


def slab_matvec_plain(op, x: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of one launch of K1 over all buckets of an 8-row
    ``SlabOperator`` and x (n_cols,): each output block, in row order,
    takes its block's products from its bucket (padding blocks are not
    computed), then the diagonal, then the escape chutes.  (n_rows,)."""
    _check_slab(op)
    y = _row_order(op, pad_x(op.buckets[0], x), _windows_plain)
    y = y.reshape(-1).to(x.dtype)
    if op.diag is not None:
        y[:op.n_rows] += op.diag * x
    return slab_escape(op, y, x)[:op.n_rows]


def slab_matvec_cuda(op, x: torch.Tensor) -> torch.Tensor:
    """One launch of K1 over all buckets of an 8-row ``SlabOperator`` and
    x (n_cols,) float32, writing y in row order with the diagonal fused;
    plus the escape chutes: (n_rows,).  The kernel reads x unpadded (a
    copy only where x is not contiguous and 16-byte aligned).  Raises on
    anything the kernel does not take."""
    _check_slab(op)
    xs = x.contiguous()
    if xs.data_ptr() % 16:
        xs = xs.clone()
    if op.diag is not None and not (op.diag.shape[0] == op.n_rows
                                    == x.shape[0]):
        raise ValueError("a slab form's diagonal needs a square form "
                         f"({op.n_rows} rows, x {tuple(x.shape)})")
    inv = op.inv_block_perm
    y = _matvec_launch(op.buckets, inv, inv.shape[0], x, xs, op.diag)
    return slab_escape(op, y, x)[:op.n_rows]


def slab_matvec_1d_fast(op, x: torch.Tensor) -> torch.Tensor:
    """K1 in one launch for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return slab_matvec_cuda(op, x)
    return slab_matvec_plain(op, x)


def _windows_matmat_plain(op: BlockDenseOperator,
                          xp: torch.Tensor) -> torch.Tensor:
    """(NBLK, BLK, D) window products as B1 defines them: the windows of
    Xp gathered (NBLK, NWW, D) and multiplied by m in f32, a few thousand
    blocks at a time (TF32 must be off, as it is by default)."""
    nblk, blk, nww = op.m.shape
    d = xp.shape[1]
    acc = torch.promote_types(op.m.dtype, torch.float32)
    segs = op.win_start.long() // 128                       # (NBLK, NW)
    x3 = xp.view(-1, 128, d)
    step = max(1, _TWIN_CHUNK // (nww * d))
    parts = [torch.matmul(op.m[i:i + step].to(acc),
                          x3[segs[i:i + step]].reshape(-1, nww, d).to(acc))
             for i in range(0, nblk, step)]
    return torch.cat(parts)


def _finish_matmat(op: BlockDenseOperator, y: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    y = add_escape(op, y[:op.n_rows].to(x.dtype), x)
    if op.diag is not None:
        y = y + op.diag[:, None] * x
    return y


def blockdense_matmat_plain(op: BlockDenseOperator, x: torch.Tensor,
                            xp: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of B1 on one bucket, plus escape chute and
    diagonal.  ``x`` is (n_cols, D), ``xp`` x as :func:`pad_x` pads it."""
    _check_aligned_op(op)
    y = _windows_matmat_plain(op, xp).reshape(-1, xp.shape[1])
    return _finish_matmat(op, y, x)


def _matmat_launch(buckets: Sequence[BlockDenseOperator],
                   inv: Optional[torch.Tensor], n_out: int,
                   x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(n_out*8, D) f32 from one launch of B1 over ``buckets``: output
    block o from block ``inv[o]`` of the buckets laid end to end, or from
    block o of the one bucket where ``inv`` is None.  The kernel reads
    x's rows from ``xs`` (x itself, or x as :func:`pad_x` pads it) and
    takes rows from n_cols on as zero.  Raises on anything it does not
    take; launches on the current stream and counts the launch in
    ``blockdense_matmat_cuda.launches``."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("B1 needs CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be 2-D float32 (n_cols, D), got "
                         f"{x.dtype} {tuple(x.shape)}")
    d = x.shape[1]
    dtype, args = _launch_buckets(buckets, inv, n_out, x, "B1")
    if not (xs.dtype == torch.float32 and xs.ndim == 2
            and xs.shape[1] == d and xs.shape[0] >= x.shape[0]
            and xs.is_contiguous() and xs.data_ptr() % 16 == 0
            and xs.device == dev):
        raise ValueError("x's rows must be (rows, D) float32, contiguous, "
                         "16-byte aligned, on x's device")
    lib = MATMAT_LIBRARY.load()
    fn = (lib.gmg_blockdense_matmat_f32 if dtype == torch.float32
          else lib.gmg_blockdense_matmat_bf16)
    y = torch.empty((n_out * 8, d), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, xs.data_ptr(), x.shape[0], y.data_ptr(), d, stream)
    if err != 0:
        raise RuntimeError(f"blockdense_matmat kernel launch failed: "
                           f"cudaError {err}")
    blockdense_matmat_cuda.launches += 1
    return y


def blockdense_matmat_cuda(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """B1 on the card over one bucket, plus escape chute and diagonal:
    (n_rows, D).

    ``x`` is (n_cols, D) float32, ``xp`` x as :func:`pad_x` pads it
    ((padded rows, D), contiguous).  Raises on anything the kernel does
    not take; ``blockdense_matmat_cuda.launches`` counts every launch of
    B1, through this wrapper or through :func:`slab_matmat_cuda`.
    """
    if x.ndim == 2 and not (
            xp.dtype == torch.float32 and xp.ndim == 2
            and xp.shape[1] == x.shape[1] and xp.is_contiguous()
            and xp.data_ptr() % 16 == 0 and xp.device == x.device
            and xp.shape[0] >= padded_length(op, op.n_cols)):
        raise ValueError("xp must be x zero-padded by pad_x ((rows, D) "
                         "float32, contiguous, 16-byte aligned, on x's "
                         "device)")
    y = _matmat_launch((op,), None, op.m.shape[0], x, xp)
    return _finish_matmat(op, y, x)


blockdense_matmat_cuda.launches = 0


def slab_matmat_plain(op, x: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of one launch of B1 over all buckets of an 8-row
    ``SlabOperator``: each output block, in row order, takes its block's
    products from its bucket (padding blocks are not computed); plus the
    escape chutes.  (n_rows, D) without the diagonal."""
    _check_slab(op)
    y = _row_order(op, pad_x(op.buckets[0], x), _windows_matmat_plain)
    y = slab_escape(op, y.reshape(-1, x.shape[1]).to(x.dtype), x)
    return y[:op.n_rows]


def slab_matmat_cuda(op, x: torch.Tensor) -> torch.Tensor:
    """One launch of B1 over all buckets of an 8-row ``SlabOperator``,
    writing Y in row order, plus the escape chutes: (n_rows, D) without
    the diagonal.  The kernel reads x unpadded (a copy only where x is
    not contiguous and 16-byte aligned).  Raises on anything the kernel
    does not take.

    The kernel multiplies only the window positions where one of a
    block's 8 rows of m is nonzero.  For finite x that is the twin's sum
    exactly; an Inf or a NaN of x at a skipped position, which the twin
    turns into NaN, leaves the kernel's rows finite."""
    _check_slab(op)
    xs = x.contiguous()
    if xs.data_ptr() % 16:
        xs = xs.clone()
    inv = op.inv_block_perm
    y = _matmat_launch(op.buckets, inv, inv.shape[0], x, xs)
    return slab_escape(op, y, x)[:op.n_rows]


def slab_matmat_fast(op, x: torch.Tensor) -> torch.Tensor:
    """B1 in one launch for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return slab_matmat_cuda(op, x)
    return slab_matmat_plain(op, x)
