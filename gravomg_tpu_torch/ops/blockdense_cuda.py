"""The block-window SpMV kernels: K1 (``csrc/blockdense_matvec.cu``) for
one right-hand side and B1 (``csrc/blockdense_matmat.cu``) for D of them
at once; each with its wrapper, its plain torch twin and the dispatch
between them.

The kernel replaces the TPU kernel ``_matvec_kernel`` of
``gravomg_tpu/ops/pallas_blockdense.py``.  It computes, for an aligned
BlockDenseOperator (window starts multiples of 128, windows 128 wide),

    y[b*BLK + r] = sum_l m[b, r, l] * xpad[window column of l]

in f32, with m in f32 or bf16 (upcast exactly) and x in f32, never
rounded to m's dtype.  The escape chute and the diagonal are added here
in torch, as the TPU kernel's caller does.

:func:`blockdense_matvec_fast` dispatches on the device of x: a CUDA
tensor goes to :func:`blockdense_matvec_cuda`, which launches the kernel
or raises; a CPU tensor goes to :func:`blockdense_matvec_plain`.

B1 replaces the same TPU kernel as the JAX package runs it under
``jax.vmap`` over the columns of X (the c5 recipe of
``scripts/bench_configs.py``): for an 8-row aligned operator and X
(n_cols, D) zero-padded by :func:`pad_x`,

    Y[b*8 + r, j] = sum_l m[b, r, l] * Xp[window column of l, j]

in f32 with X never rounded, m read once for every 64 columns.
:func:`blockdense_matmat_fast` dispatches as the 1-D one does.

The shared libraries are built with ``nvcc`` at first use from the
sources in the package into ``gravomg_tpu_torch/_build/`` and bound with
ctypes (plain C interface, no PyTorch headers).
"""

from __future__ import annotations

import ctypes

import torch

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              add_escape, padded_length)
from gravomg_tpu_torch.utils.build import CudaLibrary

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
LIBRARY = CudaLibrary("blockdense_matvec.cu",
                      {"gmg_blockdense_matvec_f32": _ARGS,
                       "gmg_blockdense_matvec_bf16": _ARGS})
_MM_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
MATMAT_LIBRARY = CudaLibrary("blockdense_matmat.cu",
                             {"gmg_blockdense_matmat_f32": _MM_ARGS,
                              "gmg_blockdense_matmat_bf16": _MM_ARGS})
# Window entries (blocks x NWW x D) the twin gathers at a time.
_TWIN_CHUNK = 1 << 28


def _check_aligned_op(op: BlockDenseOperator) -> None:
    if op.align != 128 or op.window != 128 or op.window0 != 128:
        raise ValueError("the block-window kernel needs 128-wide windows "
                         "with 128-aligned starts (build with align=128, "
                         "window=window0=128)")


def _windows_plain(op: BlockDenseOperator,
                   xp: torch.Tensor) -> torch.Tensor:
    """(NBLK, BLK) window products as the kernel defines them."""
    nblk, blk, nww = op.m.shape
    acc = torch.promote_types(op.m.dtype, torch.float32)
    segs = op.win_start.long() // 128                       # (NBLK, NW)
    wins = xp.view(-1, 128)[segs].reshape(nblk, 1, nww).to(acc)
    return torch.sum(op.m.to(acc) * wins, dim=2)


def blockdense_matvec_plain(op: BlockDenseOperator, x: torch.Tensor,
                            xp: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel, plus escape chute and diagonal.
    ``xp`` is x as :func:`pad_x` pads it."""
    _check_aligned_op(op)
    y = _windows_plain(op, xp).reshape(-1)[:op.n_rows].to(x.dtype)
    y = add_escape(op, y, x)
    if op.diag is not None:
        y = y + op.diag * x
    return y


def blockdense_matvec_cuda(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """The kernel on the card, plus escape chute and diagonal.

    ``xp`` is x as :func:`pad_x` pads it; the buckets of one slab
    operator share one padded copy.  Raises on anything the kernel does
    not take; launches on the current stream and counts each launch in
    ``blockdense_matvec_cuda.launches``.
    """
    _check_aligned_op(op)
    m, ws = op.m, op.win_start
    nblk, blk, nww = m.shape
    if not (x.is_cuda and m.is_cuda and ws.is_cuda):
        raise ValueError("blockdense_matvec_cuda needs CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError(f"x must be 1-D float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m must be float32 or bfloat16, got {m.dtype}")
    if ws.dtype != torch.int32 or tuple(ws.shape) != (nblk, nww // 128):
        raise ValueError("win_start must be int32 (NBLK, NW)")
    if nww % 128 or not 0 < blk <= 32 or x.shape[0] != op.n_cols:
        raise ValueError(f"unsupported shape m={tuple(m.shape)} "
                         f"x={tuple(x.shape)} n_cols={op.n_cols}")
    if not (m.is_contiguous() and ws.is_contiguous()):
        raise ValueError("m and win_start must be contiguous")
    if m.data_ptr() % 16 or m.device != x.device or ws.device != x.device:
        raise ValueError("m must be 16-byte aligned, on x's device")
    if not (xp.dtype == torch.float32 and xp.ndim == 1
            and xp.is_contiguous() and xp.device == x.device
            and xp.shape[0] >= padded_length(op, op.n_cols)):
        raise ValueError("xp must be x zero-padded by pad_x (1-D float32, "
                         "contiguous, on x's device)")
    lib = LIBRARY.load()
    fn = (lib.gmg_blockdense_matvec_f32 if m.dtype == torch.float32
          else lib.gmg_blockdense_matvec_bf16)
    y = torch.empty((nblk * blk,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m.data_ptr(), ws.data_ptr(), xp.data_ptr(), y.data_ptr(),
                 nblk, blk, nww // 128, stream)
    if err != 0:
        raise RuntimeError(f"blockdense_matvec kernel launch failed: "
                           f"cudaError {err}")
    blockdense_matvec_cuda.launches += 1
    y = add_escape(op, y[:op.n_rows], x)
    if op.diag is not None:
        y = y + op.diag * x
    return y


blockdense_matvec_cuda.launches = 0


def blockdense_matvec_fast(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return blockdense_matvec_cuda(op, x, xp)
    return blockdense_matvec_plain(op, x, xp)


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
    """Plain torch twin of B1, plus escape chute and diagonal.  ``x`` is
    (n_cols, D), ``xp`` x as :func:`pad_x` pads it."""
    _check_aligned_op(op)
    y = _windows_matmat_plain(op, xp).reshape(-1, xp.shape[1])
    return _finish_matmat(op, y, x)


def blockdense_matmat_cuda(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """B1 on the card, plus escape chute and diagonal: (n_rows, D).

    ``x`` is (n_cols, D) float32, ``xp`` x as :func:`pad_x` pads it
    ((padded rows, D), contiguous; the buckets of one slab operator share
    it).  Raises on anything the kernel does not take; launches on the
    current stream and counts each launch in
    ``blockdense_matmat_cuda.launches``.
    """
    _check_aligned_op(op)
    m, ws = op.m, op.win_start
    nblk, blk, nww = m.shape
    if not (x.is_cuda and m.is_cuda and ws.is_cuda and xp.is_cuda):
        raise ValueError("blockdense_matmat_cuda needs CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be 2-D float32 (n_cols, D), got "
                         f"{x.dtype} {tuple(x.shape)}")
    d = x.shape[1]
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m must be float32 or bfloat16, got {m.dtype}")
    if ws.dtype != torch.int32 or tuple(ws.shape) != (nblk, nww // 128):
        raise ValueError("win_start must be int32 (NBLK, NW)")
    if nww % 128 or blk != 8 or x.shape[0] != op.n_cols:
        raise ValueError(f"B1 takes 8-row blocks: m={tuple(m.shape)} "
                         f"x={tuple(x.shape)} n_cols={op.n_cols}")
    if not (m.is_contiguous() and ws.is_contiguous()):
        raise ValueError("m and win_start must be contiguous")
    if m.data_ptr() % 16 or m.device != x.device or ws.device != x.device:
        raise ValueError("m must be 16-byte aligned, on x's device")
    if not (xp.dtype == torch.float32 and xp.ndim == 2
            and xp.shape[1] == d and xp.is_contiguous()
            and xp.data_ptr() % 16 == 0 and xp.device == x.device
            and xp.shape[0] >= padded_length(op, op.n_cols)):
        raise ValueError("xp must be x zero-padded by pad_x ((rows, D) "
                         "float32, contiguous, 16-byte aligned, on x's "
                         "device)")
    lib = MATMAT_LIBRARY.load()
    fn = (lib.gmg_blockdense_matmat_f32 if m.dtype == torch.float32
          else lib.gmg_blockdense_matmat_bf16)
    y = torch.empty((nblk * blk, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m.data_ptr(), ws.data_ptr(), xp.data_ptr(), y.data_ptr(),
                 nblk, blk, nww // 128, d, stream)
    if err != 0:
        raise RuntimeError(f"blockdense_matmat kernel launch failed: "
                           f"cudaError {err}")
    blockdense_matmat_cuda.launches += 1
    return _finish_matmat(op, y, x)


blockdense_matmat_cuda.launches = 0


def blockdense_matmat_fast(op: BlockDenseOperator, x: torch.Tensor,
                           xp: torch.Tensor) -> torch.Tensor:
    """B1 for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return blockdense_matmat_cuda(op, x, xp)
    return blockdense_matmat_plain(op, x, xp)
