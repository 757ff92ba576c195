"""The block-window SpMV kernel (``csrc/blockdense_matvec.cu``): its
wrapper, its plain torch twin and the dispatch between them.

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

The shared library is built with ``nvcc`` at first use from the sources
in the package into ``gravomg_tpu_torch/_build/`` and bound with ctypes
(plain C interface, no PyTorch headers).
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
