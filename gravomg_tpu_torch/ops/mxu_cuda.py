"""The transposed-tile SpMV kernel (``csrc/mxu_matvec.cu``): its wrapper,
its plain torch twin and the dispatch between them.

The kernel replaces the TPU kernel ``_mxu_kernel`` of
``gravomg_tpu/ops/pallas_blockdense.py`` (launched by
``mxu_matvec_pallas``).  For one bucket of a transposed-tile slab form
(``slab_from_ell(..., mxu=True)``), with ``m`` of shape
(NBLK, NSEG, 128, 128) and window starts ``win_start`` (NBLK, NSEG),

    y[b*128 + r] = sum_s sum_l rnd(xpad[win_start[b, s] + l]) * m[b, s, l, r]

where rnd rounds x to m's dtype, as the Pallas kernel and the JAX
package's XLA path (``_mxu_bucket_matvec_xla``) both do, and the sum is
taken in f32.  The bucket's escape chute is added to the padded
NBLK*128-row output here in torch, as ``slab_matvec``'s caller does in
the JAX package.

:func:`mxu_matvec_fast` dispatches on the device of x: a CUDA tensor goes
to :func:`mxu_matvec_cuda`, which launches the kernel or raises; a CPU
tensor goes to :func:`mxu_matvec_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              add_escape, padded_length)
from gravomg_tpu_torch.utils.build import CudaLibrary

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
LIBRARY = CudaLibrary("mxu_matvec.cu", {"gmg_mxu_matvec_f32": _ARGS,
                                        "gmg_mxu_matvec_bf16": _ARGS})
MAX_SEGMENTS = 64           # x segments the kernel stages in shared memory


def _check_tile_op(op: BlockDenseOperator) -> None:
    if (op.m.ndim != 4 or tuple(op.m.shape[2:]) != (128, 128)
            or op.block != 128 or op.align != 128 or op.window != 128
            or op.window0 != 128 or op.diag is not None):
        raise ValueError("the transposed-tile kernel takes a bucket of "
                         "slab_from_ell(..., mxu=True): m (NBLK, NSEG, 128, "
                         "128), 128-aligned windows, no diagonal")


def mxu_matvec_plain(op: BlockDenseOperator, x: torch.Tensor,
                     xp: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the kernel, plus the escape chute.  ``xp`` is
    x as :func:`pad_x` pads it.  On the card it needs full-f32 matrix
    products (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's
    default)."""
    _check_tile_op(op)
    if xp.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("mxu_matvec_plain needs full-f32 matrix products: "
                         "set torch.backends.cuda.matmul.allow_tf32 = False")
    nblk, nseg = op.win_start.shape
    acc = torch.promote_types(op.m.dtype, torch.float32)
    segs = op.win_start.long() // 128
    wins = xp.view(-1, 128)[segs].to(op.m.dtype).to(acc)
    y = torch.bmm(wins.reshape(nblk, 1, nseg * 128),
                  op.m.reshape(nblk, nseg * 128, 128).to(acc))
    return add_escape(op, y.reshape(-1).to(x.dtype), x)


def mxu_matvec_cuda(op: BlockDenseOperator, x: torch.Tensor,
                    xp: torch.Tensor) -> torch.Tensor:
    """The kernel on the card, plus the escape chute.

    ``xp`` is x as :func:`pad_x` pads it (n_cols + 128 rounded up to a
    multiple of 128, as ``mxu_matvec_pallas`` pads); the buckets of one
    slab operator share one padded copy.  Raises on anything the kernel
    does not take; launches on the current stream and counts each launch
    in ``mxu_matvec_cuda.launches``.
    """
    _check_tile_op(op)
    m, ws = op.m, op.win_start
    nblk, nseg = m.shape[:2]
    if not (x.is_cuda and m.is_cuda and ws.is_cuda):
        raise ValueError("mxu_matvec_cuda needs CUDA tensors")
    if x.dtype != torch.float32 or x.ndim != 1 or x.shape[0] != op.n_cols:
        raise ValueError(f"x must be 1-D float32 of length n_cols="
                         f"{op.n_cols}, got {x.dtype} {tuple(x.shape)}")
    if m.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"m must be float32 or bfloat16, got {m.dtype}")
    if ws.dtype != torch.int32 or tuple(ws.shape) != (nblk, nseg):
        raise ValueError("win_start must be int32 (NBLK, NSEG)")
    if not 0 < nseg <= MAX_SEGMENTS:
        raise ValueError(f"the kernel takes 1 to {MAX_SEGMENTS} segments a "
                         f"block, got {nseg}")
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
    fn = (lib.gmg_mxu_matvec_f32 if m.dtype == torch.float32
          else lib.gmg_mxu_matvec_bf16)
    y = torch.empty((nblk * 128,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(m.data_ptr(), ws.data_ptr(), xp.data_ptr(), y.data_ptr(),
                 nblk, nseg, stream)
    if err != 0:
        raise RuntimeError(f"mxu_matvec kernel launch failed: cudaError "
                           f"{err}")
    mxu_matvec_cuda.launches += 1
    return add_escape(op, y, x)


mxu_matvec_cuda.launches = 0


def mxu_matvec_fast(op: BlockDenseOperator, x: torch.Tensor,
                    xp: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return mxu_matvec_cuda(op, x, xp)
    return mxu_matvec_plain(op, x, xp)
