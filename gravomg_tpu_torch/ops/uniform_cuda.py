"""The uniform block-dense matvec in one launch (``csrc/uniform_matvec.cu``):
a uniform block-window form (``ops/blockdense.py``; the forms
``attach_fast_operators`` gives the levels the slab forms leave) applied
to one right-hand side, and the dispatch between the kernel and the
plain path.

The kernel replaces no TPU kernel: the JAX package runs these forms
through XLA, and :func:`~gravomg_tpu_torch.ops.blockdense.blockdense_matvec`,
its plain torch port, launches some 20 to 40 operations a matvec, which
on a coarse level of a few thousand rows cost far more host time than
device time.  ``blockdense_matvec`` is the kernel's plain twin: for one
form and x (n_cols,) float32 one launch computes what it computes, the
windows of x (zero past n_cols) rounded to m's dtype, the window
products summed in f32, the escape chute with x unrounded, the
diagonal; rows below n_rows only.

:func:`uniform_matvec` sends one form and a 1-D float32 CUDA x to the
kernel; stacks of forms (``parallel/batch.py``), a 2-D x, other dtypes
of x and CPU tensors keep ``blockdense_matvec``.  A CUDA tensor that
reaches the kernel launches it or raises.  A form is checked at its
first launch, and again only when one of its fields is another object;
every call checks x.  The shared library is built with ``nvcc`` at
first use into ``gravomg_tpu_torch/_build/`` and bound with ctypes
(plain C interface, no PyTorch headers).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.weak import WeakIdKeyDictionary

from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              blockdense_matvec,
                                              padded_length)
from gravomg_tpu_torch.utils.build import CudaLibrary

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# m, win_start, nblk, block, nww, nw, window0, window, xlen, x, n_x,
# n_cols, esc_rows, esc_cols, esc_w, n_esc, diag, y, n_rows, stream.
_ARGS = [_P, _P, _L, _I, _I, _I, _I, _I, _L, _P, _L, _L, _P, _P, _P, _L,
         _P, _P, _L, _P]
LIBRARY = CudaLibrary("uniform_matvec.cu",
                      {"gmg_uniform_matvec_f32": _ARGS,
                       "gmg_uniform_matvec_bf16": _ARGS})
MAX_COLS = 56 * 1024        # m's columns the kernel stages (kMaxCols)
_F32, _BF16, _I32 = torch.float32, torch.bfloat16, torch.int32
# The forms checked so far: m -> (the form's other fields, its plan).
_CHECKED = WeakIdKeyDictionary()


def _check_form(op: BlockDenseOperator) -> tuple:
    """Raise if the kernel does not take the form ``op``; else its plan:
    (device, kernel, the shape arguments of a launch, escape slots)."""
    m, ws = op.m, op.win_start
    dev = m.device
    if not m.is_cuda:
        raise ValueError("uniform_matvec_cuda needs CUDA tensors")
    if m.dtype not in (_F32, _BF16):
        raise ValueError(f"m must be float32 or bfloat16, got {m.dtype}")
    if m.ndim != 3 or ws.shape != (m.shape[0], op.nw) or ws.dtype != _I32:
        raise ValueError("the uniform kernel takes one form: m (NBLK, BLK, "
                         "NWW), win_start int32 (NBLK, NW)")
    nblk, block, nww = m.shape
    if (block != op.block or not 0 < nww <= MAX_COLS
            or nww != op.window0 + (op.nw - 1) * op.window
            or op.n_rows > nblk * block):
        raise ValueError(f"m {tuple(m.shape)} does not fit the form's "
                         f"block, windows and rows")
    if not (m.is_contiguous() and ws.is_contiguous() and ws.device == dev):
        raise ValueError("m and win_start must be contiguous, on one device")
    esc = (op.esc_rows, op.esc_cols)
    if not (all(t.dtype == _I32 and t.ndim == 1 and t.is_contiguous()
                and t.device == dev for t in esc)
            and op.esc_w.dtype == _F32 and op.esc_w.is_contiguous()
            and op.esc_w.device == dev
            and op.esc_w.shape == op.esc_rows.shape == op.esc_cols.shape):
        raise ValueError("the escape chute must be int32 rows and columns "
                         "and float32 weights, 1-D, contiguous, on m's "
                         "device")
    d = op.diag
    if d is not None and not (d.dtype == _F32 and d.shape == (op.n_rows,)
                              and op.n_rows <= op.n_cols
                              and d.is_contiguous() and d.device == dev):
        raise ValueError("the diagonal must be float32 (n_rows,), "
                         "contiguous, on m's device, of a square form")
    lib = LIBRARY.load()
    fn = (lib.gmg_uniform_matvec_f32 if m.dtype == _F32
          else lib.gmg_uniform_matvec_bf16)
    shape = (nblk, block, nww, op.nw, op.window0, op.window,
             padded_length(op, op.n_cols))
    return dev, fn, shape, op.esc_w.shape[0]


def _plan(op: BlockDenseOperator) -> tuple:
    """The plan of a form checked before, else the form checked now."""
    others = (op.diag,) + tuple(op[2:])
    seen = _CHECKED.get(op.m)
    if seen is None or not all(a is b for a, b in zip(seen[0], others)):
        seen = _CHECKED[op.m] = (others, _check_form(op))
    return seen[1]


def uniform_matvec_cuda(op: BlockDenseOperator,
                        x: torch.Tensor) -> torch.Tensor:
    """One launch of the uniform kernel: the form ``op`` on x (n_cols,)
    float32 on the card, (n_rows,) float32.  Raises on anything the
    kernel does not take; launches on the current stream, reads nothing
    back and does not synchronise.  ``uniform_matvec_cuda.launches``
    counts every launch."""
    if not x.is_cuda:
        raise ValueError("uniform_matvec_cuda needs CUDA tensors")
    dev, fn, shape, n_esc = _plan(op)
    if (x.dtype != _F32 or x.ndim != 1 or x.shape[0] != op.n_cols
            or not x.is_contiguous() or x.device != dev):
        raise ValueError(f"x must be 1-D float32 of n_cols={op.n_cols} "
                         f"entries, contiguous, on m's device, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    y = torch.empty((op.n_rows,), dtype=_F32, device=dev)
    d = op.diag
    args = (op.m.data_ptr(), op.win_start.data_ptr(), *shape, x.data_ptr(),
            op.n_cols, op.n_cols, op.esc_rows.data_ptr(),
            op.esc_cols.data_ptr(), op.esc_w.data_ptr(), n_esc,
            None if d is None else d.data_ptr(), y.data_ptr(), op.n_rows)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"uniform_matvec kernel launch failed: "
                           f"cudaError {err}")
    uniform_matvec_cuda.launches += 1
    return y


uniform_matvec_cuda.launches = 0


def uniform_matvec(op: BlockDenseOperator, x: torch.Tensor) -> torch.Tensor:
    """A uniform form on x: one launch of the kernel for one form and a
    1-D float32 CUDA x, else ``blockdense_matvec`` (a stack of forms, a
    2-D x, an x of another dtype, CPU tensors)."""
    if x.is_cuda and x.ndim == 1 and x.dtype == _F32 and not op.stacked:
        return uniform_matvec_cuda(op, x)
    return blockdense_matvec(op, x)
