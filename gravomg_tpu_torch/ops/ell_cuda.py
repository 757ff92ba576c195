"""The ELL product in one launch (``csrc/ell_spmv.cu``, kernel E1): one
operator in padded ELL form (``types.py::EllOperator``) applied to x
(V,) or (V, D) float32 on the card, with no (V, K) or (V, K, D) gather
left in device memory.

The kernel's plain twin is ``solve/spmv.py::spmv_plain``: for one
operator with float32 values and a float32 x one launch computes what it
computes, ``diag * x`` plus the real slots' products summed in f32 (in
another order, with fused multiply-adds); padding slots are skipped
wherever they sit in a row.  ``solve/spmv.py::spmv`` dispatches between
the two.

:func:`ell_spmv_cuda` checks an operator at its first launch, and again
only when its values or diagonal are other tensors than last time, and
checks x every call.  It reads nothing back and does not synchronise, so
a product may be captured in a CUDA graph (``apps/spectral.py``'s
``_Replayed``).  The shared library is built with ``nvcc`` at first use
into ``gravomg_tpu_torch/_build/`` and bound with ctypes (plain C
interface, no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import weakref

import torch
from torch.utils.weak import WeakIdKeyDictionary

from gravomg_tpu_torch.types import EllOperator
from gravomg_tpu_torch.utils.build import CudaLibrary

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# neighbors, offdiag, diag, x, y, n_rows, k, d, stream.
LIBRARY = CudaLibrary("ell_spmv.cu",
                      {"gmg_ell_spmv_f32": [_P, _P, _P, _P, _P, _L, _I, _L,
                                            _P]})
_F32, _I32 = torch.float32, torch.int32
# The operators checked so far: neighbors -> (weak references to the
# offdiag and diag it was checked with, its device).  Weak, so that the
# cache keeps no operator's values alive.
_CHECKED = WeakIdKeyDictionary()


def _check_operator(op: EllOperator) -> torch.device:
    """Raise if the kernel does not take the operator ``op``; else its
    device."""
    nbr, off, diag = op.neighbors, op.offdiag, op.diag
    if nbr.dtype != _I32:
        raise ValueError(f"neighbors must be int32, got {nbr.dtype}")
    if off.dtype != _F32 or diag.dtype != _F32:
        raise ValueError(f"offdiag and diag must be float32, got "
                         f"{off.dtype} and {diag.dtype}")
    if (nbr.ndim != 2 or off.shape != nbr.shape or diag.ndim != 1
            or diag.shape[0] != nbr.shape[0]):
        raise ValueError(f"the kernel takes one operator: neighbors and "
                         f"offdiag (V, K), diag (V,); got "
                         f"{tuple(nbr.shape)}, {tuple(off.shape)}, "
                         f"{tuple(diag.shape)}")
    dev = nbr.device
    if not all(t.is_contiguous() and t.device == dev
               for t in (nbr, off, diag)):
        raise ValueError("neighbors, offdiag and diag must be contiguous, "
                         "on one device")
    return dev


def _device(op: EllOperator) -> torch.device:
    """The device of an operator checked before, else of the operator
    checked now."""
    seen = _CHECKED.get(op.neighbors)
    if (seen is None or seen[0]() is not op.offdiag
            or seen[1]() is not op.diag):
        seen = _CHECKED[op.neighbors] = (weakref.ref(op.offdiag),
                                         weakref.ref(op.diag),
                                         _check_operator(op))
    return seen[2]


def ell_spmv_cuda(op: EllOperator, x: torch.Tensor) -> torch.Tensor:
    """One launch of E1: the operator ``op`` on x (V,) or (V, D) float32
    on the card; y of x's shape.  Raises on anything the kernel does not
    take; launches on the current stream, reads nothing back and does not
    synchronise.  ``ell_spmv_cuda.launches`` counts every launch."""
    dev = _device(op)
    v = op.neighbors.shape[0]
    if (x.dtype != _F32 or x.ndim not in (1, 2) or x.shape[0] != v
            or not x.is_contiguous() or x.device != dev):
        raise ValueError(f"x must be (V,) or (V, D) float32 with V={v} "
                         f"rows, contiguous, on the operator's device; got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"contiguous {x.is_contiguous()}")
    if not x.is_cuda:
        raise ValueError("ell_spmv_cuda needs CUDA tensors")
    fn = LIBRARY.load().gmg_ell_spmv_f32
    y = torch.empty_like(x)
    args = (op.neighbors.data_ptr(), op.offdiag.data_ptr(),
            op.diag.data_ptr(), x.data_ptr(), y.data_ptr(), v,
            op.neighbors.shape[1], 1 if x.ndim == 1 else x.shape[1])
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {err}")
    ell_spmv_cuda.launches += 1
    return y


ell_spmv_cuda.launches = 0
