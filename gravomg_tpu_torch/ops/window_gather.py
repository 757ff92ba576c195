"""The windowed ELL SpMV of the gather probes (``csrc/window_gather.cu``):
its wrapper, its plain torch twin and the dispatch between them.

The kernel replaces the TPU probe kernels P1 (``make_variant`` in
``scripts/profile_pltake.py``) and P2 (``pl_take`` in
``scripts/profile_gather2.py``).  For row block b of ``rows`` rows, 32
entries a row and a window of ``window`` values of x from
``starts[b]``,

    y[b, i] = sum_k w[b, i, k] * x[starts[b] + lidx[b, i, k]]

in f32, returned as (NB, rows).  Starts are clamped to
[0, len(x) - window], as ``lax.dynamic_slice`` clamps a window that runs
off the end (P2's last starts do), and local indices to [0, window - 1],
so that the kernel never reads out of bounds (the probes draw them in
range).  The kernel splits each row block over 4 thread blocks, each of
which copies the window into shared memory asynchronously while its
first 16-byte loads of ``lidx`` and ``w`` are under way.

:func:`window_gather_fast` dispatches on the device of x: a CUDA tensor
goes to :func:`window_gather_cuda`, which launches the kernel or raises;
a CPU tensor goes to :func:`window_gather_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from gravomg_tpu_torch.utils.build import CudaLibrary

ENTRIES = 32                   # entries a row: one warp lane each
MAX_WINDOW = 12288             # floats of x a thread block keeps (48 KB)
LIBRARY = CudaLibrary("window_gather.cu", {"gmg_window_gather": [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p]})


def window_gather_plain(x: torch.Tensor, starts: torch.Tensor,
                        lidx: torch.Tensor, w: torch.Tensor,
                        window: int) -> torch.Tensor:
    """Plain torch twin of the kernel: the probes' kernel body (sum over
    k in order, as ``body_take`` of ``profile_pltake.py`` adds)."""
    s = torch.clamp(starts.long(), 0, x.shape[0] - window)
    vals = x[s[:, None, None] + torch.clamp(lidx.long(), 0, window - 1)]
    acc = torch.zeros(lidx.shape[:2], dtype=torch.float32, device=x.device)
    for k in range(lidx.shape[2]):
        acc = acc + w[:, :, k] * vals[:, :, k]
    return acc


def window_gather_cuda(x: torch.Tensor, starts: torch.Tensor,
                       lidx: torch.Tensor, w: torch.Tensor,
                       window: int) -> torch.Tensor:
    """The kernel on the card.  Raises on anything it does not take;
    launches on the current stream and counts each launch in
    ``window_gather_cuda.launches``."""
    if not all(t.is_cuda and t.device == x.device
               for t in (x, starts, lidx, w)):
        raise ValueError("window_gather_cuda needs CUDA tensors on one "
                         "device")
    if x.dtype != torch.float32 or x.ndim != 1 or w.dtype != torch.float32:
        raise ValueError("x must be 1-D float32 and w float32")
    if starts.dtype != torch.int32 or lidx.dtype != torch.int32:
        raise ValueError("starts and lidx must be int32")
    nb, rows = lidx.shape[:2] if lidx.ndim == 3 else (0, 0)
    if (nb == 0 or rows == 0 or rows % 32 or lidx.shape[2] != ENTRIES
            or tuple(w.shape) != tuple(lidx.shape)
            or tuple(starts.shape) != (nb,)):
        raise ValueError(f"lidx and w must be (NB, rows, {ENTRIES}) with rows "
                         f"a multiple of 32, starts (NB,); got lidx "
                         f"{tuple(lidx.shape)}, w {tuple(w.shape)}, starts "
                         f"{tuple(starts.shape)}")
    if not 0 < window <= min(MAX_WINDOW, x.shape[0]):
        raise ValueError(f"window must lie in 1..min({MAX_WINDOW}, len(x)), "
                         f"got {window}")
    if not all(t.is_contiguous() for t in (x, starts, lidx, w)):
        raise ValueError("x, starts, lidx and w must be contiguous")
    if lidx.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("lidx and w must be 16-byte aligned")
    fn = LIBRARY.load().gmg_window_gather
    y = torch.empty((nb, rows), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.shape[0], starts.data_ptr(),
                 lidx.data_ptr(), w.data_ptr(), y.data_ptr(), nb, rows,
                 window, stream)
    if err != 0:
        raise RuntimeError(f"window_gather kernel launch failed: cudaError "
                           f"{err}")
    window_gather_cuda.launches += 1
    return y


window_gather_cuda.launches = 0


def window_gather_fast(x: torch.Tensor, starts: torch.Tensor,
                       lidx: torch.Tensor, w: torch.Tensor,
                       window: int) -> torch.Tensor:
    """The kernel for a CUDA x, its plain twin for a CPU x."""
    if x.is_cuda:
        return window_gather_cuda(x, starts, lidx, w, window)
    return window_gather_plain(x, starts, lidx, w, window)
