"""The uniform kernel (``csrc/uniform_matvec.cu``) on one form on the
card, beside the plain path it replaces there (``blockdense_matvec``):
its error against the plain path, the bytes one matvec must move and
their bound, and its times alone, per call and on the host.
``chip_smoke.py`` (phase 20) runs it on the 1M hierarchy's uniform
forms; ``tests/test_torch_uniform_card.py`` holds the kernel to the
plain path with :func:`check`.
"""

from __future__ import annotations

import time

import torch

from gravomg_tpu_torch.ops.blockdense import (blockdense_matvec, pad_x,
                                              window_index)
from gravomg_tpu_torch.ops.uniform_cuda import uniform_matvec_cuda
from gravomg_tpu_torch.probes.timing import (bound, cuda_ms, kernel_events,
                                             kernel_ms)

KERNEL = "uniform_matvec_kernel"
# Each row of the kernel's y within TOL of the row's sum of absolute
# terms (the same function of |m|, |x| and the chute's and diagonal's
# magnitudes).  The kernel sums the window products in another order
# than the plain path, and with fused multiply-adds; the x it multiplies
# is rounded to m's dtype in both.  A sum of n terms in f32 in any order
# stays within n * 2^-24 of that sum (8.4e-5 at the 1,408 columns of the
# 1M level-4 A form); sums in two orders of random signs lie far inside
# 1e-5.
TOL = 1e-5


def check(op, x, y) -> dict:
    """The kernel's y for the form ``op`` on x against the plain path, row
    by row: the largest absolute difference and whether every row lies
    within ``TOL`` of its sum of absolute terms."""
    want = blockdense_matvec(op, x)
    mag = blockdense_matvec(op._replace(
        m=op.m.abs(), esc_w=op.esc_w.abs(),
        diag=None if op.diag is None else op.diag.abs()), x.abs())
    err = (y - want).abs()
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "within_tol": (y.shape == want.shape and y.dtype == want.dtype
                           and bool((err <= TOL * mag).all()))}


def matvec_bytes(op) -> int:
    """What one matvec must move: m and the window starts, x (n_cols
    entries), the escape chute, the diagonal and y, each once."""
    parts = [op.m, op.win_start, op.esc_rows, op.esc_cols, op.esc_w]
    if op.diag is not None:
        parts.append(op.diag)
    return (sum(t.numel() * t.element_size() for t in parts)
            + 4 * (op.n_cols + op.n_rows))


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def measure_form(op, x) -> dict:
    """The form ``op`` on x (n_cols,) float32, both on the card: the bytes
    and multiply-adds of a matvec and their bound; the kernel alone
    (torch.profiler, median of 5 calls, with L2 warm as the cycle's
    back-to-back matvecs find m, and with L2 flushed), a call (CUDA
    events, median of 10), the host microseconds a call takes to enqueue
    (200 calls, no synchronisation) and its launches; the same for the
    plain path; and, for f32 m, one ``torch.bmm`` of m with the windows
    of x already gathered as the library's time for the products."""
    kern = lambda: uniform_matvec_cuda(op, x)
    plain = lambda: blockdense_matvec(op, x)
    nbytes = matvec_bytes(op)
    madds = op.m.numel() + op.esc_w.shape[0] + (
        0 if op.diag is None else op.n_rows)
    bound_ms, bound_by = bound(nbytes, 2 * madds)
    library_ms = None
    if op.m.dtype == torch.float32:
        wins = pad_x(op, x)[window_index(op, x.shape[0])][:, :, None]
        library_ms = cuda_ms(lambda: torch.bmm(op.m, wins))
    row = {"dtype": str(op.m.dtype).replace("torch.", ""),
           "m_shape": list(op.m.shape), "nw": op.nw,
           "n_esc": op.esc_w.shape[0], "io_bytes": nbytes,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "alone_ms": kernel_ms(kern, KERNEL),
           "alone_cold_ms": kernel_ms(kern, KERNEL, cold=True),
           "launches_a_call": len(kernel_events(kern)),
           "per_call_ms": cuda_ms(kern), "host_us": host_us(kern),
           "plain_ms": cuda_ms(plain), "plain_host_us": host_us(plain),
           "plain_launches_a_call": len(kernel_events(plain)),
           "library_ms": library_ms}
    row["share_of_bound"] = bound_ms / row["per_call_ms"]
    # Alone and with L2 warm, a form this small is read from L2: the
    # share of the bound set by device memory is the L2-flushed time's.
    cold = row["alone_cold_ms"]
    row["alone_share_of_bound"] = None if cold is None else bound_ms / cold
    return row
