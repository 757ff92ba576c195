"""The ELL kernel E1 (``csrc/ell_spmv.cu``) on one operator on the card,
beside the plain twin it replaces there (``spmv_plain``): its error
against the twin, the bytes one product must move and their bound, and
its times alone, per call and on the host.  ``chip_smoke.py`` (phase 21)
runs it on the c6 100k Laplacian and the 1M level-0 A;
``tests/test_torch_ell_card.py`` holds the kernel to the twin with
:func:`check`.
"""

from __future__ import annotations

import warnings

import torch

from gravomg_tpu_torch.ops.ell_cuda import ell_spmv_cuda
from gravomg_tpu_torch.probes.timing import (bound, cuda_ms, kernel_events,
                                             kernel_ms)
from gravomg_tpu_torch.probes.uniform import host_us
from gravomg_tpu_torch.solve.spmv import spmv_plain
from gravomg_tpu_torch.types import EllOperator

KERNEL = "ell_spmv"
# Each entry of the kernel's y within TOL of its row's sum of absolute
# terms (the twin on |A| and |x|).  Both sum the same f32 products of at
# most K + 1 terms, in two orders; a sum of n terms in f32 in any order
# stays within n * 2^-24 of that sum (2e-6 at K = 32), and two orders of
# a Laplacian row's mixed signs lie far inside 1e-6.
TOL = 1e-6


def check(op: EllOperator, x, y) -> dict:
    """The kernel's y for ``op`` on x against the twin, entry by entry:
    the largest absolute difference and whether every entry lies within
    ``TOL`` of its row's sum of absolute terms."""
    want = spmv_plain(op, x)
    mag = spmv_plain(op._replace(offdiag=op.offdiag.abs(),
                                 diag=op.diag.abs()), x.abs())
    err = (y - want).abs()
    return {"max_abs_err": float(err.max()) if err.numel() else 0.0,
            "within_tol": (y.shape == want.shape and y.dtype == want.dtype
                           and bool((err <= TOL * mag).all()))}


def shuffled_slots(op: EllOperator, generator) -> EllOperator:
    """``op`` with each row's slots in a random order: the same operator,
    its padding between real slots."""
    keys = torch.rand(op.neighbors.shape, generator=generator,
                      device=op.neighbors.device)
    perm = torch.argsort(keys, dim=1)
    return op._replace(neighbors=torch.gather(op.neighbors, 1, perm),
                       offdiag=torch.gather(op.offdiag, 1, perm))


def ell_bytes(op: EllOperator, d: int) -> int:
    """What one product on x (V, d) must move, by the rule of the
    benchmark's ``lobpcg.spmv_roofline``: each nonzero off the diagonal
    (a real slot whose value is not 0) at 4 bytes with its 4-byte column
    index, the diagonal, x and y once each."""
    v = op.neighbors.shape[0]
    nnz = int(torch.count_nonzero(op.mask & (op.offdiag != 0)))
    return 8 * nnz + 4 * v * (2 * d + 1)


def padding_bytes(op: EllOperator) -> int:
    """The ELL format's own cost beyond :func:`ell_bytes`: the index of
    every other slot (padding, or a zero value), which the kernel reads
    to know to skip it."""
    nnz = int(torch.count_nonzero(op.mask & (op.offdiag != 0)))
    return 4 * (op.neighbors.numel() - nnz)


def _csr(op: EllOperator) -> torch.Tensor:
    """``op`` with its diagonal as a CSR matrix (the library's input)."""
    v = op.num_vertices
    mask = op.mask
    dev = op.diag.device
    rows = torch.arange(v, device=dev)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        coo = torch.sparse_coo_tensor(
            torch.stack([torch.cat([rows[:, None].expand_as(mask)[mask],
                                    rows]),
                         torch.cat([op.neighbors[mask].long(), rows])]),
            torch.cat([op.offdiag[mask], op.diag]), (v, v)).coalesce()
        return coo.to_sparse_csr()


def measure(op: EllOperator, x) -> dict:
    """``op`` on x (V,) or (V, D) float32, both on the card: the bytes of a
    product and their bound (and the padding's index bytes, which the
    bound leaves out); the kernel alone (torch.profiler, median of
    5 calls, with L2 warm as back-to-back products find the table and x,
    and with L2 flushed), a call (CUDA events, median of 10, L2 flushed
    before each, and warm), the host microseconds a call takes to
    enqueue (200 calls, no synchronisation) and its launches; the same
    for the plain twin; and ``torch.sparse.mm`` on the operator in CSR
    as the library's time.  The shares of the bound are the flushed
    times': at 100k the table, x and y fit in the 50 MB L2, and a warm
    product reads them from there."""
    d = 1 if x.ndim == 1 else x.shape[1]
    kern = lambda: ell_spmv_cuda(op, x)
    plain = lambda: spmv_plain(op, x)
    csr, xx = _csr(op), x.reshape(x.shape[0], d)
    nbytes = ell_bytes(op, d)
    madds = int(op.mask.sum()) + op.num_vertices
    bound_ms, bound_by = bound(nbytes, 2 * madds * d)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, xx))
    row = {"shape": list(op.neighbors.shape), "d": d, "io_bytes": nbytes,
           "padding_bytes": padding_bytes(op),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "alone_ms": kernel_ms(kern, KERNEL),
           "alone_cold_ms": kernel_ms(kern, KERNEL, cold=True),
           "launches_a_call": len(kernel_events(kern)),
           "per_call_ms": cuda_ms(kern, cold=True),
           "per_call_warm_ms": cuda_ms(kern), "host_us": host_us(kern),
           "plain_ms": cuda_ms(plain), "plain_host_us": host_us(plain),
           "plain_launches_a_call": len(kernel_events(plain)),
           "library_ms": library_ms}
    row["share_of_bound"] = bound_ms / row["per_call_ms"]
    cold = row["alone_cold_ms"]
    row["alone_share_of_bound"] = None if cold is None else bound_ms / cold
    return row
