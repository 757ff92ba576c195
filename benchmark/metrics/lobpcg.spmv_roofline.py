"""Percent of the memory roofline that LOBPCG's product of L with its
search block reaches: ``solve/spmv.py::spmv(lap, S)``, the ELL gather,
with S = [X, W, P] (V, 3k) float32 as a step of an eigenpairs mix
forms it.

The bytes are the product's as the problem defines it
(:func:`spmv_bytes`): each nonzero of L off the diagonal at 4 bytes
plus a 4-byte column index, and S, the output and the diagonal once
each at 4 bytes an entry.  The bound is those bytes over the card's
published bandwidth (``benchmark/peaks.py``); the share is the bound
over the time, CUDA events around ``LAUNCHES`` back-to-back products
after the window.  Nothing off the card or for another mix."""

import torch

from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.solve.spmv import spmv

from benchmark.peaks import HBM_BYTES_PER_S

LAUNCHES = 50
VALUE_BYTES = INDEX_BYTES = 4


def spmv_bytes(neighbors, offdiag, valid, width: int) -> int:
    """Bytes of L @ S for S (V, ``width``) float32: L's nonzeros off the
    diagonal (``valid`` slots whose value is not 0) with their column
    indices, S and the output, and the diagonal once."""
    nnz = int(torch.count_nonzero(valid & (offdiag != 0)))
    rows = neighbors.shape[0]
    return (nnz * (VALUE_BYTES + INDEX_BYTES)
            + (2 * width + 1) * rows * VALUE_BYTES)


def read(run):
    if run.device.type != "cuda" or run.mix.kind != "laplace_eigs":
        return None
    lap, _ = graph_laplacian(run.mix.dep.graph, "invdist")
    width = 3 * run.mix.traffic["k"]
    nbytes = spmv_bytes(lap.neighbors, lap.offdiag, lap.mask, width)
    s = torch.randn((lap.num_vertices, width), device=run.device,
                    dtype=lap.diag.dtype)
    for _ in range(3):
        spmv(lap, s)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        spmv(lap, s)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / LAUNCHES
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
