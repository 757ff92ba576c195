"""Percent of the memory roofline that the level-0 A matvec reaches
through the slab operator (``solve/vcycle.py::level_matvec`` on the slab
form, ``ops/slab.py``, K1 in ``csrc/blockdense_matvec.cu``), in the
dtype of the cycle the calls run.

The bytes are the operator's as the problem defines it, whatever form
the program stores: each nonzero off the diagonal of level-0 A at the
dtype's size plus a 4-byte column index, and x, y and the diagonal once
each at 4 bytes (:func:`operator_bytes`).  The bound is those bytes over
the card's published bandwidth (``benchmark/peaks.py``); the share is
the bound over the time, CUDA events around ``LAUNCHES`` back-to-back
launches after the window (the level-0 form is some GB, the L2 cache 50
MB, so each launch finds it cold).  Nothing where level 0 has no slab
form, or off the card."""

import torch

from gravomg_tpu_torch.ops.slab import SlabOperator
from gravomg_tpu_torch.solve.vcycle import cast_fast_operators, level_matvec

from benchmark.deploy import cycle_dtype
from benchmark.peaks import HBM_BYTES_PER_S

LAUNCHES = 50
INDEX_BYTES = VECTOR_BYTES = 4


def operator_bytes(neighbors, offdiag, valid, value_bytes: int) -> int:
    """Bytes a matvec of the operator needs: its nonzeros off the
    diagonal (``valid`` slots whose value is not 0) at ``value_bytes``
    each plus a column index, and x, y and the diagonal once."""
    nnz = int(torch.count_nonzero(valid & (offdiag != 0)))
    rows = neighbors.shape[0]
    return nnz * (value_bytes + INDEX_BYTES) + 3 * rows * VECTOR_BYTES


def read(run):
    dep = run.mix.dep
    if (run.device.type != "cuda"
            or not isinstance(dep.h.levels[0].banded, SlabOperator)):
        return None
    dtype = cycle_dtype(dep, run.mix.kind)
    h = dep.h if dtype == torch.float32 else cast_fast_operators(dep.h, dtype)
    level = h.levels[0]
    op = level.op
    nbytes = operator_bytes(op.neighbors, op.offdiag, op.mask,
                            torch.finfo(dtype).bits // 8)
    x = torch.ones_like(op.diag)
    for _ in range(3):
        level_matvec(level, x)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        level_matvec(level, x)
    end.record()
    end.synchronize()
    seconds = start.elapsed_time(end) / 1e3 / LAUNCHES
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
