"""K1's one-launch twin and the port's 1-D slab matvec, on the CPU.

K1 (``csrc/blockdense_matvec.cu``) applies all buckets of an 8-row slab
form in one launch, each output block in row order taking its block's
products from its bucket, with the form's diagonal fused into the store.
Its twin ``slab_matvec_plain`` is held against the per-bucket route it
replaced (``blockdense_matvec_plain`` per bucket, ``torch.cat``, the
``inv_block_perm`` gather, then the diagonal) on every 8-row slab form of
the shipped 24,000-row fixture (A, U and U^T of each level of at least
512 rows) in f64, with and without an escape chute: 1e-13 of max|y| (the
same products, the diagonal and the chute added in another order).

The port's 1-D ``slab_matvec`` on the CPU (the twin) is held against the
JAX package's ``slab_matvec`` on the same forms with f32 m at 1e-6 of
max|y|, the bound of tests/test_slab.py; JAX runs its non-kernel bucket
matvec there, as its own CPU tests do, on the port's converted arrays
handed over (the conversions are equal array for array,
tests/test_torch_slab.py).  The bound of one launch
(``probes/timing.py::slab_matvec_bound``) counts the bytes of the blocks
inv_block_perm names, x unpadded, the diagonal and y: checked against
numpy.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu.ops.blockdense import BlockDenseOperator as JaxBlockDense
from gravomg_tpu.ops.slab import SlabOperator as JaxSlab
from gravomg_tpu.ops.slab import slab_matvec as jax_slab_matvec

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import solver_from_numpy
from gravomg_tpu_torch.ops.blockdense_cuda import (slab_matvec_1d_fast,
                                                   slab_matvec_plain)
from gravomg_tpu_torch.ops.slab import slab_matvec
from gravomg_tpu_torch.probes.timing import (F32_FLOPS, HBM_BYTES_PER_S,
                                             slab_matvec_bound)
from test_torch_b1_util import per_bucket_twin

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
FIELDS = ("banded", "uw", "utw")


def _slabs(dtype):
    with np.load(HALO) as z:
        arrays = {k: (z[k].astype(dtype) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    h = gt.attach_slab_operators(solver_from_numpy(arrays, device="cpu"),
                                 min_rows=512)
    slabs = [getattr(lvl, f) for lvl in h.levels for f in FIELDS
             if getattr(lvl, f) is not None]
    assert len(slabs) >= 5 and all(not s.mxu for s in slabs)
    assert any(s.diag is not None for s in slabs)
    return slabs


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


def _to_jax(sop):
    return JaxSlab(_j(sop.diag), tuple(
        JaxBlockDense(None, _j(b.m), _j(b.win_start), _j(b.esc_rows),
                      _j(b.esc_cols), _j(b.esc_w), b.n_rows, b.n_cols,
                      b.block, b.window, b.window0, b.align)
        for b in sop.buckets), _j(sop.inv_block_perm), sop.n_rows,
        sop.n_cols, sop.block, use_pallas=False, mxu=False)


def test_one_launch_twin_matches_per_bucket_route():
    rng = np.random.default_rng(41)
    for sop in _slabs(np.float64):
        b0 = sop.buckets[0]
        escaped = sop._replace(buckets=(b0._replace(
            esc_rows=torch.as_tensor([0, 9, 8 * b0.m.shape[0] - 1],
                                     dtype=b0.esc_rows.dtype),
            esc_cols=torch.as_tensor([3, 0, sop.n_cols - 1],
                                     dtype=b0.esc_cols.dtype),
            esc_w=torch.as_tensor([0.5, -1.25, 2.0],
                                  dtype=b0.m.dtype)),) + sop.buckets[1:])
        x = torch.as_tensor(rng.normal(size=sop.n_cols))
        for op in (sop, escaped):
            want = per_bucket_twin(op, x)
            if op.diag is not None:
                want = want + op.diag * x
            got = slab_matvec_plain(op, x)
            assert got.shape == (op.n_rows,) and got.dtype == torch.float64
            tol = 1e-13 * float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=tol)
            # On the CPU the 1-D slab matvec is the twin, diagonal and all.
            assert torch.equal(slab_matvec(op, x), got)
            assert torch.equal(slab_matvec_1d_fast(op, x), got)


def test_slab_matvec_matches_jax_and_bound_counts_read_blocks():
    rng = np.random.default_rng(42)
    for sop in _slabs(np.float32):
        x = rng.normal(size=sop.n_cols).astype(np.float32)
        want = np.asarray(jax_slab_matvec(_to_jax(sop), jnp.asarray(x)))
        got = slab_matvec(sop, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())

        for mdtype in (torch.float32, torch.bfloat16):
            s = sop._replace(buckets=tuple(b._replace(m=b.m.to(mdtype))
                                           for b in sop.buckets))
            inv = sop.inv_block_perm.numpy()
            ends = np.cumsum([b.m.shape[0] for b in s.buckets])
            used = [int(((inv >= e - b.m.shape[0]) & (inv < e)).sum())
                    for b, e in zip(s.buckets, ends)]
            assert sum(used) == inv.shape[0] == -(-sop.n_rows // 8)
            esize = 4 if mdtype == torch.float32 else 2
            madds = sum(u * 8 * b.m.shape[2] for u, b in zip(used, s.buckets))
            n_diag = 0 if sop.diag is None else sop.n_rows
            nbytes = (esize * madds
                      + sum(4 * u * b.win_start.shape[1]
                            for u, b in zip(used, s.buckets))
                      + 4 * inv.shape[0] + 4 * sop.n_cols + 4 * n_diag
                      + 4 * sop.n_rows)
            ms, by, got_bytes = slab_matvec_bound(s, torch.as_tensor(x))
            assert got_bytes == nbytes
            by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            by_ops = 2 * (madds + n_diag) / F32_FLOPS * 1e3
            assert ms == max(by_bytes, by_ops)
            assert by == ("bytes" if by_bytes >= by_ops else "operations")
