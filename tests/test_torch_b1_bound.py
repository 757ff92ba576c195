"""B1's bound and its one-launch twin, on the CPU.

B1 (``csrc/blockdense_matmat.cu``) multiplies only the (block, position)
pairs of an 8-row slab form where one of the block's 8 rows holds a
nonzero, so ``probes/timing.py::matvec_bound`` counts 8 * D multiply-adds
per such pair for a (n_cols, D) x, on the form's own m, and m's bytes
whole.  Both counts are held here against numpy on every 8-row slab form
of the shipped 24,000-row fixture (A, U and U^T of each level of at least
512 rows).

``slab_matmat_plain``, the twin of one launch of B1 over all buckets of a
form (each output block in row order takes its bucket's products), is
held against the per-bucket route it replaced on the (V, D) path
(``blockdense_matmat_plain`` per bucket, ``torch.cat``, then the
``inv_block_perm`` gather) in f64 at D 3 and 64, with and without an
escape chute: 1e-13 of max|Y| (the same products in another grouping).
"""

import os

import numpy as np
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import solver_from_numpy
from gravomg_tpu_torch.ops.blockdense import padded_length
from gravomg_tpu_torch.ops.blockdense_cuda import slab_matmat_plain
from gravomg_tpu_torch.ops.slab import slab_matvec
from gravomg_tpu_torch.probes.timing import (F32_FLOPS, HBM_BYTES_PER_S,
                                             matvec_bound, nonzero_pairs)
from test_torch_b1_util import per_bucket_twin

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
FIELDS = ("banded", "uw", "utw")


def _slabs(dtype=np.float32):
    with np.load(HALO) as z:
        arrays = {k: (z[k].astype(dtype) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    h = gt.attach_slab_operators(solver_from_numpy(arrays, device="cpu"),
                                 min_rows=512)
    slabs = [getattr(lvl, f) for lvl in h.levels for f in FIELDS
             if getattr(lvl, f) is not None]
    assert len(slabs) >= 5 and all(not s.mxu for s in slabs)
    return slabs


def test_b1_bound_counts_nonzero_positions():
    rng = np.random.default_rng(31)
    for sop in _slabs():
        for mdtype in (torch.float32, torch.bfloat16):
            bs = [b._replace(m=b.m.to(mdtype)) for b in sop.buckets]
            want = sum(int((b.m.float().numpy() != 0).any(axis=1).sum())
                       for b in bs)
            total = sum(b.m.shape[0] * b.m.shape[2] for b in bs)
            assert nonzero_pairs(bs) == want and 0 < want < total
            m_bytes = sop._replace(buckets=tuple(bs)).m_bytes
            for d in (3, 64):
                x = torch.as_tensor(rng.normal(size=(sop.n_cols, d))
                                    .astype(np.float32))
                ms, by, nbytes = matvec_bound(bs, x)
                rest = (sum(4 * b.win_start.numel() for b in bs)
                        + 4 * d * padded_length(bs[0], sop.n_cols)
                        + 4 * d * 8 * sum(b.m.shape[0] for b in bs))
                assert nbytes - rest == m_bytes
                by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                by_ops = 2 * 8 * d * want / F32_FLOPS * 1e3
                assert ms == max(by_bytes, by_ops)
                assert by == ("bytes" if by_bytes >= by_ops
                              else "operations")
            # One column: every entry of m, as K1 reads them.
            x1 = torch.zeros(sop.n_cols)
            ms1, _, nbytes1 = matvec_bound(bs, x1)
            assert ms1 == max(nbytes1 / HBM_BYTES_PER_S,
                              2 * sum(b.m.numel() for b in bs)
                              / F32_FLOPS) * 1e3


def test_one_launch_twin_matches_per_bucket_route():
    rng = np.random.default_rng(32)
    for sop in _slabs(np.float64):
        b0 = sop.buckets[0]
        rows = np.array([0, 9, 8 * b0.m.shape[0] - 1])
        escaped = sop._replace(buckets=(b0._replace(
            esc_rows=torch.as_tensor(rows, dtype=b0.esc_rows.dtype),
            esc_cols=torch.as_tensor([3, 0, sop.n_cols - 1],
                                     dtype=b0.esc_cols.dtype),
            esc_w=torch.as_tensor([0.5, -1.25, 2.0],
                                  dtype=b0.m.dtype)),) + sop.buckets[1:])
        for d in (3, 64):
            x = torch.as_tensor(rng.normal(size=(sop.n_cols, d)))
            for op in (sop, escaped):
                want = per_bucket_twin(op, x)
                got = slab_matmat_plain(op, x)
                assert got.shape == (op.n_rows, d)
                assert got.dtype == torch.float64
                tol = 1e-13 * float(want.abs().max())
                torch.testing.assert_close(got, want, rtol=0, atol=tol)
            full = slab_matvec(sop, x)
            diag = 0 if sop.diag is None else sop.diag[:, None] * x
            torch.testing.assert_close(full, slab_matmat_plain(sop, x) + diag,
                                       rtol=0, atol=0)
