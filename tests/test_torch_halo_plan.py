"""The halo-exchange plan (``parallel/halo.py::build_halo_ell``, host
side, no process group) against the JAX package's, array for array.

On the 24k Chebyshev fixture padded for the halo path (every level a
multiple of nd, the coarsest too), for nd 2, 4 and 8: every level's A,
U and U^T plan as the port's ``level_plans`` builds it equals the one
JAX's ``halo_shard_solver`` builds from JAX's padded arrays (local
columns, values, diagonal, send table, segment size S, halo_frac).
"""

import os

import numpy as np
import pytest

from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.parallel import halo as jhalo
from gravomg_tpu.parallel import sharding as jshard
from gravomg_tpu.types import INVALID_INDEX

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.parallel.halo import build_halo_ell, level_plans

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


def _jax_plans(lvl, nd):
    """JAX's plans of one padded level, as its halo_shard_solver makes
    them (before the arrays are laid out over a mesh)."""
    op = lvl.op
    nbr = np.asarray(op.neighbors)
    plans = [jhalo.build_halo_ell(nbr, np.asarray(op.offdiag),
                                  nbr != int(INVALID_INDEX),
                                  op.num_vertices, nd,
                                  diag=np.asarray(op.diag))]
    if lvl.u is not None:
        cols = np.asarray(lvl.u.cols)
        plans.append(jhalo.build_halo_ell(cols, np.asarray(lvl.u.weights),
                                          np.ones_like(cols, bool),
                                          lvl.u.n_coarse, nd))
        rows = np.asarray(lvl.ut.rows)
        plans.append(jhalo.build_halo_ell(rows, np.asarray(lvl.ut.weights),
                                          rows != int(INVALID_INDEX),
                                          lvl.ut.n_fine, nd))
    return plans


def test_halo_plans_equal_jax():
    hj = jax_load_solver(HALO)
    ht = gt.load_solver(HALO, device="cpu")
    for nd in (2, 4, 8):
        pj = jshard.pad_solver_levels(hj, nd, pad_coarse=True)
        pt = gt.pad_solver_levels(ht, nd, pad_coarse=True)
        for li, (lj, lt) in enumerate(zip(pj.levels, pt.levels)):
            want = _jax_plans(lj, nd)
            got = [p for p in level_plans(lt, nd, device="cpu")
                   if p is not None]
            assert len(got) == len(want), (nd, li)
            for a, b in zip(want, got):
                assert (b.n_rows, b.n_src, b.s, b.nd) == \
                    (a.n_rows, a.n_src, a.s, a.nd), (nd, li)
                assert b.halo_frac == a.halo_frac
                for name in ("cols", "vals", "send_idx"):
                    x, y = np.asarray(getattr(a, name)), getattr(b, name)
                    assert y.numpy().dtype == x.dtype, name
                    np.testing.assert_array_equal(y.numpy(), x)
                assert (a.diag is None) == (b.diag is None)
                if a.diag is not None:
                    np.testing.assert_array_equal(b.diag.numpy(),
                                                  np.asarray(a.diag))
                assert b.s % 8 == 0


def test_build_halo_ell_rejects_misaligned():
    cols = np.zeros((10, 2), np.int32)
    vals = np.ones((10, 2), np.float32)
    with pytest.raises(ValueError):
        build_halo_ell(cols, vals, np.ones_like(cols, bool), 16, 8,
                       device="cpu")
