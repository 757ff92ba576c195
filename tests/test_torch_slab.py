"""PyTorch port vs the JAX package: the slab conversion of the 24k
fixture's level-0 A and U, and the whole slab matvec against the ELL
operator it came from.

Converted arrays are compared exactly; matvecs at atol 1e-6 * max|y|,
the bound of the JAX package's Pallas-vs-XLA test (tests/test_slab.py),
because the summation order differs.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.ops import slab as jslab
from gravomg_tpu.solve.spmv import spmv as jax_spmv

from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops import slab as tslab
from gravomg_tpu_torch.prolong.operator import prolong
from gravomg_tpu_torch.solve.spmv import spmv

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.fixture(scope="module")
def halo_slabs():
    """The 24k fixture's level-0 A and U slab forms in both packages."""
    hj, ht = jax_load_solver(HALO), load_solver(HALO, device="cpu")
    uj, ut = hj.levels[0].u, ht.levels[0].u
    pairs = {
        "a": (jslab.slab_from_operator(hj.levels[0].op, escape_cap=65536,
                                       use_pallas=False),
              tslab.slab_from_operator(ht.levels[0].op, escape_cap=65536)),
        "u": (jslab.slab_from_ell(uj.cols, uj.weights,
                                  jnp.ones_like(uj.cols, bool), uj.n_coarse,
                                  escape_cap=65536, use_pallas=False),
              tslab.slab_from_ell(ut.cols, ut.weights,
                                  torch.ones_like(ut.cols, dtype=torch.bool),
                                  ut.n_coarse, escape_cap=65536)),
    }
    return hj, ht, pairs


def test_slab_conversion_matches_jax(halo_slabs):
    """m, win_start, escape chute and inv_block_perm equal JAX's."""
    _, _, pairs = halo_slabs
    for sj, st in pairs.values():
        assert len(st.buckets) == len(sj.buckets) >= 3
        assert st.m_bytes == sj.m_bytes
        np.testing.assert_array_equal(_np(st.inv_block_perm),
                                      _np(sj.inv_block_perm))
        for bt, bj in zip(st.buckets, sj.buckets):
            for f in ("m", "win_start", "esc_rows", "esc_cols", "esc_w"):
                np.testing.assert_array_equal(_np(getattr(bt, f)),
                                              _np(getattr(bj, f)),
                                              err_msg=f)
            assert (bt.n_rows, bt.n_cols, bt.align) == (bj.n_rows, bj.n_cols,
                                                        bj.align)


def test_slab_matvec_matches_ell(halo_slabs):
    """The whole slab matvec (twin per bucket, escape, un-permutation,
    diagonal) against the ELL operator it was converted from."""
    hj, ht, pairs = halo_slabs
    rng = np.random.default_rng(9)
    lvl = ht.levels[0]
    x = rng.normal(size=lvl.op.num_vertices).astype(np.float32)
    want = _np(jax_spmv(hj.levels[0].op, jnp.asarray(x)))
    np.testing.assert_allclose(_np(spmv(lvl.op, torch.as_tensor(x))), want,
                               atol=1e-6 * np.abs(want).max())
    got = _np(tslab.slab_matvec(pairs["a"][1], torch.as_tensor(x)))
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    xc = rng.normal(size=lvl.u.n_coarse).astype(np.float32)
    want = _np(prolong(lvl.u, torch.as_tensor(xc)))
    got = _np(tslab.slab_matvec(pairs["u"][1], torch.as_tensor(xc)))
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
