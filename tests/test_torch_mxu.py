"""PyTorch port vs the JAX package: the transposed-tile (``mxu``) slab
form of the 24k fixture's level-0 A and U.

Converted arrays are compared exactly.  Matvecs at atol 2e-6 * max|y|,
the bound of the JAX package's own MXU test (tests/test_slab.py): the
twin and the JAX paths round x to m's dtype alike and sum the exact
products in another order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.ops import slab as jslab
from gravomg_tpu.ops.pallas_blockdense import mxu_matvec_pallas

from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops import slab as tslab
from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.mxu_cuda import mxu_matvec_plain

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


def _np(a):
    return (a.float().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                            else a))


@pytest.fixture(scope="module")
def mxu_slabs():
    """The 24k fixture's level-0 A and U in the mxu form, both packages."""
    hj, ht = jax_load_solver(HALO), load_solver(HALO, device="cpu")
    uj, ut = hj.levels[0].u, ht.levels[0].u
    return {
        "a": (jslab.slab_from_operator(hj.levels[0].op, escape_cap=65536,
                                       use_pallas=False, mxu=True),
              tslab.slab_from_operator(ht.levels[0].op, escape_cap=65536,
                                       mxu=True)),
        "u": (jslab.slab_from_ell(uj.cols, uj.weights,
                                  jnp.ones_like(uj.cols, bool), uj.n_coarse,
                                  escape_cap=65536, use_pallas=False,
                                  mxu=True),
              tslab.slab_from_ell(ut.cols, ut.weights,
                                  torch.ones_like(ut.cols, dtype=torch.bool),
                                  ut.n_coarse, escape_cap=65536, mxu=True)),
    }


def test_mxu_conversion_matches_jax(mxu_slabs):
    """Tiles, window starts, escape chute and inv_block_perm equal
    JAX's, 8/32 block padding included."""
    for sj, st in mxu_slabs.values():
        assert st.mxu and sj.mxu and st.block == sj.block == 128
        assert len(st.buckets) == len(sj.buckets) >= 2
        assert st.m_bytes == sj.m_bytes
        np.testing.assert_array_equal(_np(st.inv_block_perm),
                                      _np(sj.inv_block_perm))
        for bt, bj in zip(st.buckets, sj.buckets):
            assert tuple(bt.m.shape) == tuple(bj.m.shape)
            assert bt.m.shape[0] % 8 == 0 and bt.m.shape[2:] == (128, 128)
            for f in ("m", "win_start", "esc_rows", "esc_cols", "esc_w"):
                np.testing.assert_array_equal(_np(getattr(bt, f)),
                                              _np(getattr(bj, f)),
                                              err_msg=f)
            assert (bt.n_rows, bt.n_cols, bt.align) == (bj.n_rows, bj.n_cols,
                                                        bj.align)


def test_mxu_matvec_matches_pallas_and_xla(mxu_slabs):
    """Per bucket, the port's twin against the Pallas kernel (interpret
    mode) and the XLA path, each with its escape chute; then the whole
    slab matvec against JAX's; f32 and bf16 m."""
    rng = np.random.default_rng(5)
    for sj, st in mxu_slabs.values():
        x = rng.normal(size=st.n_cols).astype(np.float32)
        xj, xt = jnp.asarray(x), torch.as_tensor(x)
        xp = pad_x(st.buckets[0], xt)
        for jdt, tdt in ((jnp.float32, torch.float32),
                         (jnp.bfloat16, torch.bfloat16)):
            bjs = [b._replace(m=b.m.astype(jdt)) for b in sj.buckets]
            bts = [b._replace(m=b.m.to(tdt)) for b in st.buckets]
            for bj, bt in zip(bjs, bts):
                y_x = _np(jslab._mxu_bucket_matvec_xla(bj, xj))
                y_p = _np(jslab._bucket_escape(bj, mxu_matvec_pallas(
                    bj.m, bj.win_start // 128, xj, bj.m.shape[0] * 128,
                    interpret=True), xj))
                y_t = _np(mxu_matvec_plain(bt, xt, xp))
                atol = 2e-6 * np.abs(y_x).max()
                np.testing.assert_allclose(y_t, y_x, atol=atol)
                np.testing.assert_allclose(y_t, y_p, atol=atol)
            want = _np(jslab.slab_matvec(sj._replace(buckets=tuple(bjs)), xj,
                                         pallas=False))
            got = _np(tslab.slab_matvec(st._replace(buckets=tuple(bts)), xt))
            np.testing.assert_allclose(got, want,
                                       atol=2e-6 * np.abs(want).max())
