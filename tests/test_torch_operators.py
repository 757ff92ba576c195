"""PyTorch port vs the JAX package: graph Laplacian and screened-Poisson
operator on a 3,000-point torus graph, and the Galerkin product U^T A U
with U from the csrc coarsener.

Tolerances: operators at f32 within 1e-6 relative; RAP at f64 within
1e-12 of the dense maximum.
"""

import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.solve.rap import galerkin_rap as jax_rap
from gravomg_tpu.types import EllOperator as JEll, Graph as JGraph, \
    Prolongation as JProl

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.solve.rap import galerkin_rap
from gravomg_tpu_torch.types import EllOperator, Prolongation

torch.set_num_threads(2)


def _graph():
    """The port's graph and the same tables as a JAX Graph."""
    pts = torus_points(3000, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    gtorch = gt.grid_knn_graph_nosync(pts, 16, margin=2.4, device="cpu")
    gj = JGraph(*(jnp.asarray(t.numpy()) for t in gtorch))
    return gtorch, gj


def test_operators_match_jax():
    gtorch, gj = _graph()
    for weighting in ("invdist", "uniform"):
        lj, mj = g.graph_laplacian(gj, weighting)
        lt, mt = gt.graph_laplacian(gtorch, weighting)
        for a, b in ((lt.offdiag, lj.offdiag), (lt.diag, lj.diag),
                     (mt, mj)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
        sj, _ = g.screened_poisson_operator(gj, alpha="auto",
                                            weighting=weighting)
        st, _ = gt.screened_poisson_operator(gtorch, alpha="auto",
                                             weighting=weighting)
        assert st.diag.dtype == torch.float32
        np.testing.assert_allclose(st.diag.numpy(), np.asarray(sj.diag),
                                   rtol=1e-6)


def test_galerkin_rap_matches_jax_f64():
    gtorch, _ = _graph()
    op, _ = gt.screened_poisson_operator(gtorch, alpha="auto")
    cfg = gt.MultigridConfig(coarse_threshold=100, smoother="chebyshev")
    h = gt.build_hierarchy_host(gtorch, op, cfg)
    u = h.levels[0].u
    op64 = EllOperator(op.neighbors, op.offdiag.double(), op.diag.double())
    u64 = Prolongation(u.cols, u.weights.double(), u.n_coarse)
    ct = galerkin_rap(op64, u64).as_dense().numpy()
    cj, ovf = jax_rap(JEll(*(jnp.asarray(t.numpy()) for t in op64)),
                      JProl(jnp.asarray(u.cols.numpy()),
                            jnp.asarray(u64.weights.numpy()), u.n_coarse),
                      128)
    assert not bool(ovf)
    cj = np.asarray(cj.as_dense())
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-12 * np.abs(cj).max())
    # The hierarchy's own (f32) coarse operator is the same product.
    np.testing.assert_allclose(h.levels[1].op.as_dense().numpy(), cj, rtol=0,
                               atol=1e-5 * np.abs(cj).max())
