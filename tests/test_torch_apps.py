"""The port's apps against the JAX package's on a noisy icosphere (642
vertices, kNN k=8), f64 on both sides, Chebyshev, with hierarchies built
by ``poisson_hierarchy`` in each package (the reference's sampling:
equal on the real prefix of JAX's padded coarse levels).

- ``poisson_hierarchy``: level sizes equal, U rows and coarse operators
  at 1e-12.
- ``solve_poisson`` (MG-PCG, V-cycles, refined): iterations equal,
  solutions at 1e-9 of their largest entry.
- ``refit_hierarchy``: JAX's refit at 1e-10; on three levels, the port's
  refit equals its own build for the new operator at 1e-12 (operators,
  Chebyshev bounds, coarse factor), keeps U's forms and drops A's.
- ``heat_geodesics``: phi at 1e-6 of its largest entry; the signs of the
  heat step's edge field equal wherever |gradient| >= 1e-12.
- ``implicit_smooth`` (two steps): points at 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gravomg_tpu as g
from gravomg_tpu.apps.heat import heat_geodesics as jax_heat_geodesics
from gravomg_tpu.apps.heat import refit_hierarchy as jax_refit_hierarchy
from gravomg_tpu.apps.poisson import poisson_hierarchy as jax_poisson_hierarchy
from gravomg_tpu.apps.poisson import solve_poisson as jax_solve_poisson
from gravomg_tpu.apps.smoothing import implicit_smooth as jax_implicit_smooth
from gravomg_tpu.geometry.meshes import icosphere

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.apps.heat import edge_field
from gravomg_tpu_torch.probes.build_check import u_rows_diff

from test_torch_build_util import both_graphs

torch.set_num_threads(2)


CFG = dict(coarse_threshold=200, smoother="chebyshev")


@pytest.fixture(scope="module")
def sphere():
    """(JAX graph, port graph, JAX hierarchy, port hierarchy) of the
    screened Poisson operator (alpha 0.5): 642 / 162 rows.  Built once,
    on two levels: JAX's build compiles for about 14 s, 24 s on three."""
    v, _ = icosphere(3)
    pts = v + np.random.default_rng(21).normal(scale=1e-3, size=v.shape)
    tg = gt.knn_graph(torch.as_tensor(pts), k=8)
    gj = g.Graph(*(jnp.asarray(t.numpy()) for t in tg))
    return (gj, tg,
            jax_poisson_hierarchy(gj, alpha=0.5, cfg=g.MultigridConfig(**CFG)),
            gt.poisson_hierarchy(tg, alpha=0.5, cfg=gt.MultigridConfig(**CFG)))


def _dense(op, n):
    return np.asarray(op.as_dense())[:n, :n]


def test_poisson_solves_and_refit_match_jax(sphere):
    gj, tg, hj, ht = sphere
    jc, tc = g.MultigridConfig(**CFG), gt.MultigridConfig(**CFG)
    assert len(ht.levels) == len(hj.levels) == 1
    for li, (jl, tl) in enumerate(zip(hj.levels, ht.levels)):
        nf, nc = tl.stats.n_fine, tl.stats.n_coarse
        assert (nf, nc) == (int(jl.stats.n_fine), int(jl.stats.n_coarse))
        err, flipped = u_rows_diff(
            tl.u.cols.numpy(), tl.u.weights.numpy(),
            np.asarray(jl.u.cols)[:nf], np.asarray(jl.u.weights)[:nf])
        assert err.max() <= 1e-12 and not flipped.any(), li
        a_j = _dense(hj.solver.levels[li + 1].op, nc)
        a_t = ht.solver.levels[li + 1].op.as_dense().numpy()
        np.testing.assert_allclose(a_t, a_j, rtol=0,
                                   atol=1e-12 * np.abs(a_j).max())

    b = np.random.default_rng(22).normal(size=tg.num_vertices)
    for method, refined in (("pcg", False), ("vcycle", False),
                            ("pcg", True)):
        xj, rel_j, it_j = jax_solve_poisson(hj, jnp.asarray(b), jc,
                                            method=method, refined=refined)
        xt, rel_t, it_t = gt.solve_poisson(ht, torch.as_tensor(b), tc,
                                           method=method, refined=refined)
        xj = np.asarray(xj)
        assert it_t == int(it_j) and rel_t <= 1e-8, (method, refined)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                                   atol=1e-9 * np.abs(xj).max())

    lap_j, mass_j = g.graph_laplacian(gj, "invdist")
    lap_t, mass_t = gt.graph_laplacian(tg, "invdist")
    op_j = lap_j._replace(diag=lap_j.diag + 2.0 * mass_j)
    op_t = lap_t._replace(diag=lap_t.diag + 2.0 * mass_t)
    rj = jax_refit_hierarchy(hj, op_j, jc)
    rt = gt.refit_hierarchy(ht, op_t, tc)
    for a, b_ in zip(rt.levels, rj.levels):
        n = a.op.num_vertices
        ref = _dense(b_.op, n)
        np.testing.assert_allclose(a.op.as_dense().numpy(), ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())

    # Port against port on three levels: the refit of a hierarchy built
    # for another operator is the build for this one.
    t3 = gt.MultigridConfig(coarse_threshold=64, smoother="chebyshev")
    hf = gt.attach_fast_operators(gt.build_hierarchy(tg, lap_t, t3).solver)
    rt = gt.refit_hierarchy(hf, op_t, t3)
    own = gt.build_hierarchy(tg, op_t, t3).solver
    assert len(own.levels) == 3
    for a, b_, old in zip(rt.levels, own.levels, hf.levels):
        ref = b_.op.as_dense()
        torch.testing.assert_close(a.op.as_dense(), ref, rtol=0,
                                   atol=1e-12 * float(ref.abs().max()))
        np.testing.assert_allclose(a.cheb, b_.cheb, rtol=1e-12)
        assert a.banded is None and a.u is old.u and a.ut is old.ut
        assert a.uw is old.uw and a.utw is old.utw
    assert hf.levels[0].banded is not None and hf.levels[0].uw is not None
    torch.testing.assert_close(rt.coarse_chol, own.coarse_chol, rtol=0,
                               atol=1e-12 * float(own.coarse_chol.abs().max()))


def test_heat_geodesics_and_smoothing_match_jax(sphere):
    gj, tg, hj, ht = sphere
    jc, tc = g.MultigridConfig(**CFG), gt.MultigridConfig(**CFG)

    phi_j = np.asarray(jax_heat_geodesics(gj, hj, 0, cfg=jc))
    phi_t = gt.heat_geodesics(tg, ht, 0, cfg=tc)
    assert phi_t[0] == 0.0
    np.testing.assert_allclose(phi_t.numpy(), phi_j, rtol=0,
                               atol=1e-6 * np.abs(phi_j).max())

    # The heat step's edge field, from each package's own heat solve.
    lap_j, mass_j = g.graph_laplacian(gj, "invdist")
    lap_t, mass_t = gt.graph_laplacian(tg, "invdist")
    t = float(np.mean(np.asarray(gj.distances)[np.asarray(gj.mask)]) ** 2)
    delta = np.zeros(tg.num_vertices)
    delta[0] = 1.0
    sh_j = jax_refit_hierarchy(hj, lap_j._replace(
        diag=lap_j.diag * t + mass_j, offdiag=lap_j.offdiag * t), jc)
    u_j, _, _ = g.mg_pcg(sh_j, mass_j * jnp.asarray(delta), jc)
    sh_t = gt.refit_hierarchy(ht, lap_t._replace(
        diag=lap_t.diag * t + mass_t, offdiag=lap_t.offdiag * t), tc)
    u_t, _, _ = gt.mg_pcg(sh_t, mass_t * torch.as_tensor(delta), tc)
    d = np.where(np.asarray(gj.mask), np.asarray(gj.distances), np.inf)
    u_j = np.asarray(u_j)
    grad_j = (u_j[np.asarray(gj.safe_neighbors())] - u_j[:, None]) / d
    grad_t, xdir_t = edge_field(tg, u_t)
    clear = np.abs(grad_j) >= 1e-12
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(xdir_t.numpy()[clear],
                                  -np.sign(grad_j)[clear])
    assert torch.equal(xdir_t, -torch.sign(grad_t))

    pts_j = np.asarray(jax_implicit_smooth(gj, hj, t_factor=2.0, steps=2,
                                           cfg=jc))
    record = {}
    pts_t = gt.implicit_smooth(tg, ht, t_factor=2.0, steps=2, cfg=tc,
                               record=record)
    assert pts_t.shape == (tg.num_vertices, 3)
    assert [s["rel"] <= 1e-8 for s in record["steps"]] == [True, True]
    np.testing.assert_allclose(pts_t.numpy(), pts_j, rtol=0,
                               atol=1e-9 * np.abs(pts_j).max())
