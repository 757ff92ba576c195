"""Stacked mesh collections: the port's ``parallel/batch.py`` and the
padding of ``parallel/sharding.py`` against the JAX package's.

(a) Three jittered level-3 icospheres built by JAX's ``build_hierarchy``
(as tests/test_batch.py::_family builds them, f64, with the Chebyshev
smoother, so each mesh has its own interval), carried across with
``solver_from_numpy``: JAX's size buckets give them one shape, so the
port's ``stack_solvers`` stacks them as they are.  ``batched_v_cycle``
equals JAX's at 1e-9 of the largest entry and ``batched_solve`` takes
the same number of cycles, its values and residuals at 1e-9 (summation
order only); ``attach_collection``'s results are ``stackable`` and their
batched cycle equals the ELL one at 1e-9.

(b) The port's own builds of three tori of different sizes: stacking
pads them, and each mesh's real rows of ``batched_v_cycle`` equal its own
``v_cycle`` at 1e-12 of the largest entry (f64), its padded rows stay
exactly 0.  ``pad_solver_levels`` and ``pad_solver_fine_level`` give the
arrays of JAX's on the 24k fixture, with ``pad_coarse`` false and true.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import icosphere
from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.io.serialization import save_solver as jax_save_solver
from gravomg_tpu.parallel import batch as jbatch
from gravomg_tpu.parallel import sharding as jshard

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


def _jax_family(tmp_path):
    """JAX's same-shape jittered icospheres, and the port's copies."""
    rng = np.random.default_rng(31)
    base, _ = icosphere(3)
    cfg = g.MultigridConfig(coarse_threshold=64, degree_multiple=32,
                            smoother="chebyshev")
    hj, ht = [], []
    for i in range(3):
        pts = base + rng.normal(scale=1e-3, size=base.shape)
        graph = g.knn_graph(jnp.asarray(pts), k=8)
        lap, mass = g.graph_laplacian(graph, "invdist")
        spd = lap._replace(diag=lap.diag + 0.5 * mass)
        h = g.build_hierarchy(graph, spd, cfg).solver
        path = str(tmp_path / f"mesh{i}.npz")
        jax_save_solver(path, h)
        hj.append(jax_load_solver(path))
        ht.append(gt.load_solver(path, device="cpu"))
    return hj, ht


def test_batched_cycle_and_solve_match_jax(tmp_path):
    hj, ht = _jax_family(tmp_path)
    assert jbatch.stackable(hj) and gt.stackable(ht)
    kw = dict(coarse_threshold=64, degree_multiple=32, smoother="chebyshev")
    cfg, tcfg = g.MultigridConfig(**kw), gt.MultigridConfig(**kw)
    v = ht[0].levels[0].op.num_vertices
    bs = np.random.default_rng(32).normal(size=(3, v))

    hbj = jbatch.stack_solvers(hj)
    hbt = gt.stack_solvers(ht)
    assert hbt.coarse_chol.shape == (3,) + ht[0].coarse_chol.shape
    assert hbt.levels[0].cheb.lam_max.shape == (3,)
    xj = np.asarray(jbatch.batched_v_cycle(
        hbj, jnp.zeros((3, v)), jnp.asarray(bs), cfg))
    bt = torch.as_tensor(bs)
    xt = gt.batched_v_cycle(hbt, torch.zeros_like(bt), bt, tcfg)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())

    sj, rj, itj = jbatch.batched_solve(hbj, jnp.asarray(bs), cfg)
    st, rt, itt = gt.batched_solve(hbt, bt, tcfg)
    sj, rj = np.asarray(sj), np.asarray(rj)
    assert itt == int(itj) and float(rt.max()) <= tcfg.tolerance
    np.testing.assert_allclose(st.numpy(), sj, rtol=0,
                               atol=1e-9 * np.abs(sj).max())
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-6)

    fast = gt.attach_collection(ht, block=64)
    assert gt.stackable(fast)
    for h in fast:
        lvl = h.levels[0]
        assert (lvl.banded is not None and lvl.uw is not None
                and lvl.utw is not None)
    xf = gt.batched_v_cycle(gt.stack_solvers(fast), torch.zeros_like(bt),
                            bt, tcfg)
    np.testing.assert_allclose(xf.numpy(), xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_same_arrays(hj, ht):
    assert len(hj.levels) == len(ht.levels)
    np.testing.assert_array_equal(_np(ht.coarse_chol), _np(hj.coarse_chol))
    for lj, lt in zip(hj.levels, ht.levels):
        assert lt.banded is None and lt.uw is None and lt.utw is None
        for a, b in ((lj.op.neighbors, lt.op.neighbors),
                     (lj.op.offdiag, lt.op.offdiag),
                     (lj.op.diag, lt.op.diag)):
            np.testing.assert_array_equal(_np(b), _np(a))
        assert (lj.u is None) == (lt.u is None)
        if lj.u is not None:
            assert lt.u.n_coarse == lj.u.n_coarse
            np.testing.assert_array_equal(_np(lt.u.cols), _np(lj.u.cols))
            np.testing.assert_array_equal(_np(lt.u.weights),
                                          _np(lj.u.weights))
            assert lt.ut.n_fine == lj.ut.n_fine
            np.testing.assert_array_equal(_np(lt.ut.rows), _np(lj.ut.rows))
            np.testing.assert_array_equal(_np(lt.ut.weights),
                                          _np(lj.ut.weights))


def test_padded_collection_keeps_each_mesh():
    cfg = gt.MultigridConfig(coarse_threshold=100, smoother="chebyshev",
                             max_levels=3)
    hs = []
    for i, n in enumerate((900, 1000, 1100)):
        pts = torus_points(n, seed=40 + i)
        pts = pts[morton_order(pts)]
        graph = gt.knn_graph(torch.as_tensor(pts), k=10)
        op, _ = gt.screened_poisson_operator(graph, alpha="auto")
        h, _ = gt.build_hierarchy_device(
            graph, op, cfg, generator=torch.Generator().manual_seed(i))
        hs.append(h.solver)
    sizes = [[lvl.op.num_vertices for lvl in h.levels] for h in hs]
    assert len({tuple(s) for s in sizes}) == 3 and not gt.stackable(hs)
    hb = gt.stack_solvers(hs)
    rows = [lvl.op.num_vertices for lvl in hb.levels]
    assert rows == [max(col) for col in zip(*sizes)]
    rng = np.random.default_rng(41)
    bs = torch.zeros((3, rows[0]), dtype=torch.float64)
    for i, s in enumerate(sizes):
        bs[i, :s[0]] = torch.as_tensor(rng.normal(size=s[0]))
    xs = gt.batched_v_cycle(hb, torch.zeros_like(bs), bs, cfg)
    for i, (h, s) in enumerate(zip(hs, sizes)):
        b = bs[i, :s[0]]
        x1 = gt.v_cycle(h, torch.zeros_like(b), b, cfg)
        torch.testing.assert_close(xs[i, :s[0]], x1, rtol=0,
                                   atol=1e-12 * float(x1.abs().max()))
        assert not bool(xs[i, s[0]:].any())

    hj = jax_load_solver(HALO)
    ht = gt.load_solver(HALO, device="cpu")
    for pad_coarse in (False, True):
        _assert_same_arrays(jshard.pad_solver_levels(hj, 1000, pad_coarse),
                            gt.pad_solver_levels(ht, 1000, pad_coarse))
    fj = jshard.pad_solver_fine_level(hj, 7)
    ft = gt.pad_solver_fine_level(ht, 7)
    assert ft.levels[0].op.num_vertices == fj.levels[0].op.num_vertices
    np.testing.assert_array_equal(_np(ft.levels[0].op.neighbors),
                                  _np(fj.levels[0].op.neighbors))
    np.testing.assert_array_equal(_np(ft.levels[0].u.weights),
                                  _np(fj.levels[0].u.weights))
    assert ft.levels[0].ut.n_fine == fj.levels[0].ut.n_fine
    jax.clear_caches()
