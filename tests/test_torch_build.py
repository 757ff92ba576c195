"""The port's two build functions against the JAX package's, level by level on
the same numpy graph and operator.

``build_hierarchy`` (f64, the reference's sampling) against JAX's
``build_hierarchy`` on the real prefix of each level (JAX pads coarse
levels to a size bucket with phantom rows): samples and parents equal, U
rows and the coarse operator at 1e-10, MG-PCG iterations within 1.

``build_hierarchy_device`` (f32, fed JAX's own permutations) against
JAX's ``build_hierarchy_device`` + ``check_diagnostics`` +
``compact_solver`` on a Morton-ordered cloud: samples and parents equal,
U rows at 1e-5 with under 0.5% flipped (JAX takes its affine
barycentric form in f32), the coarse operator at 1e-5 of its largest
entry, MG-PCG iterations within 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order
from gravomg_tpu.hierarchy_static import (build_hierarchy_device,
                                          check_diagnostics, compact_solver)

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.probes.build_check import u_rows_diff

from test_torch_build_util import both_graphs

torch.set_num_threads(2)


def _problem(pts, k, dtype):
    gj, tg = both_graphs(pts, k=k, dtype=dtype)
    lap, mass = g.graph_laplacian(gj, "invdist")
    tl, tm = gt.graph_laplacian(tg, "invdist")
    return (gj, lap._replace(diag=lap.diag + 0.5 * mass),
            tg, tl._replace(diag=tl.diag + 0.5 * tm))


def _compare_levels(hj, ht, u_tol, op_tol, flips):
    assert len(ht.levels) == len(hj.levels) >= 2
    assert len(ht.graphs) == len(ht.levels) + 1
    for li, (jl, tl) in enumerate(zip(hj.levels, ht.levels)):
        nf, nc = tl.stats.n_fine, tl.stats.n_coarse
        assert (nf, nc) == (int(jl.stats.n_fine), int(jl.stats.n_coarse))
        assert ht.graphs[li + 1].num_vertices == nc   # no phantom rows
        np.testing.assert_array_equal(tl.samples.numpy(),
                                      np.asarray(jl.samples)[:nc])
        np.testing.assert_array_equal(tl.parents.numpy(),
                                      np.asarray(jl.parents)[:nf])
        err, flipped = u_rows_diff(
            tl.u.cols.numpy(), tl.u.weights.numpy(),
            np.asarray(jl.u.cols)[:nf], np.asarray(jl.u.weights)[:nf])
        assert err.max() < u_tol and flipped.sum() <= flips * nf, (
            li, err.max(), flipped.sum())
        a_j = np.asarray(hj.solver.levels[li + 1].op.as_dense())[:nc, :nc]
        a_t = ht.solver.levels[li + 1].op.as_dense().numpy()
        assert np.abs(a_t - a_j).max() <= op_tol * np.abs(a_j).max(), li


def test_build_hierarchy_matches_jax():
    gj, spd_j, tg, spd_t = _problem(torus_points(2000, seed=13), 10,
                                    np.float64)
    kw = dict(coarse_threshold=100, smoother="chebyshev")
    hj = g.build_hierarchy(gj, spd_j, g.MultigridConfig(**kw))
    ht = gt.build_hierarchy(tg, spd_t, gt.MultigridConfig(**kw))
    _compare_levels(hj, ht, 1e-10, 1e-10, 0.0)
    # Case counts on the finest level only: below it JAX also counts its
    # phantom fine rows, which the port's levels do not have.
    for f in ("n_triangles", "triangle_hits", "edge_fallbacks",
              "point_fallbacks"):
        assert getattr(ht.levels[0].stats, f) == int(
            getattr(hj.levels[0].stats, f)), f
    assert all(tl.stats.n_triangles == int(jl.stats.n_triangles)
               for jl, tl in zip(hj.levels, ht.levels))
    b = np.random.default_rng(0).normal(size=2000)
    _, rel_j, it_j = g.mg_pcg(hj.solver, jnp.asarray(b),
                              g.MultigridConfig(**kw))
    _, rel_t, it_t = gt.mg_pcg(ht.solver, torch.as_tensor(b),
                               gt.MultigridConfig(**kw))
    assert rel_t <= 1e-8 and float(rel_j) <= 1e-8
    assert abs(it_t - int(it_j)) <= 1, (it_t, int(it_j))

    # The stop rules: max_levels cuts the stack; a threshold above the
    # cloud leaves the fine level alone.
    h2 = gt.build_hierarchy(tg, spd_t, gt.MultigridConfig(max_levels=2, **kw))
    assert len(h2.graphs) == 2 and len(h2.solver.levels) == 2
    h1 = gt.build_hierarchy(tg, spd_t,
                            gt.MultigridConfig(coarse_threshold=5000))
    assert len(h1.graphs) == 1 and h1.levels == ()


def test_build_hierarchy_device_matches_jax():
    n = 4000
    pts = torus_points(n, seed=2)
    gj, spd_j, tg, spd_t = _problem(pts[morton_order(pts)], 12, np.float32)
    kw = dict(coarse_threshold=200, smoother="chebyshev")
    hj, diags = build_hierarchy_device(gj, spd_j, g.MultigridConfig(**kw))
    check_diagnostics(diags)
    hc = compact_solver(hj.solver, diags, row_multiple=64)
    # JAX draws each level's priorities over that level's padded rows.
    prios = [torch.as_tensor(np.array(jax.random.permutation(
        jax.random.PRNGKey(0), gr.num_vertices))) for gr in hj.graphs[:-1]]
    record = []
    ht, stats = gt.build_hierarchy_device(
        tg, spd_t, gt.MultigridConfig(**kw), priorities=prios, record=record)
    assert [s.n_coarse for s in stats] == [int(d.n_real) for d in diags]
    assert stats == [lv.stats for lv in ht.levels]
    assert all(set(gt.hierarchy.STAGES) < set(r) and r["sampling_rounds"] > 0
               for r in record) and len(record) == len(stats)
    jl = [lv._replace(stats=lv.stats._replace(
        n_fine=hj.graphs[0].num_vertices if i == 0 else int(diags[i - 1].n_real)))
        for i, lv in enumerate(hj.levels)]
    _compare_levels(hj._replace(levels=tuple(jl)), ht, 1e-5, 1e-5, 0.005)
    b = np.random.default_rng(0).normal(size=n).astype(np.float32)
    _, rel_j, it_j = g.mg_pcg(hc, jnp.asarray(b), g.MultigridConfig(**kw))
    _, rel_t, it_t = gt.mg_pcg(ht.solver, torch.as_tensor(b),
                               gt.MultigridConfig(**kw))
    assert rel_t <= 1e-8 and float(rel_j) <= 1e-8
    assert abs(it_t - int(it_j)) <= 1, (it_t, int(it_j))

    # The exact mode is build_hierarchy's hierarchy; too few priorities
    # for the levels raise.
    he, _ = gt.build_hierarchy_device(tg, spd_t, gt.MultigridConfig(**kw),
                                      exact_sampling=True)
    hx = gt.build_hierarchy(tg, spd_t, gt.MultigridConfig(**kw))
    assert all(torch.equal(a.samples, b_.samples)
               for a, b_ in zip(he.levels, hx.levels))
    try:
        gt.build_hierarchy_device(tg, spd_t, gt.MultigridConfig(**kw),
                                  priorities=prios[:1])
    except ValueError:
        pass
    else:
        raise AssertionError("one level's priorities built two levels")
