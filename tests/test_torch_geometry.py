"""The rest of the port's front end against the JAX package on the same
numpy inputs.

kNN tables equal on 600 points (brute force, and the grid path on
21,000); ``graph_from_edges``, ``cotan_laplacian`` (1e-12, f64),
``to_edge_distance_graph`` (1e-12), ``extract_edges`` (equal), the
"gaussian" weighting (1e-12), ``scale_mesh`` (1e-12), and the mesh
generators array for array.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gravomg_tpu as g
from gravomg_tpu.geometry import meshes as jm

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry import meshes as tm

from test_torch_build_util import ell_rows_equal

torch.set_num_threads(2)


def _same_graph(tg, gj, tol=1e-12):
    assert ell_rows_equal(tg.neighbors.numpy(), gj.neighbors)
    w = min(tg.neighbors.shape[1], np.asarray(gj.neighbors).shape[1])
    m = tg.mask.numpy()[:, :w]
    np.testing.assert_allclose(tg.distances.numpy()[:, :w][m],
                               np.asarray(gj.distances)[:, :w][m], rtol=tol)
    assert np.all(np.isinf(tg.distances.numpy()[~tg.mask.numpy()]))


def test_knn_graphs_match_jax():
    v, f = jm.cube_mesh()
    pts = jm.random_points_on_mesh(600, v, f, seed=3)
    tp = torch.as_tensor(pts)
    idx = gt.knn_indices(tp, 10)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(g.geometry.knn.knn_indices(jnp.asarray(pts),
                                                           10)))
    tg = gt.knn_graph(tp, 10)
    assert tg.neighbors.shape == (600, 20)
    _same_graph(tg, g.knn_graph(jnp.asarray(pts), 10))
    # A hub vertex widens the table instead of overflowing it.
    assert gt.knn_graph(tp, 10, max_degree=4).neighbors.shape[1] >= 10
    assert gt.grid_knn_graph(tp, 10).neighbors.shape == (600, 20)

    # The grid path (more than 20,000 points), f32 as the bench feeds it.
    big = jm.torus_points(21000, seed=5).astype(np.float32)
    _same_graph(gt.grid_knn_graph(torch.as_tensor(big), 8),
                g.grid_knn_graph(jnp.asarray(big), 8), tol=1e-6)


def test_mesh_operators_and_generators_match_jax():
    for name, args in (("cube_mesh", ()), ("icosphere", (2,)),
                       ("grid_mesh", (5, 7))):
        for a, b in zip(getattr(tm, name)(*args), getattr(jm, name)(*args)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    v, f = tm.icosphere(3)
    np.testing.assert_array_equal(tm.random_points_on_mesh(50, v, f, seed=4),
                                  jm.random_points_on_mesh(50, v, f, seed=4))
    np.testing.assert_array_equal(tm.torus_points(40, seed=2),
                                  jm.torus_points(40, seed=2))
    edges = tm.mesh_edges(f)
    np.testing.assert_array_equal(edges, jm.mesh_edges(f))
    deg = tm.max_vertex_degree(f, len(v))
    assert deg == jm.max_vertex_degree(f, len(v)) == 6

    v = v + np.random.default_rng(7).normal(scale=1e-3, size=v.shape)
    tv, jv = torch.as_tensor(v), jnp.asarray(v)
    np.testing.assert_allclose(gt.scale_mesh(tv, 2.0).numpy(),
                               np.asarray(g.scale_mesh(jv, 2.0)), rtol=1e-12,
                               atol=1e-12)
    tg = gt.graph_from_edges(tv, torch.as_tensor(edges), deg)
    gj = g.graph_from_edges(jv, jnp.asarray(edges), deg)
    _same_graph(tg, gj)
    with pytest.raises(ValueError):
        gt.graph_from_edges(tv, torch.as_tensor(edges), deg - 1)

    lap, mass = gt.cotan_laplacian(tv, torch.as_tensor(f), deg)
    lap_j, mass_j = g.cotan_laplacian(jv, jnp.asarray(f), deg)
    np.testing.assert_array_equal(lap.neighbors.numpy(),
                                  np.asarray(lap_j.neighbors))
    for a, b in ((lap.offdiag, lap_j.offdiag), (lap.diag, lap_j.diag),
                 (mass, mass_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12)
    _same_graph(gt.to_edge_distance_graph(lap, tv),
                g.to_edge_distance_graph(lap_j, jv))
    for a, b in zip(gt.extract_edges(tg), g.extract_edges(gj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for sigma in (None, 0.3):
        lg, mg = gt.graph_laplacian(tg, "gaussian", sigma=sigma)
        lg_j, mg_j = g.graph_laplacian(gj, "gaussian", sigma=sigma)
        for a, b in ((lg.offdiag, lg_j.offdiag), (lg.diag, lg_j.diag),
                     (mg, mg_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-14)
