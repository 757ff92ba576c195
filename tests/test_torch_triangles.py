"""Voronoi triangles of the port against the JAX package and the NumPy
oracle on the same coarse graph: vertices, association lists and their
rotation slots equal; normals at 1e-12 (f64)."""

import numpy as np
import torch

from gravomg_tpu.geometry.meshes import icosphere, torus_points
from gravomg_tpu.types import INVALID_INDEX

import gravomg_tpu_torch as gt

import oracle
from test_torch_build_util import both_graphs, ell_rows_equal, jax_level

torch.set_num_threads(2)


def _jitter_sphere():
    sv, _ = icosphere(3)
    return sv + np.random.default_rng(7).normal(scale=1e-3, size=sv.shape)


def test_triangles_match_jax_and_oracle():
    for pts in (torus_points(2000, seed=13), _jitter_sphere()):
        gj, _ = both_graphs(pts)
        ref = jax_level(gj)
        cg = gt.graph_from_numpy(ref["columns"],
                                 np.asarray(ref["cg"].distances),
                                 ref["coarse_points"], device="cpu")
        tris = gt.construct_voronoi_triangles(cg)
        n = ref["n_tris"]
        jt = ref["tris"]
        assert tris.num_triangles == n and n > 0
        assert tris.vertices.dtype == torch.int32
        np.testing.assert_array_equal(tris.vertices.numpy(),
                                      np.asarray(jt.vertices)[:n])
        np.testing.assert_allclose(tris.normals.numpy(),
                                   np.asarray(jt.normals)[:n], rtol=1e-12,
                                   atol=1e-12)
        assert ell_rows_equal(tris.assoc.numpy(), jt.assoc)
        width = tris.assoc.shape[1]
        valid = tris.assoc.numpy() != INVALID_INDEX
        assert valid.any(axis=0).all()            # no empty column
        np.testing.assert_array_equal(
            tris.assoc_rot.numpy()[valid],
            np.asarray(jt.assoc_rot)[:, :width][valid])
        assert not tris.assoc_rot.numpy()[~valid].any()

        nc = ref["coarse_points"].shape[0]
        adj = [row[row != INVALID_INDEX] for row in ref["columns"]]
        tris_o, normals_o, assoc_o = oracle.voronoi_triangles(
            ref["coarse_points"], adj)
        np.testing.assert_array_equal(tris.vertices.numpy(),
                                      np.array(tris_o, np.int32))
        a = tris.assoc.numpy()
        for c in range(nc):
            np.testing.assert_array_equal(a[c][a[c] != INVALID_INDEX],
                                          np.array(assoc_o[c], np.int32))


def test_triangles_of_a_graph_without_any():
    """A path graph has no triangle: empty lists of one padding column."""
    nbr = torch.tensor([[1, INVALID_INDEX], [0, 2], [1, INVALID_INDEX]],
                       dtype=torch.int32)
    pts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]],
                       dtype=torch.float64)
    tris = gt.construct_voronoi_triangles(gt.coarse_graph(nbr, pts))
    assert tris.num_triangles == 0 and tris.normals.shape == (0, 3)
    assert tris.assoc.shape == (3, 1)
    assert bool((tris.assoc == INVALID_INDEX).all())
    assert not bool(tris.assoc_rot.any())
