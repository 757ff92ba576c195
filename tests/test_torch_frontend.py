"""PyTorch port vs the JAX package on the bench's front end at a small
size: the torus and Morton copies, and the grid kNN graph of a 3,000-point
Morton-ordered torus.

Tolerances: the copies are exact; the ELL grouping's tables exact and
its merged f64 values at rtol 1e-12; kNN neighbour tables equal (rows
may differ only at tied kth distances) and distances within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu.geometry.gridknn import grid_knn_graph_nosync as jax_knn
from gravomg_tpu.geometry.meshes import torus_points as jax_torus
from gravomg_tpu.geometry.order import morton_order as jax_morton
from gravomg_tpu.ops.segment import build_ell_rows as jax_build_ell_rows

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.ops.segment import build_ell_rows

torch.set_num_threads(2)


def test_torus_and_morton_copies_match_jax():
    p = torus_points(500, seed=3)
    np.testing.assert_array_equal(p, jax_torus(500, seed=3))
    np.testing.assert_array_equal(morton_order(p), jax_morton(p))


def test_grid_knn_matches_jax():
    """The ELL grouping the graph is symmetrised through, then the
    graph."""
    rng = np.random.default_rng(6)
    rows, cols = rng.integers(0, 30, 400), rng.integers(0, 30, 400)
    valid, vals = rng.random(400) < 0.8, rng.normal(size=400)
    for k, combine in ((16, "add"), (16, "min"), (4, "add")):
        rt = build_ell_rows(*map(torch.as_tensor, (rows, cols, valid)), 30,
                            k, values=torch.as_tensor(vals), combine=combine)
        rj = jax_build_ell_rows(*map(jnp.asarray, (rows, cols, valid)), 30,
                                k, values=jnp.asarray(vals), combine=combine)
        assert rt.overflow == bool(rj.overflow) == (k == 4)
        np.testing.assert_array_equal(rt.columns.numpy(), rj.columns)
        np.testing.assert_array_equal(rt.counts.numpy(), rj.counts)
        np.testing.assert_allclose(rt.values.numpy(), rj.values, rtol=1e-12)

    pts = torus_points(3000, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    gj, short = jax_knn(pts, 16, margin=2.4)
    assert not bool(short)
    gtorch = gt.grid_knn_graph_nosync(pts, 16, margin=2.4, device="cpu")
    nj, nt = np.asarray(gj.neighbors), gtorch.neighbors.numpy()
    dj, dt = np.asarray(gj.distances), gtorch.distances.numpy()
    assert nj.shape == nt.shape
    same = (nj == nt).all(axis=1)
    for i in np.nonzero(~same)[0]:
        np.testing.assert_allclose(np.sort(dt[i]), np.sort(dj[i]),
                                   atol=1e-6)
    assert same.mean() > 0.99
    fin = np.isfinite(dj)
    assert (fin == np.isfinite(dt)).all()
    np.testing.assert_allclose(dt[fin], dj[fin], atol=1e-6)
