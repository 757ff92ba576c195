"""Parent assignment, coarse edges and coarse placement of the port
against the JAX package, on the same numpy graph and samples.

Tolerances: parents equal and path lengths at 1e-12 (f64; the sweeps do
the same additions); coarse edges row for row; placement at 1e-12 (the
cell sums add in another order); ``group_ordered`` and ``lexsort_pairs``
equal to JAX's and numpy's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from gravomg_tpu.ops.segment import group_ordered as jax_group_ordered
from gravomg_tpu.geometry.meshes import (cube_mesh, random_points_on_mesh,
                                         torus_points)

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.ops.segment import group_ordered, lexsort_pairs
from gravomg_tpu_torch.types import INVALID_INDEX

from test_torch_build_util import both_graphs, ell_rows_equal, jax_level

torch.set_num_threads(2)


def _stages(pts):
    gj, tg = both_graphs(pts)
    ref = jax_level(gj)
    samples = torch.as_tensor(ref["samples"])
    par, path = gt.assign_parents(tg, samples)
    return tg, ref, samples, par, path


def test_parents_match_jax():
    v, f = cube_mesh()
    for pts in (torus_points(2000, seed=13),
                random_points_on_mesh(600, v, f, seed=3)):
        _, ref, _, par, path = _stages(pts)
        assert par.dtype == torch.int32
        np.testing.assert_array_equal(par.numpy(), ref["parents"])
        np.testing.assert_allclose(path.numpy(), ref["path"], rtol=1e-12,
                                   atol=1e-12)

    # A vertex no seed reaches keeps parent 0 and an infinite path.
    nbr = torch.tensor([[1], [0], [INVALID_INDEX]], dtype=torch.int32)
    dist = torch.tensor([[1.0], [1.0], [float("inf")]], dtype=torch.float64)
    lonely = gt.Graph(nbr, dist, torch.zeros((3, 3), dtype=torch.float64))
    par, path = gt.assign_parents(lonely, torch.tensor([1]))
    assert par.tolist() == [0, 0, 0]
    assert path.tolist() == [1.0, 0.0, float("inf")]


def test_coarse_edges_and_placement_match_jax():
    tg, ref, samples, par, _ = _stages(torus_points(2000, seed=13))
    nc = samples.numel()
    cols = gt.extract_coarse_edges(tg, par, nc)
    assert cols.dtype == torch.int32
    assert ell_rows_equal(cols.numpy(), ref["columns"])
    # Width: the largest degree, or that rounded up to a multiple.
    deg = int((cols != INVALID_INDEX).sum(dim=1).max())
    assert cols.shape[1] == deg
    wide = gt.extract_coarse_edges(tg, par, nc, degree_multiple=8)
    assert wide.shape[1] == -(-max(deg, 4) // 8) * 8
    assert ell_rows_equal(wide.numpy(), cols.numpy())

    cp = gt.coarse_from_mean_of_fine_children(tg, par, samples)
    np.testing.assert_allclose(cp.numpy(), ref["coarse_points"], rtol=1e-12,
                               atol=1e-12)
    # The group-by primitives under them, on seeded triplets with
    # repeated rows and payloads.
    rng = np.random.default_rng(5)
    rows, pay = rng.integers(0, 40, 600), rng.integers(0, 1000, 600)
    valid = rng.uniform(size=600) < 0.8
    order = lexsort_pairs(torch.as_tensor(rows), torch.as_tensor(pay))
    np.testing.assert_array_equal(order.numpy(), np.lexsort((pay, rows)))
    table, counts = group_ordered(torch.as_tensor(rows), torch.as_tensor(pay),
                                  torch.as_tensor(valid), 40)
    jt, jc, ovf = jax_group_ordered(jnp.asarray(rows), jnp.asarray(pay),
                                    jnp.asarray(valid), 40, 64)
    assert not bool(ovf) and table.shape[1] == int(counts.max())
    assert ell_rows_equal(table.numpy(), jt)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))

    cg = gt.coarse_graph(cols, cp)
    jd = np.asarray(ref["cg"].distances)
    m = cols.numpy() != INVALID_INDEX
    np.testing.assert_allclose(cg.distances.numpy()[m],
                               jd[:, :cols.shape[1]][m], rtol=1e-12)
    assert np.all(np.isinf(cg.distances.numpy()[~m]))
