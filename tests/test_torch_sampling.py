"""Disc sampling of the port against the JAX package and the sequential
NumPy oracle, on the same numpy graphs.

Tolerances: the radius at 1e-12 relative (f64; the mean is summed in
another order); the exact mask ``array_equal`` to JAX's
``fast_disc_sample_mask`` and to ``oracle.disc_sample``; the priority
sampler, fed JAX's own permutation, ``array_equal`` to
``fast_disc_sample_chained`` (f32 graph on both sides, Morton-ordered as
JAX's gather-free operators need); with its own generator, a maximal
independent set of the conflict relation (checked against JAX's
``conflict_ell`` table).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.coarsen.sampling import (conflict_ell,
                                          fast_disc_sample_chained)
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.geometry.order import morton_order

import gravomg_tpu_torch as gt

import oracle

torch.set_num_threads(2)


def _graphs(n, seed, k=10, dtype=np.float64, ordered=False):
    pts = torus_points(n, seed=seed)
    if ordered:
        pts = pts[morton_order(pts)]
    gj = g.knn_graph(jnp.asarray(pts), k=k)
    gj = g.Graph(gj.neighbors, gj.distances.astype(dtype),
                 gj.points.astype(dtype))
    tg = gt.graph_from_numpy(np.asarray(gj.neighbors),
                             np.asarray(gj.distances),
                             np.asarray(gj.points), device="cpu")
    return pts, gj, tg


def test_exact_sampling_matches_jax_and_oracle():
    for n, seed in ((500, 11), (2000, 13)):
        pts, gj, tg = _graphs(n, seed)
        r_j = float(g.sampling_radius(gj))
        r_t = float(gt.sampling_radius(tg))
        assert abs(r_t - r_j) <= 1e-12 * r_j
        assert abs(float(gt.average_edge_length(tg))
                   - float(g.average_edge_length(gj))) <= 1e-12 * r_j
        mask = gt.fast_disc_sample_mask(tg, r_j).numpy()
        np.testing.assert_array_equal(
            mask, np.asarray(g.fast_disc_sample_mask(gj, r_j)))
        sel = gt.fast_disc_sample(tg, r_j)
        assert sel.dtype == torch.int32
        np.testing.assert_array_equal(
            sel.numpy(), oracle.disc_sample(pts, np.asarray(gj.neighbors),
                                            np.asarray(gj.distances), r_j))
        np.testing.assert_array_equal(
            gt.fast_disc_sample(tg, r_j, max_samples=7).numpy(),
            sel.numpy()[:7])


def test_priority_sampling_matches_jax_chained_and_is_mis():
    n = 2000
    _, gj, tg = _graphs(n, 13, k=12, dtype=np.float32, ordered=True)
    r = g.sampling_radius(gj)
    m_j, invalid = fast_disc_sample_chained(gj, r, seed=3)
    assert not bool(invalid)
    perm = np.array(jax.random.permutation(jax.random.PRNGKey(3), n))
    m_t = gt.fast_disc_sample_priority(tg, float(r),
                                       priorities=torch.as_tensor(perm))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))

    # Its own generator: deterministic, and a maximal independent set of
    # the conflict relation.
    def own():
        gen = torch.Generator().manual_seed(5)
        return gt.fast_disc_sample_priority(tg, float(r),
                                            generator=gen).numpy()

    m = own()
    np.testing.assert_array_equal(m, own())
    assert 0 < m.sum() < n and not np.array_equal(m, np.asarray(m_j))
    cols, cmask, ovf = conflict_ell(gj, r, gj.max_degree, 192,
                                    lower_only=False)
    assert not bool(ovf)
    cols, cmask = np.asarray(cols), np.asarray(cmask)
    hit = np.any(m[np.where(cmask, cols, 0)] & cmask, axis=1)
    assert not np.any(m & hit)            # independent
    assert np.all(m | hit)                # maximal

    bad = torch.as_tensor(perm).clone()
    bad[1] = bad[0]
    for wrong in (bad, torch.as_tensor(perm[:-1]), torch.rand(n)):
        try:
            gt.fast_disc_sample_priority(tg, float(r), priorities=wrong)
        except ValueError:
            continue
        raise AssertionError("invalid priorities were accepted")
