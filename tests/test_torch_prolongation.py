"""Prolongation assembly of the port against the JAX package and the
sequential NumPy oracle, on the same discrete hierarchy.

Tolerances.  f64, all three schemes: rows equal as {column: weight} at
1e-12 against JAX (``affine="off"``: the sequential formula) and the
oracle, case counts equal, ``projected_points`` at 1e-12.  f32 against
JAX at 1e-5 with under 0.5% of the rows flipped (a borderline
containment test may go the other way in another summation order);
``precise_weights`` at 1e-6 against the f64 oracle on the same f32
hierarchy.
"""

import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.geometry.meshes import torus_points
from gravomg_tpu.types import INVALID_INDEX

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.probes.build_check import u_rows_diff

import oracle
from test_torch_build_util import both_graphs, jax_level

torch.set_num_threads(2)
N = 2000


def _level(dtype):
    pts = torus_points(N, seed=13)
    gj, tg = both_graphs(pts, dtype=dtype)
    ref = jax_level(gj)
    jt = ref["tris"]
    n = ref["n_tris"]
    tris = gt.TriangleSet(
        *(torch.as_tensor(np.array(a)) for a in (
            np.asarray(jt.vertices)[:n], np.asarray(jt.normals)[:n],
            jt.assoc, jt.assoc_rot)))
    args_t = (tg.points, *(torch.as_tensor(np.array(ref[k])) for k in (
        "parents", "coarse_points", "columns")), tris)
    args_j = (gj.points, jnp.asarray(ref["parents"]),
              jnp.asarray(ref["coarse_points"]), ref["cg"].neighbors, jt)
    return ref, args_t, args_j


def _oracle_rows(ref, pts, scheme):
    adj = [row[row != INVALID_INDEX] for row in ref["columns"]]
    cp = np.asarray(ref["coarse_points"], np.float64)
    tris_o, normals_o, assoc_o = oracle.voronoi_triangles(cp, adj)
    rows, counts = oracle.construct_prolongation(
        np.asarray(pts, np.float64), ref["parents"], cp, adj, tris_o,
        normals_o, assoc_o, scheme)
    cols = np.zeros((len(rows), 3), np.int64)
    wts = np.zeros((len(rows), 3))
    for i, row in rows.items():
        for j, (c, w) in enumerate(row):
            cols[i, j], wts[i, j] = c, w
        cols[i, len(row):] = row[0][0]
    return cols, wts, counts, rows, cp


def test_prolongation_f64_matches_jax_and_oracle():
    ref, args_t, args_j = _level(np.float64)
    pts = args_t[0].numpy()
    for scheme in (gt.BARYCENTRIC, gt.UNIFORM, gt.INVDIST):
        u, counts = gt.construct_prolongation(*args_t, scheme=scheme)
        assert u.cols.dtype == torch.int32 and u.n_coarse == len(
            ref["samples"])
        uj, counts_j, _ = g.construct_prolongation(*args_j, scheme=scheme,
                                                   affine="off")
        assert counts.tolist() == np.asarray(counts_j).tolist()
        err, flipped = u_rows_diff(u.cols.numpy(), u.weights.numpy(),
                                   np.asarray(uj.cols),
                                   np.asarray(uj.weights))
        assert not flipped.any() and err.max() < 1e-12, (scheme, err.max())
        oc, ow, counts_o, rows_o, cp = _oracle_rows(ref, pts, scheme)
        assert counts.tolist() == list(counts_o)
        err, flipped = u_rows_diff(u.cols.numpy(), u.weights.numpy(), oc, ow)
        assert not flipped.any() and err.max() < 1e-12, (scheme, err.max())
        if scheme == gt.BARYCENTRIC:
            assert counts[1] > 0 and counts.sum() <= N  # fallbacks are hit
            proj = gt.projected_points(u, args_t[2]).numpy()
            np.testing.assert_allclose(
                proj, oracle.projected_points(rows_o, cp, N), rtol=1e-12,
                atol=1e-12)
            np.testing.assert_allclose(
                proj, np.asarray(g.projected_points(uj, args_j[2])),
                rtol=1e-12, atol=1e-12)


def test_prolongation_f32_and_precise_weights():
    ref, args_t, args_j = _level(np.float32)
    u, counts = gt.construct_prolongation(*args_t)
    assert u.weights.dtype == torch.float32
    uj, counts_j, _ = g.construct_prolongation(*args_j, affine="off")
    err, flipped = u_rows_diff(u.cols.numpy(), u.weights.numpy(),
                               np.asarray(uj.cols), np.asarray(uj.weights))
    assert err.max() < 1e-5 and flipped.sum() <= max(2, N // 200)
    assert np.abs(counts.numpy() - np.asarray(counts_j)).max() <= N // 200

    up, _ = gt.construct_prolongation(*args_t, precise_weights=True)
    assert up.weights.dtype == torch.float32
    oc, ow, _, _, _ = _oracle_rows(ref, args_t[0].numpy(), gt.BARYCENTRIC)
    err_p, flip_p = u_rows_diff(up.cols.numpy(), up.weights.numpy(), oc, ow)
    err_32, flip_32 = u_rows_diff(u.cols.numpy(), u.weights.numpy(), oc, ow)
    assert err_p.max() < 1e-6 and err_32.max() < 1e-5
    assert max(flip_p.sum(), flip_32.sum()) <= max(2, N // 200)
