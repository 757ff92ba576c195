"""The port's MG-preconditioned LOBPCG against the JAX package's and a
dense eigensolve, on a noisy icosphere (162 vertices, kNN k=8), f64.

One step from the same x and p on the same hierarchy (the port's,
carried to JAX through the npz layout): the residual norms at 1e-10;
the search block (each column's sign aligned: the W and P blocks are
whitened by an eigh) and the Grams at 1e-9 of their largest entry (the
test says why not 1e-10); the Ritz values at 1e-8 of the largest, and
the M-projector onto the new Ritz block at 1e-8 (Ritz vectors are not
compared column by column: eigh's signs differ between LAPACK paths, and
the sphere's eigenvalues come in clusters whose vectors are arbitrary
within the cluster).
``spectral_alpha`` at 1e-6 relative.

The whole ``laplace_eigs`` against scipy's dense eigh of the pencil, with
the checks of tests/test_apps.py: the nullspace below 1e-5 of lam_k,
the others at 1e-3 relative, the pencil residual below 1e-3; and on a
hierarchy passed in, an M-orthonormal block to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import scipy.linalg as sla
import torch

import gravomg_tpu as g
from gravomg_tpu.apps import spectral as jsp
from gravomg_tpu.geometry.meshes import icosphere
from gravomg_tpu.io.serialization import load_solver as jax_load_solver

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.apps import spectral as tsp
from gravomg_tpu_torch.io.serialization import solver_to_numpy

torch.set_num_threads(2)

CFG = dict(coarse_threshold=64, smoother="chebyshev")


def _sphere(seed):
    """(JAX graph, port graph) of one noisy icosphere, from the port's
    kNN graph."""
    v, _ = icosphere(2)
    pts = v + np.random.default_rng(seed).normal(scale=1e-3, size=v.shape)
    tg = gt.knn_graph(torch.as_tensor(pts), k=8)
    return g.Graph(*(jnp.asarray(t.numpy()) for t in tg)), tg


def _projector(x, mass):
    return x @ x.T * mass[None, :]


def test_lobpcg_step_and_alpha_match_jax(tmp_path):
    gj, tg = _sphere(31)
    alpha_t = float(tsp.spectral_alpha(tg))
    assert abs(alpha_t - float(jsp.spectral_alpha(gj))) <= 1e-6 * alpha_t
    tc = gt.MultigridConfig(**CFG)
    ht = gt.poisson_hierarchy(tg, alpha=alpha_t, cfg=tc).solver
    path = tmp_path / "sphere.npz"
    np.savez(path, **solver_to_numpy(ht))
    hj = jax_load_solver(str(path))

    lap_t, mass_t = gt.graph_laplacian(tg, "invdist")
    lap_j, mass_j = g.graph_laplacian(gj, "invdist")
    rng = np.random.default_rng(32)
    k, n = 4, tg.num_vertices
    x0 = rng.normal(size=(n, k))
    x0[:, 0] = 1.0
    x = tsp._b_orthonormalize(mass_t, torch.as_tensor(x0))
    p = torch.as_tensor(rng.normal(size=(n, k)))
    sj, gaj, gbj, rj = (np.asarray(a) for a in jsp._lobpcg_block(
        hj, lap_j, mass_j, jnp.asarray(x.numpy()), jnp.asarray(p.numpy()),
        g.MultigridConfig(**CFG), True))
    st, gat, gbt, rt = tsp._lobpcg_block(ht, lap_t, mass_t, x, p, tc, True)
    assert st.shape == (n, 3 * k) and gat.dtype == torch.float64
    # W and P are whitened by an eigh of their Gram, whose vectors' signs
    # are the LAPACK path's choice: align each column's sign first.
    sign = np.sign(np.sum(st.numpy() * sj, axis=0))
    assert np.all(sign[:k] == 1.0) and np.all(sign != 0.0)
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-10)
    # 1e-9, not 1e-10: the whitening scales a direction by 1/sqrt of its
    # Gram eigenvalue, and the constants column's residual is rounding
    # noise, so W's Gram has an eigenvalue of 3.5e-5 (just above
    # _RANK_TOL of its largest, 6.8): the two packages' last-digit
    # differences (the V-cycles agree to 7e-16) grow to 1.9e-10 in S and
    # 1.2e-10 in the Grams.  The Ritz values agree to 2e-13.
    np.testing.assert_allclose(st.numpy() * sign, sj, rtol=0,
                               atol=1e-9 * np.abs(sj).max())
    flip = sign[:, None] * sign[None, :]
    for a, b in ((gat, gaj), (gbt, gbj)):
        np.testing.assert_allclose(a.numpy() * flip, b, rtol=0,
                                   atol=1e-9 * np.abs(b).max())

    theta_j, yj = jsp._rayleigh_ritz_host(gaj, gbj, k)
    theta_t, yt = tsp._rayleigh_ritz_host(gat, gbt, k)
    assert theta_t.device.type == "cpu" and theta_t.dtype == torch.float64
    # Relative to the largest: the nullspace value is rounding (~1e-14).
    np.testing.assert_allclose(theta_t.numpy(), theta_j, rtol=0,
                               atol=1e-8 * np.abs(theta_j).max())
    mass = mass_t.numpy()
    pj = _projector(sj @ yj, mass)
    pt = _projector(tsp._lobpcg_update(st, yt, k)[0].numpy(), mass)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-8 * np.abs(pj).max())


def _dense_pencil(lap, mass):
    n = lap.num_vertices
    dense = np.zeros((n, n))
    nb, w, msk = lap.neighbors.numpy(), lap.offdiag.numpy(), lap.mask.numpy()
    for i in range(n):
        dense[i, nb[i][msk[i]]] = w[i][msk[i]]
    dense[np.arange(n), np.arange(n)] = lap.diag.numpy()
    return dense, mass.numpy()


def test_laplace_eigs_match_dense_oracle():
    _, tg = _sphere(33)
    tc = gt.MultigridConfig(**CFG)
    k = 6
    record = {}
    lams, vecs, res = gt.laplace_eigs(tg, k=k, cfg=tc, iters=60, tol=1e-7,
                                      record=record)
    assert 0 < record["iters"] == len(record["steps"]) <= 60
    assert set(record["steps"][0]) == {"block_s", "rr_s"}
    dense, mass = _dense_pencil(*gt.graph_laplacian(tg, "invdist"))
    ref = sla.eigh(dense, np.diag(mass), eigvals_only=True,
                   subset_by_index=[0, k - 1])
    lams, vecs = lams.numpy(), vecs.numpy()
    assert abs(lams[0]) < 1e-5 * ref[k - 1]
    assert abs(ref[0]) < 1e-9 * ref[k - 1]
    assert (np.abs(lams[1:] - ref[1:]) / ref[1:]).max() < 1e-3, (lams, ref)
    lres = dense @ vecs - mass[:, None] * vecs * lams[None, :]
    assert np.linalg.norm(lres, axis=0).max() < 1e-3
    # The start block comes from the generator: seeded, repeatable.
    gen = torch.Generator().manual_seed(0)
    again, _, _ = gt.laplace_eigs(tg, k=k, cfg=tc, iters=60, tol=1e-7,
                                  generator=gen)
    assert np.array_equal(again.numpy(), lams)

    # On a hierarchy passed in (alpha 0.5, Jacobi), as test_apps.py does.
    jc = gt.MultigridConfig(coarse_threshold=64)
    h = gt.poisson_hierarchy(tg, alpha=0.5, cfg=jc)
    _, vecs, res = gt.laplace_eigs(tg, k=4, cfg=jc, h=h, iters=40)
    assert float(res[1:].max()) < 1e-4
    vecs = vecs.numpy()
    assert np.abs(vecs.T @ (mass[:, None] * vecs) - np.eye(4)).max() < 1e-4
