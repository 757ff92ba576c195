"""The plain reference (``benchmark/reference``): it imports nothing of
the port, of the JAX package or of JAX, and on a small torus it agrees
with dense NumPy: the symmetrised kNN graph, a dense solve and a dense
heat method."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.inputs import point_cloud  # noqa: E402
from benchmark.reference.graph import (knn_graph, laplacian,  # noqa: E402
                                       mean_edge_length, screened)
from benchmark.reference.heat import heat_distances  # noqa: E402
from benchmark.reference.solve import cg  # noqa: E402

CPU = torch.device("cpu")
POINTS = {"generator": "torus", "n": 1200, "r_major": 1.0, "r_minor": 0.35}


def _dense(op) -> np.ndarray:
    v = op.diag.shape[0]
    a = np.diag(op.diag.numpy())
    rows = np.repeat(np.arange(v), op.neighbors.shape[1])
    np.add.at(a, (rows, op.neighbors.numpy().ravel()),
              op.offdiag.numpy().ravel())
    return a


def _setup(seed=5, k=10):
    pts = point_cloud({**POINTS, "seed": seed})
    g = knn_graph(pts, k, CPU)
    lap, mass = laplacian(g)
    return pts, g, lap, mass


def test_bench_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference."
            "graph, benchmark.reference.solve, benchmark.reference.heat; "
            "import json; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert not top & {"gravomg_tpu_torch", "gravomg_tpu", "jax", "jaxlib"}


def test_bench_reference_graph_is_the_symmetrised_knn():
    pts, g, lap, mass = _setup()
    d = np.linalg.norm(pts[:, None, :].astype(np.float64)
                       - pts[None, :, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    knn = np.argsort(d, axis=1)[:, :10]
    adj = np.zeros(d.shape, bool)
    adj[np.repeat(np.arange(len(pts)), 10), knn.ravel()] = True
    adj |= adj.T
    nbr = g.neighbors.numpy()
    got = np.zeros_like(adj)
    rows = np.repeat(np.arange(len(pts)), nbr.shape[1])
    ok = nbr.ravel() >= 0
    got[rows[ok], nbr.ravel()[ok]] = True
    assert (got == adj).all()
    # Rows ascending, padding last; the Laplacian's rows sum to zero.
    for r in nbr[:50]:
        valid = r[r >= 0]
        assert (np.diff(valid) > 0).all() and (r[len(valid):] == -1).all()
    assert np.allclose(_dense(lap).sum(axis=1), 0.0, atol=1e-9)
    assert float(mean_edge_length(g)) > 0 and (mass > 0).all()


def test_bench_reference_cg_against_dense_solve():
    _, _, lap, mass = _setup()
    a = screened(lap, mass)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=(len(mass), 3)))
    x = cg(a, b).numpy()
    x_dense = np.linalg.solve(_dense(a), b.numpy())
    assert np.linalg.norm(x - x_dense) / np.linalg.norm(x_dense) < 1e-8


def test_bench_reference_heat_against_dense_heat():
    _, g, lap, mass = _setup()
    src = [3, 700]
    phi = heat_distances(g, src, 1.0).numpy()
    lmat, m = _dense(lap), mass.numpy()
    t = float(mean_edge_length(g)) ** 2
    nbr, dist = g.neighbors.numpy(), g.distances.numpy()
    valid = nbr >= 0
    safe = np.where(valid, nbr, 0)
    eps = 1e-4 * np.mean(np.diag(lmat)) / np.mean(m)
    for j, s in enumerate(src):
        rhs = np.zeros(len(m))
        rhs[s] = m[s]
        u = np.linalg.solve(np.diag(m) + t * lmat, rhs)
        x = np.where(valid, -np.sign((u[safe] - u[:, None]) / dist), 0.0)
        div = np.sum(np.where(valid, x / np.maximum(dist, 1e-8), 0.0),
                     axis=1)
        p = np.linalg.solve(lmat + eps * np.diag(m), div - div.mean())
        p = p[s] - p
        grad = np.where(valid, np.abs(p[safe] - p[:, None]) / dist, 0.0)
        p = p / (grad.sum() / valid.sum())
        assert np.linalg.norm(phi[:, j] - p) / np.linalg.norm(p) < 1e-7
