"""The front end of the eigenpairs deployment, on the CPU.

``screened_poisson_operator(graph, alpha="spectral")`` shifts L by the
``spectral_alpha`` of the graph (1e-6 relative: the two compute the same
float32 sums, and the shift reaches the diagonal through one product);
``"auto"`` and a number shift as before, and another name raises.

``grid_knn_graph_nosync`` widens its table past 2k where a symmetrised
degree needs it: four hubs, each the nearest point of the 12 vertices
of an icosahedron around it (jittered, so no distance ties), read a
degree of 12 at k = 3; the graph equals SciPy's k-d tree kNN,
symmetrised, row for row.  A torus cloud within 2k keeps the 2k-wide
table of the single ELL build it had before.
"""

import numpy as np
import torch
from scipy.spatial import cKDTree

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.apps.poisson import spectral_alpha
from gravomg_tpu_torch.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu_torch.geometry.meshes import icosphere, torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.ops.segment import build_ell_rows
from gravomg_tpu_torch.types import INVALID_INDEX

torch.set_num_threads(2)


def _torus(n, seed):
    pts = torus_points(n, seed=seed)
    return pts[morton_order(pts)].astype(np.float32)


def test_spectral_shift_matches_spectral_alpha():
    graph = grid_knn_graph_nosync(_torus(2000, 6), 12, margin=2.4,
                                  device="cpu")
    lap, mass = gt.graph_laplacian(graph, "invdist")
    alpha = spectral_alpha(graph)
    op, m = gt.screened_poisson_operator(graph, alpha="spectral")
    assert torch.equal(m, mass) and torch.equal(op.offdiag, lap.offdiag)
    want = lap.diag + alpha * mass
    assert float(((op.diag - want).abs() / want).max()) <= 1e-6

    auto, _ = gt.screened_poisson_operator(graph, alpha="auto")
    shift = 1e-4 * torch.mean(lap.diag) / torch.mean(mass)
    assert torch.equal(auto.diag, lap.diag + shift * mass)
    half, _ = gt.screened_poisson_operator(graph, alpha=0.5)
    assert torch.equal(half.diag, lap.diag + 0.5 * mass)
    try:
        gt.screened_poisson_operator(graph, alpha="cotan")
    except ValueError as e:
        assert "unknown alpha mode" in str(e)
    else:
        raise AssertionError("an unknown shift mode was accepted")


def _scipy_rows(pts, k):
    """Each point's neighbour set in SciPy's kNN, symmetrised."""
    _, idx = cKDTree(pts.astype(np.float64)).query(pts, k=k + 1)
    rows = [set() for _ in range(len(pts))]
    for i, row in enumerate(idx):
        for j in row:
            if j != i:
                rows[i].add(int(j))
                rows[int(j)].add(i)
    return rows


def test_grid_knn_widens_past_2k():
    ico, _ = icosphere(0)
    ico = ico / np.linalg.norm(ico, axis=1, keepdims=True)
    rng = np.random.default_rng(3)
    parts = []
    for c in range(4):
        hub = np.array([3.0 * c, 0.3 * c, 0.0])
        parts += [hub[None], hub + ico + rng.normal(scale=2e-3,
                                                    size=ico.shape)]
    pts = np.concatenate(parts).astype(np.float32)
    k = 3
    graph = grid_knn_graph_nosync(pts, k, device="cpu")
    nbr = graph.neighbors.numpy()
    valid = nbr != INVALID_INDEX
    assert nbr.shape[1] == 12 > 2 * k
    assert valid.sum(axis=1).max() == 12
    for i, want in enumerate(_scipy_rows(pts, k)):
        got = nbr[i][valid[i]]
        assert list(got) == sorted(want), i
        d = np.linalg.norm(pts[got] - pts[i], axis=1)
        np.testing.assert_allclose(graph.distances.numpy()[i][valid[i]], d,
                                   rtol=1e-6)
        assert np.isinf(graph.distances.numpy()[i][~valid[i]]).all()

    # Within 2k: the table the 2k-wide ELL build gives, bit for bit.
    pts = _torus(3000, 31)
    k = 12
    graph = grid_knn_graph_nosync(pts, k, margin=2.4, device="cpu")
    assert graph.neighbors.shape == (3000, 2 * k)
    _, idx = cKDTree(pts.astype(np.float64)).query(pts, k=k + 1)
    rows = torch.arange(3000, dtype=torch.int32).repeat_interleave(k)
    cols = torch.as_tensor(idx[:, 1:].reshape(-1), dtype=torch.int32)
    ones = torch.ones_like(rows, dtype=torch.bool)
    old = build_ell_rows(torch.cat([rows, cols]), torch.cat([cols, rows]),
                         torch.cat([ones, ones]), 3000, 2 * k)
    assert not old.overflow
    assert torch.equal(graph.neighbors, old.columns)
