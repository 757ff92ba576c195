"""Shared by the port's build parity tests: one numpy cloud as a JAX
graph and as the port's graph, and one coarsening step of the JAX
package on it."""

import jax.numpy as jnp
import numpy as np

import gravomg_tpu as g
from gravomg_tpu.types import INVALID_INDEX

import gravomg_tpu_torch as gt


def both_graphs(pts, k=10, dtype=np.float64):
    """(JAX graph, port graph on the CPU) of the kNN graph of ``pts``,
    distances and points cast to ``dtype``."""
    gj = g.knn_graph(jnp.asarray(pts), k=k)
    gj = g.Graph(gj.neighbors, gj.distances.astype(dtype),
                 gj.points.astype(dtype))
    tg = gt.graph_from_numpy(np.asarray(gj.neighbors),
                             np.asarray(gj.distances),
                             np.asarray(gj.points), device="cpu")
    return gj, tg


def jax_level(gj, scheme=g.BARYCENTRIC):
    """One coarsening step of the JAX package on ``gj``, stage by stage:
    a dict of its arrays (numpy, real triangles only) and the JAX coarse
    graph and triangle set."""
    radius = float(g.sampling_radius(gj))
    sel = g.fast_disc_sample(gj, radius)
    par, pdist = g.assign_parents(gj, jnp.asarray(sel))
    nc = len(sel)
    cols, ovf = g.extract_coarse_edges(gj, par, nc, 64)
    assert not bool(ovf)
    cp = g.coarse_from_mean_of_fine_children(gj, par, jnp.asarray(sel))
    cg = g.coarse_graph(cols, cp)
    tris, t_ovf = g.construct_voronoi_triangles(cg, 8 * nc, 256)
    assert not bool(t_ovf)
    n_tris = int(np.sum(np.asarray(tris.vertices)[:, 0] != INVALID_INDEX))
    return {"radius": radius, "samples": np.asarray(sel),
            "parents": np.asarray(par), "path": np.asarray(pdist),
            "columns": np.asarray(cols), "coarse_points": np.asarray(cp),
            "n_tris": n_tris, "cg": cg, "tris": tris}


def ell_rows_equal(a, b):
    """ELL tables of any widths hold the same columns row for row."""
    a, b = np.asarray(a), np.asarray(b)
    width = max(a.shape[1], b.shape[1])
    pad = lambda x: np.pad(x, ((0, 0), (0, width - x.shape[1])),  # noqa: E731
                           constant_values=INVALID_INDEX)
    return np.array_equal(pad(a), pad(b))
