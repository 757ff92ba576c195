"""The hierarchy build against the sequential C++ coarsener, level by
level.

    python -m gravomg_tpu_torch.probes.build_check [N]   # N = 200000 by default

Builds the bench's recipe at N points on the card with
``build_hierarchy`` (the reference's sampling), in f64 and in f32, and
holds every level against ``csrc/gravomg_host.cpp::gmg_coarsen_level``:

  * f64: against ``build_hierarchy_host`` on the same graph, whole
    hierarchy: level sizes and samples equal, parents equal except at
    ties of the path length (1e-12 relative), coarse adjacency equal,
    coarse points and U rows (as sets of (column, weight)) at 1e-10;
  * f32: each level of the f32 hierarchy against the coarsener run in
    f64 on that level's own graph, so that one rounding flip does not
    put every coarser level out of reach: where the samples differ, how
    many, and the margin to the radius of the first vertex that differs
    (it must be a rounding near-tie, 1e-5 relative); else parents and
    adjacency rows that differ under 0.5% each, coarse points at 1e-5,
    U rows whose column sets differ or whose weights differ by more
    than 1e-5 under 0.5% together.

A mismatch beyond these raises.  ``chip_smoke.py`` runs the same check;
the CPU tests use :func:`u_rows_diff`.  Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from gravomg_tpu_torch.coarsen.graph import coarse_graph
from gravomg_tpu_torch.coarsen.parents import assign_parents
from gravomg_tpu_torch.coarsen.sampling import _prune_for_radius
from gravomg_tpu_torch.hierarchy import (build_hierarchy,
                                         build_hierarchy_host,
                                         coarsen_level_host)
from gravomg_tpu_torch.types import INVALID_INDEX, Graph

TOL = {torch.float64: {"weights": 1e-10, "tie": 1e-12, "flipped": 0.0},
       torch.float32: {"weights": 1e-5, "tie": 1e-5, "flipped": 0.005}}
_ABSENT = np.iinfo(np.int64).max


def _canonical_rows(cols: np.ndarray, weights: np.ndarray, zero: float):
    """U rows with equal columns merged, entries of at most ``zero``
    dropped and the rest ascending by column: ((V, 3) columns with
    ``_ABSENT`` in unused slots, (V, 3) f64 weights with 0 there)."""
    c = np.asarray(cols, np.int64)
    w = np.asarray(weights, np.float64)
    order = np.argsort(c, axis=1, kind="stable")
    c, w = np.take_along_axis(c, order, 1), np.take_along_axis(w, order, 1)
    for j in (1, 2):
        same = c[:, j] == c[:, j - 1]
        w[:, j] = np.where(same, w[:, j] + w[:, j - 1], w[:, j])
        w[:, j - 1] = np.where(same, 0.0, w[:, j - 1])
    keep = np.abs(w) > zero
    c, w = np.where(keep, c, _ABSENT), np.where(keep, w, 0.0)
    order = np.argsort(c, axis=1, kind="stable")
    return np.take_along_axis(c, order, 1), np.take_along_axis(w, order, 1)


def u_rows_diff(cols_a, weights_a, cols_b, weights_b, zero: float = 1e-12):
    """Two prolongations row by row as sets of (column, weight):
    ((V,) largest weight difference of each row, 0 where the column sets
    differ; (V,) bool of the rows whose column sets differ)."""
    ca, wa = _canonical_rows(cols_a, weights_a, zero)
    cb, wb = _canonical_rows(cols_b, weights_b, zero)
    flipped = np.any(ca != cb, axis=1)
    return np.where(flipped, 0.0, np.abs(wa - wb).max(axis=1)), flipped


def _rows_differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(rows,) bool: the ELL rows of ``a`` and ``b`` (ascending,
    INVALID_INDEX padding, any widths) that hold different columns."""
    width = max(a.shape[1], b.shape[1])

    def pad(x):
        return np.pad(x, ((0, 0), (0, width - x.shape[1])),
                      constant_values=INVALID_INDEX)

    return np.any(pad(a) != pad(b), axis=1)


def _tie_check(graph: Graph, level, host_parents: np.ndarray,
               differ: np.ndarray, rel_tol: float) -> int:
    """Of the vertices whose parent differs from the host's, how many
    are NOT ties: the host's parent must be as near along the graph as
    the port's, within ``rel_tol``.  The path lengths from the host's
    seeds of those vertices bound the host's from below."""
    idx = torch.as_tensor(np.nonzero(differ)[0], device=level.parents.device)
    _, own = assign_parents(graph, level.samples)
    seeds = torch.unique(level.samples.long()[
        torch.as_tensor(host_parents[differ].astype(np.int64),
                        device=idx.device)])
    _, other = assign_parents(graph, seeds)
    return int((other[idx] > own[idx] * (1.0 + rel_tol)).sum())


def _first_margin(graph: Graph, radius: float, vertex: int) -> float:
    """The least |d - radius| / radius over the 1-hop and 2-hop conflict
    candidates of ``vertex``, in f64: how near a rounding tie it is."""
    nbr, m, d = _prune_for_radius(
        graph._replace(distances=graph.distances.double()), float("inf"))
    row, ok = nbr[vertex], m[vertex]
    one = d[vertex][ok]
    two = (d[vertex][:, None] + d[row])[ok[:, None] & m[row]
                                        & (nbr[row] != vertex)]
    cand = torch.cat([one, two])
    return float(((cand - radius).abs() / radius).min())


def compare_level(graph: Graph, level, host: dict, exact: bool) -> dict:
    """One level of the port (``hierarchy.LevelData`` made from
    ``graph``) against the coarsener's arrays ``host`` of the same
    graph.  ``exact`` demands equal samples; otherwise differing samples
    end the level's comparison after the margin check.  Raises
    AssertionError beyond the tolerances of the graph's dtype."""
    tol = TOL[graph.points.dtype]
    n = graph.num_vertices
    out = {"n_fine": n, "n_coarse": level.stats.n_coarse,
           "host_n_coarse": int(host["samples"].shape[0])}
    mine = np.zeros(n, bool)
    mine[level.samples.cpu().numpy()] = True
    theirs = np.zeros(n, bool)
    theirs[host["samples"]] = True
    differ = mine != theirs
    out["samples_differ"] = int(differ.sum())
    if out["samples_differ"]:
        first = int(np.nonzero(differ)[0][0])
        out["first_margin"] = _first_margin(graph, level.stats.radius, first)
        if exact or out["first_margin"] > tol["tie"]:
            raise AssertionError(
                f"samples differ at {out['samples_differ']} of {n} "
                f"vertices, first at {first} with margin "
                f"{out['first_margin']:.3e} to the radius")
        return out

    limit = max(2, int(tol["flipped"] * n)) if tol["flipped"] else 0
    par_differ = level.parents.cpu().numpy() != host["parents"]
    out["parents_differ"] = int(par_differ.sum())
    out["parents_not_ties"] = (_tie_check(graph, level, host["parents"],
                                          par_differ, tol["tie"])
                               if out["parents_differ"] else 0)
    adj_differ = _rows_differ(level.coarse.neighbors.cpu().numpy(),
                              host["coarse_nbr"])
    out["adjacency_rows_differ"] = int(adj_differ.sum())
    cp, cp_h = level.coarse.points.cpu().numpy(), host["coarse_points"]
    scale = float(np.abs(cp_h).max())
    moved = np.abs(cp - cp_h).max(axis=1) / scale > tol["weights"]
    out["coarse_points_moved"] = int(moved.sum())
    err, flipped = u_rows_diff(level.u.cols.cpu().numpy(),
                               level.u.weights.cpu().numpy(),
                               host["u_cols"], host["u_weights"])
    # A row beyond the tolerance counts with the flipped ones: in f32 the
    # coarse points differ from the f64 coarsener's in their last digits,
    # which thin triangles amplify in the barycentric ratios.
    out["u_max_err"] = float(err.max())
    out["u_rows_flipped"] = int(flipped.sum())
    out["u_rows_beyond"] = int((err > tol["weights"]).sum())
    bad = []
    if out["parents_not_ties"] or (not exact
                                   and out["parents_differ"] > limit):
        bad.append("parents")
    if out["adjacency_rows_differ"] > limit:
        bad.append("coarse adjacency")
    if out["coarse_points_moved"] > limit:
        bad.append("coarse points")
    if out["u_rows_flipped"] + out["u_rows_beyond"] > limit:
        bad.append("U rows")
    if bad:
        raise AssertionError(f"level of {n} rows disagrees with the C++ "
                             f"coarsener in {bad}: {out}")
    return out


def _host_level(graph: Graph, cfg) -> dict:
    """The C++ coarsener on ``graph`` in f64."""
    return coarsen_level_host(graph.neighbors.cpu().numpy(),
                              graph.distances.double().cpu().numpy(),
                              graph.points.double().cpu().numpy(), cfg)


def check_build(graph: Graph, op, cfg) -> dict:
    """``build_hierarchy`` on ``graph`` (f32 on the card) in f64 and f32
    against the C++ coarsener, as the module's header says.  Returns the
    per-level comparison records, the case counts and the seconds."""
    out = {}
    g64 = coarse_graph(graph.neighbors, graph.points.double())
    op64 = op._replace(offdiag=op.offdiag.double(), diag=op.diag.double())
    for name, g, o in (("float64", g64, op64), ("float32", graph, op)):
        t0 = time.perf_counter()
        h = build_hierarchy(g, o, cfg)
        torch.cuda.synchronize()
        rec = {"build_s": time.perf_counter() - t0,
               "levels": [gr.num_vertices for gr in h.graphs],
               "stats": [ld.stats._asdict() for ld in h.levels]}
        if name == "float64":
            host_levels = []
            t0 = time.perf_counter()
            hh = build_hierarchy_host(g, o, cfg, levels_out=host_levels)
            rec["host_build_s"] = time.perf_counter() - t0
            rec["host_levels"] = [lv.op.num_vertices for lv in hh.levels]
            if rec["host_levels"] != rec["levels"]:
                raise AssertionError(f"level sizes {rec['levels']} against "
                                     f"the host's {rec['host_levels']}")
        else:
            host_levels = [_host_level(gr, cfg) for gr in h.graphs[:-1]]
        rec["compare"] = [
            compare_level(gr, ld, hl, exact=name == "float64")
            for gr, ld, hl in zip(h.graphs, h.levels, host_levels)]
        out[name] = rec
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("build_check: no CUDA device; this probe runs only on a card",
              file=sys.stderr)
        return 2
    from gravomg_tpu_torch.probes.mxu_levels import bench_problem
    n = int(argv[1]) if len(argv) > 1 else 200_000
    cfg, graph, op, _ = bench_problem(n)
    for name, rec in check_build(graph, op, cfg).items():
        print(json.dumps({"dtype": name, **rec}))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
