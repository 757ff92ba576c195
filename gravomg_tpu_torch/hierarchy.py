"""Multigrid hierarchy construction (counterpart of
``gravomg_tpu/hierarchy.py`` and ``gravomg_tpu/hierarchy_static.py``).

Per level, as the reference demo runs it: radius from the mean edge
length, fast disc sampling, parent assignment, coarse edges, coarse
point placement, Voronoi triangles, prolongation, Galerkin product.
Every stage is plain torch on the device of the input graph, and every
array is sized from the data between stages, so a level holds real
vertices only: no phantom rows, no caps and no overflow flags.

:func:`build_hierarchy` samples as the reference's greedy scan does,
:func:`build_hierarchy_device` by random priorities unless asked for
the exact scan.  :func:`build_hierarchy_host` runs the sequential C++
coarsener on the host instead and is the cross-check of the two.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gravomg_tpu_torch.coarsen.graph import coarse_graph, extract_coarse_edges
from gravomg_tpu_torch.coarsen.parents import assign_parents
from gravomg_tpu_torch.coarsen.placement import \
    coarse_from_mean_of_fine_children
from gravomg_tpu_torch.coarsen.sampling import (disc_sample_rounds,
                                                priority_ranks,
                                                sampling_radius)
from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.io import native
from gravomg_tpu_torch.prolong.operator import construct_prolongation
from gravomg_tpu_torch.prolong.triangles import construct_voronoi_triangles
from gravomg_tpu_torch.solve.coarse import factor_coarse
from gravomg_tpu_torch.solve.rap import galerkin_rap
from gravomg_tpu_torch.solve.smoothers import ChebyshevParams
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            attach_restrictions)
from gravomg_tpu_torch.types import (INVALID_INDEX, EllOperator, Graph,
                                     HierarchyStats, Prolongation,
                                     TriangleSet)
from gravomg_tpu_torch.utils.profiling import stage


class LevelData(NamedTuple):
    """Full record of one coarsening step (fine -> coarse)."""
    samples: torch.Tensor        # (C,) int32 fine ids of the coarse seeds
    parents: torch.Tensor        # (Vf,) int32
    coarse: Graph                # the coarse level's graph
    triangles: TriangleSet       # of the coarse graph
    u: Prolongation
    stats: HierarchyStats


class Hierarchy(NamedTuple):
    """Geometric hierarchy and the solver-ready operator stack."""
    graphs: Tuple[Graph, ...]            # per level, finest first
    levels: Tuple[LevelData, ...]        # len == len(graphs) - 1
    solver: SolverHierarchy


class DegenerateHierarchyError(RuntimeError):
    """A level's prolongation is dominated by point fallbacks: the
    checked form of the reference's ``assert(fallbackCount / n_fine <
    0.5)``."""


STAGES = ("sampling", "parents", "edges", "placement", "triangles",
          "prolongation", "rap")


def coarsen_once(graph: Graph, cfg: MultigridConfig,
                 scheme: Optional[int] = None,
                 ranks: Optional[torch.Tensor] = None,
                 record: Optional[dict] = None) -> Optional[LevelData]:
    """One full coarsening step, or None if the graph no longer coarsens
    (fewer than 8 coarse points, or no reduction).

    ``ranks`` orders the sampling (:func:`disc_sample_rounds`; None is
    the reference's index order).  ``record`` (a dict) receives the
    seconds of each stage and the sampling's round count.
    """
    scheme = cfg.weighting if scheme is None else scheme
    dev = graph.neighbors.device
    with stage(record, "sampling", dev):
        radius = sampling_radius(graph, cfg.reduction_ratio)
        mask, rounds = disc_sample_rounds(graph, radius, ranks)
        samples = torch.nonzero(mask).reshape(-1).to(torch.int32)
    if record is not None:
        record["sampling_rounds"] = rounds
    n_coarse = samples.numel()
    if n_coarse < 8 or n_coarse >= graph.num_vertices:
        return None
    with stage(record, "parents", dev):
        parents, _ = assign_parents(graph, samples)
    with stage(record, "edges", dev):
        columns = extract_coarse_edges(graph, parents, n_coarse,
                                       cfg.degree_multiple)
    with stage(record, "placement", dev):
        cg = coarse_graph(columns, coarse_from_mean_of_fine_children(
            graph, parents, samples))
    with stage(record, "triangles", dev):
        triangles = construct_voronoi_triangles(cg)
    with stage(record, "prolongation", dev):
        u, counts = construct_prolongation(
            graph.points, parents, cg.points, cg.neighbors, triangles,
            scheme=scheme)
        hits, edges, fallbacks = counts.tolist()
    stats = HierarchyStats(
        n_fine=graph.num_vertices, n_coarse=n_coarse,
        n_triangles=triangles.num_triangles, triangle_hits=hits,
        edge_fallbacks=edges, point_fallbacks=fallbacks,
        radius=float(radius))
    return LevelData(samples=samples, parents=parents, coarse=cg,
                     triangles=triangles, u=u, stats=stats)


def _build(graph: Graph, fine_op: EllOperator, cfg: MultigridConfig,
           level_ranks, validate: bool,
           record: Optional[list]) -> Hierarchy:
    """The level loop that both build functions share; ``level_ranks(level, graph)``
    gives the sampling order of a level (None: the index order)."""
    dev = graph.neighbors.device
    graphs: List[Graph] = [graph]
    level_data: List[LevelData] = []
    ops: List[EllOperator] = [fine_op]
    for _ in range(cfg.max_levels - 1):
        g = graphs[-1]
        if g.num_vertices <= cfg.coarse_threshold:
            break
        rec = None if record is None else {}
        ld = coarsen_once(g, cfg, ranks=level_ranks(len(level_data), g),
                          record=rec)
        if ld is None:
            break
        frac = ld.stats.point_fallbacks / max(ld.stats.n_fine, 1)
        if validate and frac >= 0.5:
            raise DegenerateHierarchyError(
                f"level {len(level_data)}: {frac:.0%} of fine points used "
                f"the nearest-point fallback (stats: {ld.stats!r}); the "
                f"coarse graph is too disconnected for barycentric "
                f"prolongation")
        with stage(rec, "rap", dev):
            ops.append(galerkin_rap(ops[-1], ld.u, cfg.degree_multiple))
        if record is not None:
            record.append(rec)
        level_data.append(ld)
        graphs.append(ld.coarse)
    return Hierarchy(graphs=tuple(graphs), levels=tuple(level_data),
                     solver=_solver(ops, [ld.u for ld in level_data], cfg))


def _solver(ops: Sequence[EllOperator], us: Sequence[Prolongation],
            cfg: MultigridConfig) -> SolverHierarchy:
    """The solver hierarchy of an operator stack: Chebyshev bounds (if
    ``cfg.smoother == "chebyshev"``), the U^T tables and the coarsest
    level's Cholesky factor."""
    levels = []
    for i, o in enumerate(ops):
        cheb = (ChebyshevParams.from_operator(o, cfg.chebyshev_ratio)
                if cfg.smoother == "chebyshev" else None)
        levels.append(SolverLevel(op=o, u=us[i] if i < len(us) else None,
                                  cheb=cheb))
    return attach_restrictions(SolverHierarchy(
        levels=tuple(levels), coarse_chol=factor_coarse(ops[-1])))


def build_hierarchy(graph: Graph, fine_op: EllOperator,
                    cfg: MultigridConfig = MultigridConfig(),
                    validate: bool = True,
                    record: Optional[list] = None) -> Hierarchy:
    """The full multilevel hierarchy of a fine graph and operator, on
    their device, sampled as the reference's greedy scan samples (the
    reference-compatible build).  Coarsening stops at
    ``cfg.coarse_threshold`` vertices, ``cfg.max_levels`` levels, fewer
    than 8 coarse points or no reduction.  ``validate`` raises
    :class:`DegenerateHierarchyError` on a level where half the fine
    points or more fell back to their nearest coarse points.  ``record``
    (a list) receives one dict per level with the seconds of each stage
    of :data:`STAGES` and ``sampling_rounds``."""
    return _build(graph, fine_op, cfg, lambda level, g: None, validate,
                  record)


def build_hierarchy_device(graph: Graph, fine_op: EllOperator,
                           cfg: MultigridConfig = MultigridConfig(),
                           exact_sampling: bool = False,
                           priorities: Optional[Sequence[torch.Tensor]] = None,
                           generator: Optional[torch.Generator] = None,
                           record: Optional[list] = None
                           ) -> Tuple[Hierarchy, List[HierarchyStats]]:
    """The same pipeline with random-priority sampling: a maximal
    independent set of the same conflict relation as the reference's
    greedy scan, with the same spacing, but a different hierarchy than
    its index-order one.  ``exact_sampling`` gives the reference's.

    ``priorities[l]`` holds level l's priorities (pairwise distinct
    integers, the smallest first; its first entries are used if it is
    longer than the level); without them each level draws a permutation
    from ``generator`` (seed 0 if None).  Returns the hierarchy and the
    per-level statistics; raises :class:`DegenerateHierarchyError` as
    :func:`build_hierarchy` does.
    """
    def level_ranks(level: int, g: Graph):
        if exact_sampling:
            return None
        if priorities is None:
            return priority_ranks(g.num_vertices, g.neighbors.device,
                                  generator=generator)
        if level >= len(priorities):
            raise ValueError(f"no priorities for level {level}: "
                             f"{len(priorities)} were given")
        return priority_ranks(g.num_vertices, g.neighbors.device,
                              priorities[level])

    h = _build(graph, fine_op, cfg, level_ranks, True, record)
    return h, [ld.stats for ld in h.levels]


# Starting coarse-degree capacity of the csrc coarsener; doubled until
# the coarse graph fits.
_KC_CAP = 192


def coarsen_level_host(nbr: np.ndarray, dst: np.ndarray, pts: np.ndarray,
                       cfg: MultigridConfig) -> dict:
    """``native.coarsen_level`` on f64 numpy tables, its coarse-degree
    capacity doubled until the coarse graph fits."""
    cap = _KC_CAP
    while True:
        try:
            return native.coarsen_level(nbr, dst, pts, cfg.reduction_ratio,
                                        cfg.weighting, cap)
        except ValueError:
            cap *= 2


def build_hierarchy_host(graph: Graph, op: EllOperator,
                         cfg: MultigridConfig = MultigridConfig(),
                         levels_out: Optional[list] = None
                         ) -> SolverHierarchy:
    """Solver hierarchy for ``op`` on ``graph``, on ``op``'s device,
    coarsened on the host: the cross-check of :func:`build_hierarchy`.

    Each level is coarsened in f64 by
    ``csrc/gravomg_host.cpp::gmg_coarsen_level``, whose sampling is the
    reference greedy Poisson-disc scan.  The coarse operator is the
    Galerkin product U^T A U; the next level's graph carries Euclidean
    distances between coarse points over the coarse adjacency.  The stop
    rules and the returned solver hierarchy are those of
    :func:`build_hierarchy`.  ``levels_out`` (a list) receives the
    coarsener's numpy arrays of each level (``native.coarsen_level``).
    """
    dev = op.diag.device
    nbr = graph.neighbors.cpu().numpy()
    dst = graph.distances.cpu().numpy().astype(np.float64)
    pts = graph.points.cpu().numpy().astype(np.float64)
    ops, us = [op], []
    while len(ops) < cfg.max_levels and nbr.shape[0] > cfg.coarse_threshold:
        v = nbr.shape[0]
        lv = coarsen_level_host(nbr, dst, pts, cfg)
        cp, cnbr = lv["coarse_points"], lv["coarse_nbr"]
        nc = cp.shape[0]
        if nc >= v or nc < 8:
            break
        u = Prolongation(torch.as_tensor(lv["u_cols"], device=dev),
                         torch.as_tensor(lv["u_weights"], device=dev,
                                         dtype=op.diag.dtype), nc)
        us.append(u)
        if levels_out is not None:
            levels_out.append(lv)
        ops.append(galerkin_rap(ops[-1], u, cfg.degree_multiple))
        valid = cnbr != INVALID_INDEX
        width = int(np.nonzero(valid.any(axis=0))[0].max()) + 1
        cnbr, valid = cnbr[:, :width], valid[:, :width]
        safe = np.where(valid, cnbr, 0)
        d = np.linalg.norm(cp[safe] - cp[:, None, :], axis=-1)
        nbr, dst, pts = cnbr, np.where(valid, d, 0.0), cp

    return _solver(ops, us, cfg)
