"""Multigrid hierarchy from the sequential C++ coarsener and torch
Galerkin products."""

from __future__ import annotations

import numpy as np
import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.io import native
from gravomg_tpu_torch.solve.coarse import factor_coarse
from gravomg_tpu_torch.solve.rap import galerkin_rap
from gravomg_tpu_torch.solve.smoothers import ChebyshevParams
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            attach_restrictions)
from gravomg_tpu_torch.types import INVALID_INDEX, EllOperator, Graph, \
    Prolongation


# Starting coarse-degree capacity of the csrc coarsener; doubled until
# the coarse graph fits.
_KC_CAP = 192


def build_hierarchy_host(graph: Graph, op: EllOperator,
                         cfg: MultigridConfig = MultigridConfig()
                         ) -> SolverHierarchy:
    """Solver hierarchy for ``op`` on ``graph``, on ``op``'s device.

    Stands in for the JAX package's ``build_hierarchy_device`` until the
    device build is ported.  Each level is coarsened on the host by
    ``csrc/gravomg_host.cpp::gmg_coarsen_level``, whose sampling is the
    reference greedy Poisson-disc scan; the JAX device build defaults to
    random-priority sampling, so level sizes differ slightly from its.
    The coarse operator is the Galerkin product U^T A U; the next level's
    graph carries Euclidean distances between coarse points over the
    coarse adjacency.  Coarsening stops at ``cfg.coarse_threshold``
    vertices or ``cfg.max_levels`` levels.  Returns the hierarchy with
    Chebyshev bounds (if ``cfg.smoother == "chebyshev"``), the U^T
    tables and the coarsest level's Cholesky factor.
    """
    dev = op.diag.device
    nbr = graph.neighbors.cpu().numpy()
    dst = graph.distances.cpu().numpy().astype(np.float64)
    pts = graph.points.cpu().numpy().astype(np.float64)
    ops, us = [op], []
    while len(ops) < cfg.max_levels and nbr.shape[0] > cfg.coarse_threshold:
        v = nbr.shape[0]
        cap = _KC_CAP
        while True:
            try:
                lv = native.coarsen_level(nbr, dst, pts,
                                          cfg.reduction_ratio,
                                          cfg.weighting, cap)
                break
            except ValueError:
                cap *= 2
        cp, cnbr = lv["coarse_points"], lv["coarse_nbr"]
        nc = cp.shape[0]
        if nc >= v or nc < 8:
            break
        u = Prolongation(torch.as_tensor(lv["u_cols"], device=dev),
                         torch.as_tensor(lv["u_weights"], device=dev,
                                         dtype=op.diag.dtype), nc)
        us.append(u)
        ops.append(galerkin_rap(ops[-1], u, cfg.degree_multiple))
        valid = cnbr != INVALID_INDEX
        width = int(np.nonzero(valid.any(axis=0))[0].max()) + 1
        cnbr, valid = cnbr[:, :width], valid[:, :width]
        safe = np.where(valid, cnbr, 0)
        d = np.linalg.norm(cp[safe] - cp[:, None, :], axis=-1)
        nbr, dst, pts = cnbr, np.where(valid, d, 0.0), cp

    levels = []
    for i, o in enumerate(ops):
        cheb = (ChebyshevParams.from_operator(o, cfg.chebyshev_ratio)
                if cfg.smoother == "chebyshev" else None)
        levels.append(SolverLevel(op=o, u=us[i] if i < len(us) else None,
                                  cheb=cheb))
    return attach_restrictions(SolverHierarchy(
        levels=tuple(levels), coarse_chol=factor_coarse(ops[-1])))
