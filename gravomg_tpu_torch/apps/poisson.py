"""Poisson-type solves on point clouds (counterpart of
``gravomg_tpu/apps/poisson.py``): the screened-Poisson operator, its
hierarchy, and the solve by MG-PCG, V-cycles or mixed-precision
refinement."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.hierarchy import Hierarchy, build_hierarchy
from gravomg_tpu_torch.solve.cg import mg_pcg
from gravomg_tpu_torch.solve.vcycle import solve, solve_refined
from gravomg_tpu_torch.types import EllOperator, Graph


def screened_poisson_operator(graph: Graph, alpha=0.5,
                              weighting: str = "invdist",
                              rel_floor: float = 1e-4,
                              lap_mass: Optional[Tuple] = None,
                              ) -> Tuple[EllOperator, torch.Tensor]:
    """A = L + alpha * diag(mass): an SPD screened-Poisson operator.

    ``alpha="auto"`` sets alpha so the mean screening shift is
    ``rel_floor`` of the mean diagonal: with invdist weights a fixed
    alpha's shift falls below f32 resolution as the density grows, and
    the stored operator degenerates to a singular Laplacian.
    """
    lap, mass = (lap_mass if lap_mass is not None
                 else graph_laplacian(graph, weighting))
    if isinstance(alpha, str):
        if alpha != "auto":
            raise ValueError(f"unknown alpha mode {alpha!r}")
        alpha = rel_floor * torch.mean(lap.diag) / torch.mean(mass)
    return lap._replace(diag=lap.diag + alpha * mass), mass


def poisson_hierarchy(graph: Graph, alpha=0.5,
                      cfg: MultigridConfig = MultigridConfig(),
                      lap_mass: Optional[Tuple] = None) -> Hierarchy:
    """The hierarchy of the screened-Poisson operator on ``graph``,
    built by :func:`build_hierarchy` (the reference's sampling) on the
    graph's device."""
    op, _ = screened_poisson_operator(graph, alpha, lap_mass=lap_mass)
    return build_hierarchy(graph, op, cfg)


def solve_poisson(h: Hierarchy, b: torch.Tensor,
                  cfg: MultigridConfig = MultigridConfig(),
                  method: str = "pcg", refined: bool = False):
    """Solve A x = b on the hierarchy's finest level; returns (x,
    relative residual, iterations).

    ``method`` "pcg" is MG-preconditioned CG (the 1e-8 path in f32),
    "vcycle" stationary cycles (which stall in f32 above 1e-8).
    ``refined=True`` wraps f32 cycles in f64 iterative refinement and
    returns an f64 x, whatever ``method`` says.
    """
    if refined:
        return solve_refined(h.solver, b, cfg)
    if method == "pcg":
        return mg_pcg(h.solver, b, cfg)
    return solve(h.solver, b, cfg)
