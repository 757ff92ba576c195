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
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import solve, solve_refined
from gravomg_tpu_torch.types import EllOperator, Graph


def spectral_alpha(graph: Graph, weighting: str = "invdist",
                   target_frac: float = 0.25, rel_floor: float = 1e-5,
                   lap_mass: Optional[Tuple] = None) -> torch.Tensor:
    """Screening shift (in pencil units) for an eigen-preconditioner:
    ``target_frac`` of an estimate of lam_1, clamped to [``rel_floor``,
    1e-4] times mean(diag) / mean(mass).

    The Poisson path's ``alpha="auto"`` (1e-4 of the mean diagonal)
    grows like 1/h^3 in pencil units and overtakes lam_1 at scale, which
    leaves the V-cycle a scaled identity on the low modes.  lam_1 is
    estimated by the Rayleigh quotients of the three M-centred
    coordinates, without those of negligible M-weighted variance (a
    planar cloud's normal).  The floor keeps the shifted operator SPD
    above f32 Galerkin noise (about 1e-6 of the diagonal)."""
    lap, mass = (lap_mass if lap_mass is not None
                 else graph_laplacian(graph, weighting))
    pts = graph.points
    v = pts - (torch.sum(mass[:, None] * pts, dim=0)
               / torch.sum(mass))[None, :]
    var = torch.sum(mass[:, None] * v * v, dim=0)
    nondegenerate = var > 1e-6 * torch.max(var)
    rq = torch.sum(v * spmv(lap, v), dim=0) / torch.clamp(var, min=1e-30)
    lam1_est = torch.min(torch.where(nondegenerate, rq,
                                     torch.full_like(rq, float("inf"))))
    diag_over_mass = torch.mean(lap.diag) / torch.mean(mass)
    return torch.clamp(target_frac * lam1_est, rel_floor * diag_over_mass,
                       1e-4 * diag_over_mass)


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
    ``alpha="spectral"`` sets the shift of :func:`spectral_alpha`, the
    eigen-preconditioner's (``laplace_eigs``).
    """
    lap, mass = (lap_mass if lap_mass is not None
                 else graph_laplacian(graph, weighting))
    if isinstance(alpha, str):
        if alpha == "auto":
            alpha = rel_floor * torch.mean(lap.diag) / torch.mean(mass)
        elif alpha == "spectral":
            alpha = spectral_alpha(graph, lap_mass=(lap, mass))
        else:
            raise ValueError(f"unknown alpha mode {alpha!r}")
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
