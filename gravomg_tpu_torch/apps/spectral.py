"""Lowest Laplace eigenpairs by block LOBPCG preconditioned with one
multigrid V-cycle (counterpart of ``gravomg_tpu/apps/spectral.py``).

Solves L v = lam M v (L the graph Laplacian, M the lumped mass, diagonal)
for the k smallest pairs.  Each step preconditions the whole residual
block with one V-cycle on a (V, k) right-hand side (the ELL path), forms
the search block S = [X, W, P], and solves the Rayleigh-Ritz problem of
S in f64: the Grams are accumulated in f64 on the block's device, and the
small m x m pencil (m <= 3k) is solved on the host, where the loop
already waits every iteration for its stopping test.

Degenerate directions of S (it becomes nearly M-rank-deficient as pairs
converge) are whitened with the Gram's eigendecomposition and pinned to
a huge Ritz value, so the k-smallest selection never picks them; W and P
are made M-orthogonal to X before they enter S.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple, Union

import torch

from gravomg_tpu_torch.apps.poisson import poisson_hierarchy
from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.hierarchy import Hierarchy
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import SolverHierarchy, v_cycle
from gravomg_tpu_torch.types import EllOperator, Graph
from gravomg_tpu_torch.utils.profiling import stage

# Pinned Ritz value of a degenerate search direction: far above any
# Laplacian eigenvalue, far below f32 overflow.
_DEGENERATE = 1e12
# Relative Gram eigenvalue below which a direction counts as degenerate.
_RANK_TOL = 1e-6


def _b_orthonormalize(mass: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """An M-orthonormal basis of span(v), whitened by the Gram's
    eigendecomposition; near-null directions get a unit scale (harmless
    near-zero columns).  Column order is not kept: for the W and P
    blocks only, never for the Ritz block X."""
    g = v.T @ (mass[:, None] * v)
    d, q = torch.linalg.eigh(g)
    dsafe = torch.where(d > _RANK_TOL * torch.max(d), d, torch.ones_like(d))
    return v @ (q * torch.rsqrt(dsafe))


def _project_out(mass: torch.Tensor, basis: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """v without its M-projection onto ``basis`` (M-orthonormal)."""
    return v - basis @ (basis.T @ (mass[:, None] * v))


def _rayleigh_ritz_host(ga: torch.Tensor, gb: torch.Tensor, k: int):
    """The k smallest eigenpairs of the pencil (ga, gb), gb PSD, in f64
    on the host; returns (theta (k,), vectors (m, k)) on the host.

    The pencil's eigenvalue error is about eps * lam_max of the pencil
    (1e5-1e6 at 100k vertices), so an f32 solve would move the low Ritz
    values by O(0.1-1).  Directions with a Gram eigenvalue under
    ``_RANK_TOL`` of the largest are pinned to ``_DEGENERATE``."""
    ga, gb = ga.detach().cpu().double(), gb.detach().cpu().double()
    d, q = torch.linalg.eigh(gb)
    good = d > _RANK_TOL * torch.max(d)
    wh = q / torch.sqrt(torch.where(good, d, torch.ones_like(d)))
    c = wh.T @ ga @ wh
    gm = good.to(c.dtype)
    pinned = torch.where(good, torch.zeros_like(d),
                         torch.full_like(d, _DEGENERATE))
    c = c * gm[:, None] * gm[None, :] + torch.diag(pinned)
    theta, y = torch.linalg.eigh(c)
    return theta[:k], (wh @ y)[:, :k]


def _lobpcg_block(hs: SolverHierarchy, lap: EllOperator, mass: torch.Tensor,
                  x: torch.Tensor, p: torch.Tensor, cfg: MultigridConfig,
                  use_p: bool):
    """The device half of one step: residual, V-cycle preconditioner,
    search block S = [X, W, (P)] and its Grams in f64.  Returns (s, ga,
    gb, resnorm).

    The Rayleigh quotients and the Grams sum over V rows in f64: in f32
    their rounding (about 1e-6 * ||L|| * sqrt(V)) floors the block
    residual near 5e-2 at 20k vertices."""
    ax = spmv(lap, x)
    lam = torch.sum(x.double() * ax.double(), dim=0).to(x.dtype)
    r = ax - (mass[:, None] * x) * lam[None, :]
    # Relative to the largest Ritz value: the nullspace pair has lam ~ 0.
    resnorm = torch.linalg.norm(r, dim=0) / torch.clamp(
        torch.max(torch.abs(lam)), min=1e-12)
    w = v_cycle(hs, torch.zeros_like(r), r, cfg, x0_zero=True)
    w = _b_orthonormalize(mass, _project_out(mass, x, w))
    if use_p:
        pb = _project_out(mass, x, p)
        pb = pb - w @ (w.T @ (mass[:, None] * pb))
        s = torch.cat([x, w, _b_orthonormalize(mass, pb)], dim=1)
    else:
        s = torch.cat([x, w], dim=1)
    as_ = spmv(lap, s)
    s64 = s.double()
    ga = s64.T @ as_.double()
    gb = s64.T @ (mass.double()[:, None] * s64)
    return s, ga, gb, resnorm


def _lobpcg_update(s: torch.Tensor, y: torch.Tensor, k: int):
    """The Ritz rotation: X = S y (gb-orthonormal already; orthonormalising
    again would scramble the column-eigenvalue order) and P = the W and P
    part of it (the three-term recurrence drops X's)."""
    y_tail = y.clone()
    y_tail[:k] = 0.0
    return s @ y, s @ y_tail


def _lobpcg_step(hs: SolverHierarchy, lap: EllOperator, mass: torch.Tensor,
                 x: torch.Tensor, p: torch.Tensor, cfg: MultigridConfig,
                 k: int, use_p: bool, record: Optional[dict] = None):
    """One preconditioned Rayleigh-Ritz step on [X, W, (P)]; x (V, k)
    M-orthonormal, p (V, k) the previous step.  Returns (x_new, p_new,
    Ritz values, residual norms), all of x's dtype.  ``record`` (a dict)
    receives the seconds of the device block (``block_s``) and of the
    Rayleigh-Ritz solve with its transfers (``rr_s``)."""
    dev = x.device
    with stage(record, "block_s", dev):
        s, ga, gb, resnorm = _lobpcg_block(hs, lap, mass, x, p, cfg, use_p)
    with stage(record, "rr_s", dev):
        theta, y = _rayleigh_ritz_host(ga, gb, k)
        y = y.to(device=dev, dtype=s.dtype)
    x_new, p_new = _lobpcg_update(s, y, k)
    return x_new, p_new, theta.to(device=dev, dtype=x.dtype), resnorm


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


def laplace_eigs(graph: Graph, k: int = 8,
                 cfg: MultigridConfig = MultigridConfig(),
                 h: Optional[Union[Hierarchy, SolverHierarchy]] = None,
                 alpha="spectral", weighting: str = "invdist",
                 iters: int = 40, tol: float = 1e-5, seed: int = 0,
                 generator: Optional[torch.Generator] = None,
                 record: Optional[dict] = None):
    """The k smallest eigenpairs of (L, M) on a kNN graph, on the
    graph's device.  Returns (eigenvalues (k,), M-orthonormal
    eigenvectors (V, k), residual norms (k,)); the first pair is the
    nullspace (lam ~ 0, constants).

    The preconditioner is the hierarchy of L + alpha M: ``h`` (a
    :class:`Hierarchy` or :class:`SolverHierarchy`), else one built by
    :func:`poisson_hierarchy` with ``alpha`` ("spectral":
    :func:`spectral_alpha`).  The start block is standard normal from
    ``generator`` (a CPU generator seeded with ``seed`` if None), with
    column 0 set to ones.  Stops when every residual norm
    ||L v - lam M v|| / lam_max is below ``tol`` or after ``iters``
    steps.  ``record`` (a dict) receives ``iters`` and, per step, the
    seconds of the device block and of the Rayleigh-Ritz solve."""
    lap, mass = graph_laplacian(graph, weighting)
    if h is None:
        if isinstance(alpha, str) and alpha == "spectral":
            alpha = spectral_alpha(graph, weighting, lap_mass=(lap, mass))
        h = poisson_hierarchy(graph, alpha=alpha, cfg=cfg,
                              lap_mass=(lap, mass))
    solver = h.solver if isinstance(h, Hierarchy) else h
    dev, dtype = lap.diag.device, lap.diag.dtype
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    x = torch.randn((lap.num_vertices, k), generator=generator, dtype=dtype,
                    device=generator.device).to(dev)
    x[:, 0] = 1.0                          # the nullspace direction
    x = _b_orthonormalize(mass, x)
    p = torch.zeros_like(x)
    theta = torch.zeros((k,), dtype=dtype, device=dev)
    resnorm = torch.full((k,), float("inf"), dtype=dtype, device=dev)
    step = functools.partial(_lobpcg_step, solver, lap, mass)
    it = 0
    while it < iters:
        rec = None if record is None else {}
        x, p, theta, resnorm = step(x, p, cfg, k, it > 0, rec)
        it += 1
        if record is not None:
            record.setdefault("steps", []).append(rec)
        if bool(torch.max(resnorm) < tol):
            break
    if record is not None:
        record["iters"] = it
    # The in-step residual is that of the block the step started from;
    # recompute it for the returned pairs.
    r = spmv(lap, x) - (mass[:, None] * x) * theta[None, :]
    resnorm = torch.linalg.norm(r, dim=0) / torch.clamp(
        torch.max(torch.abs(theta)), min=1e-12)
    return theta, x, resnorm
