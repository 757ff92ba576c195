"""Conjugate gradients preconditioned by one V-cycle (counterpart of
``gravomg_tpu/solve/cg.py``).

Python loops with the JAX package's exits: stop when the relative
residual is at most ``tol`` or after ``max_iters`` iterations.  The
residual norm is read on the host once per iteration for that test.
Returns (x, relative_residual as a float, iterations).

Spans (``utils/profiling.py``): ``krylov.iter`` around each iteration,
``krylov.residual_read`` around each norm read on the host (``bnorm``,
the first residual, one an iteration); ``mg_solve`` around the default
solve and ``mg_solve.cast`` around its bf16 cast.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy,
                                            cast_fast_operators,
                                            level_matvec, v_cycle)
from gravomg_tpu_torch.types import EllOperator
from gravomg_tpu_torch.utils.profiling import span

Matvec = Callable[[torch.Tensor], torch.Tensor]


Dot = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _krylov(op: EllOperator, b: torch.Tensor, precond: Matvec, tol: float,
            max_iters: int, x0: Optional[torch.Tensor],
            mv: Optional[Matvec], flexible: bool, dot: Optional[Dot] = None):
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    if dot is None:
        dot, norm = torch.dot, torch.linalg.norm
    else:
        norm = lambda y: torch.sqrt(dot(y, y))  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0
    tiny = torch.finfo(b.dtype).tiny
    with span("krylov.residual_read"):
        bnorm = max(float(norm(b)), 1e-30)
    r = b - mv(x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    with span("krylov.residual_read"):
        rel = float(norm(r)) / bnorm
    it = 0
    while rel > tol and it < max_iters:
        with span("krylov.iter"):
            ap = mv(p)
            alpha = rz / torch.clamp(dot(p, ap), min=tiny)
            x = x + alpha * p
            r_new = r - alpha * ap
            z = precond(r_new)
            rz_new = dot(r_new, z)
            if flexible:
                # Polak-Ribiere: keeps p A-orthogonal when M varies.
                beta = (rz_new - dot(r, z)) / torch.clamp(rz, min=tiny)
            else:
                beta = rz_new / torch.clamp(rz, min=tiny)
            p = z + beta * p
            r, rz = r_new, rz_new
            with span("krylov.residual_read"):
                rel = float(norm(r)) / bnorm
        it += 1
    return x, rel, it


def pcg(op: EllOperator, b: torch.Tensor, precond: Matvec,
        tol: float = 1e-8, max_iters: int = 500,
        x0: Optional[torch.Tensor] = None, mv: Optional[Matvec] = None,
        dot: Optional[Dot] = None):
    """Preconditioned CG.  ``mv`` overrides the operator matvec; ``dot``
    the inner product (default ``torch.dot``; the norms become
    sqrt(dot(r, r)) with it), e.g. an all-reduced dot of row-sharded
    vectors."""
    return _krylov(op, b, precond, tol, max_iters, x0, mv, flexible=False,
                   dot=dot)


def fcg(op: EllOperator, b: torch.Tensor, precond: Matvec,
        tol: float = 1e-8, max_iters: int = 500,
        x0: Optional[torch.Tensor] = None, mv: Optional[Matvec] = None,
        dot: Optional[Dot] = None):
    """Flexible CG (Notay's FCG): the Polak-Ribiere direction update
    beta = z_{k+1}.(r_{k+1} - r_k) / (z_k.r_k) stays convergent when the
    preconditioner varies between iterations, e.g. a bf16 V-cycle.
    ``mv`` and ``dot`` as in :func:`pcg`."""
    return _krylov(op, b, precond, tol, max_iters, x0, mv, flexible=True,
                   dot=dot)


def _mg(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
        x0, h_outer: Optional[SolverHierarchy], krylov):
    outer = h_outer if h_outer is not None else h

    def precond(r):
        return v_cycle(h, torch.zeros_like(r), r, cfg,
                       x0_zero=True).to(r.dtype)

    return krylov(outer.levels[0].op, b, precond, tol=cfg.tolerance,
                  max_iters=cfg.max_cycles, x0=x0,
                  mv=functools.partial(level_matvec, outer.levels[0]))


def mg_pcg(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
           x0: Optional[torch.Tensor] = None,
           h_outer: Optional[SolverHierarchy] = None):
    """CG on the finest operator preconditioned by one V-cycle on ``h``;
    ``h_outer`` optionally supplies the operator for CG's own matvec."""
    return _mg(h, b, cfg, x0, h_outer, pcg)


def mg_fcg(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
           x0: Optional[torch.Tensor] = None,
           h_outer: Optional[SolverHierarchy] = None):
    """Flexible CG preconditioned by one V-cycle on ``h`` (e.g. the
    bf16-cast hierarchy, with the exact one as ``h_outer``)."""
    return _mg(h, b, cfg, x0, h_outer, fcg)


def mg_solve(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
             x0: Optional[torch.Tensor] = None):
    """Default solve to ``cfg.tolerance``: below ``cfg.bf16_threshold``
    fine rows f32 MG-PCG; at or above it, with slab forms attached,
    flexible CG preconditioned by a bf16-cast V-cycle (CG's own matvec
    and residuals stay f32 on the exact operators)."""
    with span("mg_solve"):
        lvl0 = h.levels[0]
        if (lvl0.op.num_vertices >= cfg.bf16_threshold
                and lvl0.banded is not None):
            with span("mg_solve.cast"):
                h16 = cast_fast_operators(h, torch.bfloat16)
            return mg_fcg(h16, b, cfg, x0=x0, h_outer=h)
        return mg_pcg(h, b, cfg, x0=x0)
