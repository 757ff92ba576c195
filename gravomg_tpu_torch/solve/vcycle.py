"""Multigrid cycles over a solver hierarchy (counterpart of
``gravomg_tpu/solve/vcycle.py``).

Levels that carry slab forms (``attach_slab_operators``) apply A, U and
U^T through the block-window kernel; the rest use the ELL gather forms.
The cycle is a plain Python recursion over the levels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.ops.slab import (WINDOW, SlabOperator,
                                        slab_from_ell, slab_from_operator,
                                        slab_matvec)
from gravomg_tpu_torch.prolong.operator import (build_restriction, prolong,
                                                restrict, restrict_gather)
from gravomg_tpu_torch.solve.coarse import coarse_solve
from gravomg_tpu_torch.solve.smoothers import (ChebyshevParams, chebyshev,
                                               weighted_jacobi)
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.types import EllOperator, Prolongation, Restriction


class SolverLevel(NamedTuple):
    op: EllOperator
    u: Optional[Prolongation]           # maps next-coarser level -> this
    cheb: Optional[ChebyshevParams]
    ut: Optional[Restriction] = None    # gather-form U^T
    banded: Optional[SlabOperator] = None   # A_l, slab form
    uw: Optional[SlabOperator] = None       # U, slab form
    utw: Optional[SlabOperator] = None      # U^T, slab form


class SolverHierarchy(NamedTuple):
    levels: Tuple[SolverLevel, ...]
    coarse_chol: torch.Tensor


def level_matvec(level: SolverLevel, x: torch.Tensor) -> torch.Tensor:
    """A_l @ x through the slab form when present, else ELL."""
    if level.banded is not None and x.ndim == 1:
        return slab_matvec(level.banded, x)
    return spmv(level.op, x)


def _smooth(level: SolverLevel, x, b, iters: int, cfg: MultigridConfig,
            x0_zero: bool = False):
    mv = None
    if level.banded is not None and x.ndim == 1:
        mv = functools.partial(level_matvec, level)
    if cfg.smoother == "chebyshev":
        return chebyshev(level.op, x, b, level.cheb, cfg.chebyshev_degree,
                         mv=mv, x0_zero=x0_zero)
    return weighted_jacobi(level.op, x, b, iters, cfg.jacobi_omega, mv=mv,
                           x0_zero=x0_zero)


def _restrict_level(level: SolverLevel, r: torch.Tensor,
                    one_d: bool) -> torch.Tensor:
    if level.utw is not None and one_d:
        return slab_matvec(level.utw, r)
    if level.ut is not None:
        return restrict_gather(level.ut, r)
    return restrict(level.u, r)


def _prolong_level(level: SolverLevel, ec: torch.Tensor,
                   one_d: bool) -> torch.Tensor:
    if level.uw is not None and one_d:
        return slab_matvec(level.uw, ec)
    return prolong(level.u, ec)


def _descend(h: SolverHierarchy, lvl: int, x: torch.Tensor, b: torch.Tensor,
             cfg: MultigridConfig, one_d: bool,
             x0_zero: bool = False) -> torch.Tensor:
    """One multigrid cycle starting (and ending) at level ``lvl``."""
    level = h.levels[lvl]
    if lvl == len(h.levels) - 1:
        return coarse_solve(h.coarse_chol, b)
    x = _smooth(level, x, b, cfg.pre_smooth, cfg, x0_zero=x0_zero)
    r = b - (level_matvec(level, x) if one_d else spmv(level.op, x))
    rc = _restrict_level(level, r, one_d)
    # Coarse corrections start from zero: x0_zero saves their
    # pre-smooth's first matvec (A 0 = 0 exactly).
    ec = _descend(h, lvl + 1, torch.zeros_like(rc), rc, cfg, one_d,
                  x0_zero=True)
    # gamma-cycle: revisit the coarser level gamma-1 more times; repeats
    # directly above the coarsest level would repeat an exact solve.
    if lvl + 1 < len(h.levels) - 1:
        for _ in range(cfg.cycle_gamma - 1):
            ec = _descend(h, lvl + 1, ec, rc, cfg, one_d)
    x = x + _prolong_level(level, ec, one_d)
    return _smooth(level, x, b, cfg.post_smooth, cfg)


def v_cycle(h: SolverHierarchy, x: torch.Tensor, b: torch.Tensor,
            cfg: MultigridConfig, x0_zero: bool = False) -> torch.Tensor:
    """One cycle on the finest level (V-cycle; W and deeper via
    ``cfg.cycle_gamma``).  ``x0_zero=True`` asserts ``x`` is exactly zero
    and saves the fine pre-smooth's first matvec."""
    return _descend(h, 0, x, b, cfg, x.ndim == 1, x0_zero=x0_zero)


def solve(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
          x0: Optional[torch.Tensor] = None):
    """Stationary V-cycle iteration to ``cfg.tolerance`` relative
    residual.  Returns (x, relative_residual, iterations); the residual
    is a host float (the exit test reads it every cycle)."""
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = max(float(torch.linalg.norm(b)), 1e-30)
    rel = float(torch.linalg.norm(b - level_matvec(h.levels[0], x))) / bnorm
    it = 0
    while rel > cfg.tolerance and it < cfg.max_cycles:
        x = v_cycle(h, x, b, cfg)
        rel = float(torch.linalg.norm(
            b - level_matvec(h.levels[0], x))) / bnorm
        it += 1
    return x, rel, it


def attach_restrictions(h: SolverHierarchy,
                        max_children: Optional[int] = None
                        ) -> SolverHierarchy:
    """Populate every level's gather-form U^T table, doubling the
    children cap until it fits (default seed: 4x the mean children
    count, rounded to a multiple of 8)."""
    levels = []
    for lvl in h.levels:
        if lvl.u is None or lvl.ut is not None:
            levels.append(lvl)
            continue
        vf, nc = lvl.u.n_fine, lvl.u.n_coarse
        cap = max_children or max(8, -(-4 * 3 * vf // nc))
        cap = min(-(-cap // 8) * 8, vf)
        rt, ovf = build_restriction(lvl.u, cap)
        while ovf and cap < vf:
            cap = min(2 * cap, vf)
            rt, ovf = build_restriction(lvl.u, cap)
        levels.append(lvl._replace(ut=rt))
    return h._replace(levels=tuple(levels))


def slab_slots(h: SolverHierarchy, min_rows: int = 4096):
    """The (level index, field) pairs that take a slab form: ``banded``
    on every non-coarsest level of at least ``min_rows`` rows, ``uw``
    where U has at least ``min_rows`` fine rows and a full window of
    coarse columns, ``utw`` where U^T has at least ``min_rows`` rows."""
    slots = []
    for li, lvl in enumerate(h.levels):
        if li < len(h.levels) - 1 and lvl.op.num_vertices >= min_rows:
            slots.append((li, "banded"))
        if lvl.u is not None:
            if lvl.u.n_fine >= min_rows and lvl.u.n_coarse >= WINDOW:
                slots.append((li, "uw"))
            if lvl.u.n_coarse >= min_rows:
                slots.append((li, "utw"))
    return slots


def attach_slab_operators(h: SolverHierarchy, min_rows: int = 4096,
                          escape_cap: int = 65536) -> SolverHierarchy:
    """Populate slab forms of A, U and U^T on every slot of
    :func:`slab_slots` (the hierarchy must be spatially ordered; missing
    U^T tables are attached first).  Other levels keep the ELL forms.
    The escape capacity grows 4x on overflow.

    A slot that gets no slab form (a block needs more than 24 windows,
    or the escape chute outgrows four retries) keeps its ELL form on the
    CPU, where both forms are plain torch.  On a CUDA hierarchy it
    raises: the ELL form there would run plain torch in place of the
    kernel, and the uniform block-dense form that takes such levels in
    the JAX package is not ported yet."""
    h = attach_restrictions(h)
    on_card = h.levels[0].op.diag.is_cuda

    def convert(li, build, *args):
        cap = escape_cap
        for _ in range(4):
            try:
                return build(*args, escape_cap=cap)
            except ValueError as e:
                err = e
                if "escape overflow" not in str(e):
                    break
                cap *= 4
        if on_card:
            raise RuntimeError(f"attach_slab_operators: level {li} has no "
                               f"slab form on the card: {err}") from err
        return None

    slots = set(slab_slots(h, min_rows))
    levels = []
    for li, lvl in enumerate(h.levels):
        new = lvl
        if (li, "banded") in slots:
            new = new._replace(banded=convert(li, slab_from_operator,
                                              lvl.op))
        if (li, "uw") in slots:
            u = lvl.u
            new = new._replace(uw=convert(
                li, slab_from_ell, u.cols, u.weights,
                torch.ones_like(u.cols, dtype=torch.bool), u.n_coarse))
        if (li, "utw") in slots:
            rt = lvl.ut
            new = new._replace(utw=convert(
                li, slab_from_ell, rt.safe_rows(), rt.weights, rt.mask,
                rt.n_fine))
        levels.append(new)
    return h._replace(levels=tuple(levels))


def cast_fast_operators(h: SolverHierarchy, dtype) -> SolverHierarchy:
    """Copy of a slab-attached hierarchy with the window matrices cast to
    ``dtype`` (bf16 for preconditioner duty).  Diagonals, escape chutes
    and the ELL operators keep their precision."""

    def cast(sop: SlabOperator) -> SlabOperator:
        return sop._replace(buckets=tuple(
            b._replace(m=b.m.to(dtype)) for b in sop.buckets))

    levels = []
    for lvl in h.levels:
        new = lvl
        for field in ("banded", "uw", "utw"):
            sop = getattr(lvl, field)
            if sop is not None:
                new = new._replace(**{field: cast(sop)})
        levels.append(new)
    return h._replace(levels=tuple(levels))
