"""Multigrid cycles over a solver hierarchy (counterpart of
``gravomg_tpu/solve/vcycle.py``).

Levels that carry slab forms (``attach_slab_operators``) apply A, U and
U^T through the block-window kernel (the transposed-tile kernel for the
``mxu`` form); ``attach_fast_operators`` gives the levels that have none
the uniform block-dense forms, which a 1-D x on the card applies in one
launch of the uniform kernel (``ops/uniform_cuda.py``); what has neither
uses the ELL gather forms.
The cycle is a plain Python recursion over the levels; each cycle is
the span ``vcycle``, each visit of a level ``vcycle.L<l>`` and the
coarsest solve ``vcycle.coarse`` (``utils/profiling.py``).

A 2-D x (V, D) takes a level's fast form too when it is an 8-row slab
form (through the batched kernel B1, one launch a matvec, m read once) or
a uniform form; an ``mxu`` form leaves it on the ELL gather.  JAX's own
(V, D) branch keeps ELL (``gravomg_tpu/solve/vcycle.py:55``), but its
c5 recipe vmaps the 1-D cycle over the columns, which reaches the slab
form's kernel with one column at a time: B1 is the card's counterpart of
that, and the (V, D) cycle computes the same function as both.  No JAX
recipe vmaps the transposed-tile kernel.

A stack of hierarchies (``parallel/batch.py``: a leading mesh axis on
every tensor, uniform forms only) runs through the same functions with
a (B, V) x.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              block_anchors,
                                              blockdense_from_ell,
                                              blockdense_from_operator,
                                              trim_escape)
from gravomg_tpu_torch.ops.slab import (WINDOW, SlabOperator,
                                        slab_from_ell, slab_matvec)
from gravomg_tpu_torch.ops.uniform_cuda import uniform_matvec
from gravomg_tpu_torch.prolong.operator import (build_restriction, prolong,
                                                restrict, restrict_gather)
from gravomg_tpu_torch.solve.coarse import coarse_solve
from gravomg_tpu_torch.solve.smoothers import (ChebyshevParams, chebyshev,
                                               weighted_jacobi)
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.types import EllOperator, Prolongation, Restriction
from gravomg_tpu_torch.utils.profiling import span

FastOperator = Union[SlabOperator, BlockDenseOperator]


class SolverLevel(NamedTuple):
    op: EllOperator
    u: Optional[Prolongation]           # maps next-coarser level -> this
    cheb: Optional[ChebyshevParams]
    ut: Optional[Restriction] = None    # gather-form U^T
    banded: Optional[FastOperator] = None   # A_l, slab or uniform form
    uw: Optional[FastOperator] = None       # U
    utw: Optional[FastOperator] = None      # U^T


class SolverHierarchy(NamedTuple):
    levels: Tuple[SolverLevel, ...]
    coarse_chol: torch.Tensor


def apply_fast(op: FastOperator, x: torch.Tensor) -> torch.Tensor:
    """A slab or uniform block-dense form on x (see :func:`takes`)."""
    if isinstance(op, SlabOperator):
        return slab_matvec(op, x)
    return uniform_matvec(op, x)


def takes(op: Optional[FastOperator], x: torch.Tensor) -> bool:
    """Whether the fast form ``op`` applies to x: every form takes a 1-D
    x; a 2-D x every form but the transposed-tile (``mxu``) one."""
    if op is None:
        return False
    return x.ndim == 1 or not (isinstance(op, SlabOperator) and op.mxu)


def level_matvec(level: SolverLevel, x: torch.Tensor) -> torch.Tensor:
    """A_l @ x through the slab or uniform form when it takes x, else
    ELL."""
    if takes(level.banded, x):
        return apply_fast(level.banded, x)
    return spmv(level.op, x)


def smooth_with(op, cheb: Optional[ChebyshevParams], mv, x, b, iters: int,
                cfg: MultigridConfig, x0_zero: bool = False):
    """The configured smoother (Chebyshev of ``cfg.chebyshev_degree``
    or ``iters`` weighted-Jacobi sweeps) with its matvec through ``mv``
    (None: ELL on ``op``), which otherwise lends only its diagonal."""
    if cfg.smoother == "chebyshev":
        return chebyshev(op, x, b, cheb, cfg.chebyshev_degree, mv=mv,
                         x0_zero=x0_zero)
    return weighted_jacobi(op, x, b, iters, cfg.jacobi_omega, mv=mv,
                           x0_zero=x0_zero)


def _smooth(level: SolverLevel, x, b, iters: int, cfg: MultigridConfig,
            x0_zero: bool = False):
    mv = None
    if takes(level.banded, x):
        mv = functools.partial(level_matvec, level)
    return smooth_with(level.op, level.cheb, mv, x, b, iters, cfg,
                       x0_zero=x0_zero)


def _restrict_level(level: SolverLevel, r: torch.Tensor) -> torch.Tensor:
    if takes(level.utw, r):
        return apply_fast(level.utw, r)
    if level.ut is not None:
        return restrict_gather(level.ut, r)
    return restrict(level.u, r)


def _prolong_level(level: SolverLevel, ec: torch.Tensor) -> torch.Tensor:
    if takes(level.uw, ec):
        return apply_fast(level.uw, ec)
    return prolong(level.u, ec)


def _descend(h: SolverHierarchy, lvl: int, x: torch.Tensor, b: torch.Tensor,
             cfg: MultigridConfig, x0_zero: bool = False) -> torch.Tensor:
    """One multigrid cycle starting (and ending) at level ``lvl``."""
    level = h.levels[lvl]
    if lvl == len(h.levels) - 1:
        with span("vcycle.coarse"):
            return coarse_solve(h.coarse_chol, b)
    with span("vcycle.L", lvl):
        x = _smooth(level, x, b, cfg.pre_smooth, cfg, x0_zero=x0_zero)
        r = b - level_matvec(level, x)
        rc = _restrict_level(level, r)
        # Coarse corrections start from zero: x0_zero saves their
        # pre-smooth's first matvec (A 0 = 0 exactly).
        ec = _descend(h, lvl + 1, torch.zeros_like(rc), rc, cfg,
                      x0_zero=True)
        # gamma-cycle: revisit the coarser level gamma-1 more times;
        # repeats directly above the coarsest level would repeat an
        # exact solve.
        if lvl + 1 < len(h.levels) - 1:
            for _ in range(cfg.cycle_gamma - 1):
                ec = _descend(h, lvl + 1, ec, rc, cfg)
        x = x + _prolong_level(level, ec)
        return _smooth(level, x, b, cfg.post_smooth, cfg)


def v_cycle(h: SolverHierarchy, x: torch.Tensor, b: torch.Tensor,
            cfg: MultigridConfig, x0_zero: bool = False) -> torch.Tensor:
    """One cycle on the finest level (V-cycle; W and deeper via
    ``cfg.cycle_gamma``) for x, b (V,) or (V, D).  ``x0_zero=True``
    asserts ``x`` is exactly zero and saves the fine pre-smooth's first
    matvec."""
    with span("vcycle"):
        return _descend(h, 0, x, b, cfg, x0_zero=x0_zero)


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


def fmg(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
        cycles_per_level: int = 1) -> torch.Tensor:
    """Full multigrid (F-cycle): b restricted down the hierarchy, an
    exact solve on the coarsest level, then prolongation alternating
    with ``cycles_per_level`` gamma-cycles at every level on the way up.
    One pass costs about two V-cycles; its result is a first guess for
    :func:`solve` or the Krylov solvers."""
    bs = [b]
    for level in h.levels[:-1]:
        bs.append(_restrict_level(level, bs[-1]))
    x = coarse_solve(h.coarse_chol, bs[-1])
    for lvl in range(len(h.levels) - 2, -1, -1):
        x = _prolong_level(h.levels[lvl], x)
        for _ in range(cycles_per_level):
            x = _descend(h, lvl, x, bs[lvl], cfg)
    return x


def solve_with_history(h: SolverHierarchy, b: torch.Tensor,
                       cfg: MultigridConfig):
    """:func:`solve` from a zero guess, also returning the relative
    residual after each cycle: a (cfg.max_cycles,) tensor of b's dtype,
    +inf beyond the last cycle run.  Returns (x, relative_residual,
    iterations, history)."""
    bnorm = max(float(torch.linalg.norm(b)), 1e-30)
    hist = torch.full((cfg.max_cycles,), float("inf"), dtype=b.dtype,
                      device=b.device)
    x = torch.zeros_like(b)
    rel = float(torch.linalg.norm(b)) / bnorm
    it = 0
    while rel > cfg.tolerance and it < cfg.max_cycles:
        x = v_cycle(h, x, b, cfg)
        rel = float(torch.linalg.norm(
            b - level_matvec(h.levels[0], x))) / bnorm
        hist[it] = rel
        it += 1
    return x, rel, it, hist


def solve_refined(h: SolverHierarchy, b: torch.Tensor, cfg: MultigridConfig,
                  inner_cycles: int = 2):
    """Mixed-precision solve (iterative refinement): the residual
    r = b - A x and the solution accumulate in f64 around corrections of
    ``inner_cycles`` V-cycles in the hierarchy's own precision.  Reaches
    a 1e-8 relative residual where the f32 stationary :func:`solve`
    stalls.  Returns (x (f64), relative_residual, outer_iterations)."""
    if inner_cycles < 1:
        raise ValueError(f"inner_cycles must be at least 1, got "
                         f"{inner_cycles}")
    a0 = h.levels[0].op
    a0_64 = EllOperator(a0.neighbors, a0.offdiag.double(), a0.diag.double())
    b64 = b.double()
    bnorm = max(float(torch.linalg.norm(b64)), 1e-300)
    x = torch.zeros_like(b64)
    rel, it = float("inf"), 0
    while rel > cfg.tolerance and it < cfg.max_cycles:
        r = (b64 - spmv(a0_64, x)).to(a0.diag.dtype)
        d = v_cycle(h, torch.zeros_like(r), r, cfg, x0_zero=True)
        for _ in range(inner_cycles - 1):
            d = v_cycle(h, d, r, cfg)
        x = x + d.double()
        rel = float(torch.linalg.norm(b64 - spmv(a0_64, x))) / bnorm
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


def slot_ell(level: SolverLevel, field: str):
    """(cols, vals, valid, n_cols, diag): the ELL arrays of a level's A
    (``field`` "banded"), U ("uw") or U^T ("utw", from the gather table),
    which its fast forms are converted from."""
    if field == "banded":
        op = level.op
        return op.neighbors, op.offdiag, op.mask, op.num_vertices, op.diag
    if field == "uw":
        u = level.u
        return (u.cols, u.weights, torch.ones_like(u.cols, dtype=torch.bool),
                u.n_coarse, None)
    rt = level.ut
    return rt.safe_rows(), rt.weights, rt.mask, rt.n_fine, None


def attach_slab_operators(h: SolverHierarchy, min_rows: int = 4096,
                          escape_cap: int = 65536,
                          mxu: bool = False) -> SolverHierarchy:
    """Populate slab forms of A, U and U^T on every slot of
    :func:`slab_slots` (the hierarchy must be spatially ordered; missing
    U^T tables are attached first).  ``mxu`` selects the transposed-tile
    form (128-row blocks).  The escape capacity grows 4x on overflow.

    As in the JAX package, a slot that gets no slab form (a block needs
    more than 24 windows, or the escape chute outgrows four retries)
    stays None: :func:`attach_fast_operators` then gives a level without
    any fast form the uniform one, and a level that has some keeps the
    ELL form in that slot."""
    h = attach_restrictions(h)

    def convert(cols, vals, valid, n_cols, diag):
        cap = escape_cap
        for _ in range(4):
            try:
                return slab_from_ell(cols, vals, valid, n_cols, diag=diag,
                                     escape_cap=cap, mxu=mxu)
            except ValueError as e:
                if "escape overflow" not in str(e):
                    return None
                cap *= 4
        return None

    slots = slab_slots(h, min_rows)
    levels = tuple(
        lvl._replace(**{f: convert(*slot_ell(lvl, f))
                        for li_s, f in slots if li_s == li})
        for li, lvl in enumerate(h.levels))
    return h._replace(levels=levels)


def attach_fast_operators(h: SolverHierarchy, block: int = 256,
                          window: int = 128, dtype=None,
                          escape_cap: Optional[int] = None,
                          trim: bool = True,
                          geometry: Optional[dict] = None,
                          used_geometry: Optional[dict] = None
                          ) -> SolverHierarchy:
    """Populate uniform block-dense forms on every level that has no
    fast form yet (a level with any of ``banded``, ``uw``, ``utw`` set,
    e.g. by :func:`attach_slab_operators`, is left as it is).

    The hierarchy must be spatially ordered.  Window 0 is wide and
    covers each row block's diagonal band (for U and U^T it anchors at
    :func:`block_anchors`), the far windows are ``window`` wide; on an
    escape overflow the conversion retries with 2 more far windows (at
    most 24) and 4x the escape capacity.  The coarsest level keeps only
    its dense factor.  ``dtype`` casts the window matrices.  ``trim``
    False keeps the full escape capacity; ``geometry`` maps
    ``(level, slot)`` (slots "a", "u", "ut") to (nw, cap) floors for the
    retry loop; ``used_geometry`` (a dict) receives the (nw, cap) each
    conversion settled on."""

    def convert(build, *args, start_nw, start_cap, key, **kw):
        cur_nw, cap = (geometry or {}).get(key, (start_nw, start_cap))
        cur_nw, cap = max(cur_nw, start_nw), max(cap, start_cap)
        while True:
            bop, ovf = build(*args, nw=cur_nw, escape_cap=cap, **kw)
            if not ovf:
                break
            cur_nw = min(cur_nw + 2, 24)
            cap = cap * 4
        if used_geometry is not None:
            used_geometry[key] = (cur_nw, cap)
        if trim:
            bop = trim_escape(bop)
        if dtype is not None:
            bop = bop._replace(m=bop.m.to(dtype))
        return bop

    levels = []
    for li, lvl in enumerate(h.levels):
        new = lvl
        v = lvl.op.num_vertices
        blk = min(block, max(v // 8, 8))
        if (new.banded is not None or new.uw is not None
                or new.utw is not None):
            levels.append(new)
            continue
        if li < len(h.levels) - 1:
            # Diagonal band: block +- 2*block covers the near spread.
            w0 = min(-(-3 * blk // 128) * 128, v)
            new = new._replace(banded=convert(
                blockdense_from_operator, lvl.op, start_nw=6,
                start_cap=escape_cap or max(1024, v // 8), key=(li, "a"),
                block=blk, window=min(window, v), window0=w0))
        if lvl.u is not None:
            u = lvl.u
            nc = u.n_coarse
            # A block of BLK fine rows spans ~BLK/ratio coarse columns.
            ratio = max(u.n_fine // max(nc, 1), 1)
            w0 = min(-(-max(4 * blk // ratio, 128) // 64) * 64, nc)
            ones = torch.ones_like(u.cols, dtype=torch.bool)
            new = new._replace(uw=convert(
                blockdense_from_ell, u.cols, u.weights, ones, nc,
                start_nw=4,
                start_cap=escape_cap or max(1024, u.n_fine // 16),
                key=(li, "u"), block=blk, window=min(window, nc),
                window0=w0, anchors=block_anchors(u.cols, ones, blk)))
        if lvl.ut is not None:
            rt = lvl.ut
            # A block of coarse rows spans ~block*ratio fine columns.
            ratio = max(rt.n_fine // max(rt.n_coarse, 1), 1)
            blk_r = min(64, max(rt.n_coarse // 8, 8))
            w0 = min(-(-3 * blk_r * ratio // 128) * 128, rt.n_fine)
            vmask = rt.mask
            new = new._replace(utw=convert(
                blockdense_from_ell, rt.safe_rows(), rt.weights, vmask,
                rt.n_fine, start_nw=4,
                start_cap=escape_cap or max(1024, rt.n_coarse),
                key=(li, "ut"), block=blk_r, window=min(window, rt.n_fine),
                window0=w0,
                anchors=block_anchors(rt.safe_rows(), vmask, blk_r)))
        levels.append(new)
    return h._replace(levels=tuple(levels))


def attach_operators(h: SolverHierarchy,
                     slab_min_rows: int = 4096) -> SolverHierarchy:
    """Slab forms on the levels of at least ``slab_min_rows`` rows, then
    uniform block-dense forms on the rest (it skips populated levels)."""
    h = attach_slab_operators(h, min_rows=slab_min_rows)
    return attach_fast_operators(h)


def cast_fast_operators(h: SolverHierarchy, dtype) -> SolverHierarchy:
    """Copy of a hierarchy with the window matrices of its slab and
    uniform forms cast to ``dtype`` (bf16 for preconditioner duty).
    Diagonals, escape chutes and the ELL operators keep their
    precision."""

    def cast(op: FastOperator) -> FastOperator:
        if isinstance(op, SlabOperator):
            return op._replace(buckets=tuple(
                b._replace(m=b.m.to(dtype)) for b in op.buckets))
        return op._replace(m=op.m.to(dtype))

    levels = []
    for lvl in h.levels:
        new = lvl
        for field in ("banded", "uw", "utw"):
            op = getattr(lvl, field)
            if op is not None:
                new = new._replace(**{field: cast(op)})
        levels.append(new)
    return h._replace(levels=tuple(levels))
