"""Padding a solver hierarchy to chosen row counts (the array half of
``gravomg_tpu/parallel/sharding.py``).

Padded rows are decoupled identity rows: diag 1, no neighbours, zero
prolongation weights, INVALID restriction rows, and, where the coarsest
level grows, the Cholesky factor extended by an identity block.  Zero is
a fixed point of every padded row under smoothing, transfer and the
coarse solve, so a cycle on a zero-padded right-hand side leaves the
real rows as they were.  ``parallel/batch.py`` pads a mesh collection to
one shape this way; the device mesh and the sharded solves of the JAX
module are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from gravomg_tpu_torch.solve.vcycle import SolverHierarchy
from gravomg_tpu_torch.types import (INVALID_INDEX, EllOperator, Prolongation,
                                     Restriction)


def pad_axis(x: torch.Tensor, mult: int, axis: int = 0,
             fill=0) -> torch.Tensor:
    """x with ``axis`` padded by ``fill`` up to a multiple of ``mult``."""
    return _pad_to(x, -(-x.shape[axis] // mult) * mult, axis, fill)


def _pad_to(x: torch.Tensor, n: int, axis: int = 0, fill=0) -> torch.Tensor:
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def drop_fast_forms(h: SolverHierarchy) -> SolverHierarchy:
    """``h`` without its slab and uniform forms (ELL on every level)."""
    return h._replace(levels=tuple(
        lvl._replace(banded=None, uw=None, utw=None) for lvl in h.levels))


def pad_solver_fine_level(h: SolverHierarchy, mult: int) -> SolverHierarchy:
    """Pad the finest level to a row count divisible by ``mult`` (the
    coarser levels keep theirs; U^T's table stays valid, since padded
    fine rows carry zero weights, and only its fine count changes)."""
    lvl = h.levels[0]
    v = lvl.op.num_vertices
    vp = -(-v // mult) * mult
    if vp == v:
        return h
    op = lvl.op
    new_op = EllOperator(_pad_to(op.neighbors, vp, fill=INVALID_INDEX),
                         _pad_to(op.offdiag, vp), _pad_to(op.diag, vp,
                                                          fill=1.0))
    u = lvl.u
    if u is not None:
        u = Prolongation(_pad_to(u.cols, vp), _pad_to(u.weights, vp),
                         u.n_coarse)
    ut = lvl.ut._replace(n_fine=vp) if lvl.ut is not None else None
    return h._replace(levels=(lvl._replace(op=new_op, u=u, ut=ut),)
                      + h.levels[1:])


def pad_solver_to(h: SolverHierarchy, rows: Sequence[int],
                  degrees: Optional[Sequence[int]] = None,
                  children: Optional[Sequence[int]] = None
                  ) -> SolverHierarchy:
    """Pad level i to ``rows[i]`` rows (the coarsest level included, its
    factor extended by an identity block); with ``degrees`` also A's ELL
    width to ``degrees[i]`` slots and with ``children`` U^T's children
    table to ``children[i]`` slots (empty slots, INVALID_INDEX and 0).
    Returns ``h`` itself when nothing grows; otherwise the fast forms are
    dropped (their windows were placed for the old sizes)."""
    nlev = len(h.levels)
    rows = [int(r) for r in rows]
    sizes = [lvl.op.num_vertices for lvl in h.levels]
    degs = [lvl.op.max_degree for lvl in h.levels]
    kids = [lvl.ut.rows.shape[-1] if lvl.ut is not None else 0
            for lvl in h.levels]
    degrees = degs if degrees is None else [int(k) for k in degrees]
    children = kids if children is None else [int(c or 0) for c in children]
    if not len(rows) == len(degrees) == len(children) == nlev:
        raise ValueError(f"sizes for {len(rows)} levels, the hierarchy "
                         f"has {nlev}")
    if any(r < v for r, v in zip(rows + degrees + children,
                                 sizes + degs + kids)):
        raise ValueError(f"cannot shrink levels of {sizes} rows, widths "
                         f"{degs}, {kids} to {rows}, {degrees}, {children}")
    if (rows, degrees, children) == (sizes, degs, kids):
        return h
    levels = []
    for li, lvl in enumerate(h.levels):
        vp, k = rows[li], degrees[li]
        op = lvl.op
        op = EllOperator(
            _pad_to(_pad_to(op.neighbors, k, 1, INVALID_INDEX), vp, 0,
                    INVALID_INDEX),
            _pad_to(_pad_to(op.offdiag, k, 1), vp),
            _pad_to(op.diag, vp, fill=1.0))
        u = lvl.u
        if u is not None:
            u = Prolongation(_pad_to(u.cols, vp), _pad_to(u.weights, vp),
                             rows[li + 1])
        ut = lvl.ut
        if ut is not None:
            nc, c = rows[li + 1], children[li]
            ut = Restriction(
                _pad_to(_pad_to(ut.rows, c, 1, INVALID_INDEX), nc, 0,
                        INVALID_INDEX),
                _pad_to(_pad_to(ut.weights, c, 1), nc), vp)
        levels.append(lvl._replace(op=op, u=u, ut=ut))
    chol = h.coarse_chol
    vc, vcp = sizes[-1], rows[-1]
    if vcp > vc:
        ext = chol.new_zeros((vcp, vcp))
        ext[:vc, :vc] = chol
        idx = torch.arange(vc, vcp, device=chol.device)
        ext[idx, idx] = 1.0
        chol = ext
    return drop_fast_forms(h._replace(levels=tuple(levels),
                                      coarse_chol=chol))


def pad_solver_levels(h: SolverHierarchy, mult: int,
                      pad_coarse: bool = False) -> SolverHierarchy:
    """Pad every level but the coarsest (and it too with ``pad_coarse``)
    to a row count divisible by ``mult``.  The fast forms are dropped, as
    in the JAX package."""
    nlev = len(h.levels)
    rows = [(-(-lvl.op.num_vertices // mult) * mult
             if (li < nlev - 1 or pad_coarse) else lvl.op.num_vertices)
            for li, lvl in enumerate(h.levels)]
    return drop_fast_forms(pad_solver_to(h, rows))
