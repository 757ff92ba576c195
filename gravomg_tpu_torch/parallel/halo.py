"""Halo-exchange vertex sharding: O(edge-cut) communication per matvec
(counterpart of ``gravomg_tpu/parallel/halo.py``).

The all-gather path (``parallel/sharding.py``) moves the whole source
vector to every rank before each row gather.  Here each rank owns a
contiguous block of the (Morton-ordered) rows, and the only remote
values it reads are the entries of x that its rows' off-block columns
name: the edge cut of the block partition.

  * Rows are block-partitioned over the ranks: rank d owns rows
    [d*vd, (d+1)*vd); the source vector likewise in blocks of vs.
  * :func:`build_halo_ell` (host-side numpy, a copy of the JAX
    package's plan) computes, per ordered rank pair (o -> d), the
    sorted unique o-local source indices rank d needs: the table
    ``send_idx[o, d, :]``, padded to the largest segment S (a multiple
    of ``s_round``; pad slots point at index 0), and remaps each row's
    columns into d's local coordinates: ``[0, vs)`` its own block,
    ``vs + o*S + p`` slot p of what rank o sent.
  * :func:`halo_matvec`: ``buf = x[send_idx[rank]]`` (nd, S[, D]), one
    equal-split ``all_to_all_single`` (the exchange
    ``lax.all_to_all(..., tiled=True)`` makes in JAX), the received
    halo appended after the local block, then the local ELL product.
    Per rank and matvec nd*S elements cross instead of the n_src of an
    all-gather (``HaloOperator.halo_frac``).

The coarsest level is padded too (``pad_solver_levels(h, nd,
pad_coarse=True)``): each rank all-gathers its part of the coarse
right-hand side, solves with the whole Cholesky factor and keeps its
own rows.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.parallel.launch import all_gather, all_to_all
from gravomg_tpu_torch.parallel.sharding import (local_rows, mesh_rank,
                                                 sharded_dot)
from gravomg_tpu_torch.solve.cg import fcg, pcg
from gravomg_tpu_torch.solve.coarse import coarse_solve
from gravomg_tpu_torch.solve.smoothers import ChebyshevParams
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            smooth_with)
from gravomg_tpu_torch.utils.device import resolve_device


class HaloOperator(NamedTuple):
    """Row-sharded ELL operator with a static halo-exchange plan.

    From :func:`build_halo_ell` the arrays are global: cols (R, K) local
    column ids (see the module doc; invalid entries point at 0 with
    weight 0), vals (R, K), diag (R,) or None for a rectangular
    operator, send_idx (nd, nd, S).  After :func:`shard_halo_operator`
    they are this rank's: its vd rows, and send_idx (1, nd, S), the
    indices it ships to each rank.  n_rows, n_src, s and nd stay global.
    """

    cols: torch.Tensor
    vals: torch.Tensor
    diag: Optional[torch.Tensor]
    send_idx: torch.Tensor
    n_rows: int
    n_src: int
    s: int
    nd: int

    @property
    def halo_frac(self) -> float:
        """Elements exchanged per matvec over the all-gather's."""
        return (self.nd * self.s) / self.n_src


def build_halo_ell(cols: np.ndarray, vals: np.ndarray, valid: np.ndarray,
                   n_src: int, nd: int, diag: Optional[np.ndarray] = None,
                   s_round: int = 8, device=None) -> HaloOperator:
    """The halo-exchange plan of an (R, K) ELL table (host-side numpy),
    as tensors on ``device`` (the card unless it names another).

    ``cols``/``vals``/``valid``: the global column table; ``n_src`` the
    source vector's length.  R and n_src must divide by ``nd`` (pad
    first: ``pad_solver_levels``).  Zero-weight entries (pad slots of U
    rows, decoupled pad rows) stay out of the plan."""
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    valid = np.asarray(valid) & (vals != 0)
    r, k = cols.shape
    if r % nd or n_src % nd:
        raise ValueError(f"rows {r} / n_src {n_src} not divisible by {nd}")
    vd, vs = r // nd, n_src // nd
    owner = np.where(valid, cols // vs, -1)

    # Per ordered pair (owner o -> requester d): the sorted unique
    # o-local source indices that d's rows reference.
    need = [[np.zeros(0, np.int64)] * nd for _ in range(nd)]
    smax = 0
    for d in range(nd):
        sl = slice(d * vd, (d + 1) * vd)
        c, ow = cols[sl].ravel(), owner[sl].ravel()
        for o in range(nd):
            if o == d:
                continue
            uniq = np.unique(c[ow == o]) - o * vs
            need[o][d] = uniq
            smax = max(smax, len(uniq))
    s = max(-(-max(smax, 1) // s_round) * s_round, s_round)

    send_idx = np.zeros((nd, nd, s), np.int32)
    for o in range(nd):
        for d in range(nd):
            lst = need[o][d]
            send_idx[o, d, :len(lst)] = lst

    # Global columns into each row block's local coordinates.
    local = np.zeros_like(cols, dtype=np.int32)
    for d in range(nd):
        sl = slice(d * vd, (d + 1) * vd)
        blk, ob = cols[sl], owner[sl]
        loc = blk - d * vs
        for o in range(nd):
            if o == d:
                continue
            m = ob == o
            if not m.any():
                continue
            pos = np.searchsorted(need[o][d], blk[m] - o * vs)
            loc[m] = vs + o * s + pos
        local[sl] = np.where(ob == -1, 0, loc)

    dev = resolve_device(device)
    return HaloOperator(
        cols=torch.as_tensor(local, device=dev),
        vals=torch.as_tensor(np.where(valid, vals, 0.0).astype(vals.dtype),
                             device=dev),
        diag=None if diag is None else torch.as_tensor(np.asarray(diag),
                                                       device=dev),
        send_idx=torch.as_tensor(send_idx, device=dev),
        n_rows=r, n_src=int(n_src), s=int(s), nd=nd)


def shard_halo_operator(op: HaloOperator, mesh,
                        axis: str = "data") -> HaloOperator:
    """This rank's rows of the operator and its row of the send table."""
    _, rank, nd = mesh_rank(mesh, axis)
    if nd != op.nd:
        raise ValueError(f"a plan for {op.nd} ranks on a mesh of {nd}")
    vd = op.n_rows // nd
    sl = slice(rank * vd, (rank + 1) * vd)
    return op._replace(
        cols=op.cols[sl].contiguous(), vals=op.vals[sl].contiguous(),
        diag=None if op.diag is None else op.diag[sl].contiguous(),
        send_idx=op.send_idx[rank:rank + 1].contiguous())


def halo_matvec(op: HaloOperator, x: torch.Tensor, mesh,
                axis: str = "data") -> torch.Tensor:
    """This rank's rows of y = A x with one halo exchange; x is this
    rank's block of the (n_src,) source or of an (n_src, D) block of
    right-hand sides."""
    group, _, _ = mesh_rank(mesh, axis)
    recv = all_to_all(x[op.send_idx[0]], group)       # (nd, S[, D])
    xx = torch.cat([x, recv.reshape((-1,) + tuple(x.shape[1:]))])
    if x.ndim == 1:
        y = torch.sum(op.vals * xx[op.cols], dim=1)
        return y + op.diag * x if op.diag is not None else y
    y = torch.einsum("vk,vkd->vd", op.vals, xx[op.cols])
    return y + op.diag[:, None] * x if op.diag is not None else y


# ---------------------------------------------------------------------------
# Halo-sharded solver hierarchy
# ---------------------------------------------------------------------------


class HaloLevel(NamedTuple):
    op: HaloOperator                    # square, with diag
    u: Optional[HaloOperator]           # prolongation rows (fine x coarse)
    ut: Optional[HaloOperator]          # restriction rows (coarse x fine)
    cheb: Optional[ChebyshevParams]


class HaloSolver(NamedTuple):
    levels: Tuple[HaloLevel, ...]
    coarse_chol: torch.Tensor           # whole on every rank


def level_plans(lvl: SolverLevel, nd: int, device=None):
    """The global halo plans (:func:`build_halo_ell`, on the host) of a
    padded level's A, U and U^T (None where the level has no U), built
    from the ELL arrays as the JAX package's ``halo_shard_solver`` builds
    them, the tensors placed on ``device`` (the level's by default)."""
    dev = lvl.op.diag.device if device is None else device

    def plan(cols, vals, valid, n_src, diag=None):
        return build_halo_ell(
            cols.cpu().numpy(), vals.cpu().numpy(), valid.cpu().numpy(),
            n_src, nd, diag=None if diag is None else diag.cpu().numpy(),
            device=dev)

    op = lvl.op
    hop = plan(op.neighbors, op.offdiag, op.mask, op.num_vertices, op.diag)
    hu = hut = None
    if lvl.u is not None:
        u = lvl.u
        hu = plan(u.cols, u.weights, torch.ones_like(u.cols, dtype=torch.bool),
                  u.n_coarse)
    if lvl.ut is not None:
        hut = plan(lvl.ut.rows, lvl.ut.weights, lvl.ut.mask, lvl.ut.n_fine)
    return hop, hu, hut


def halo_shard_solver(h: SolverHierarchy, mesh,
                      axis: str = "data") -> HaloSolver:
    """This rank's halo form of a hierarchy whose every level's row
    count divides by the rank count (``pad_solver_levels(h, nd,
    pad_coarse=True)``), the plans built on the host and the arrays
    placed on the hierarchy's device.  The coarsest level's Cholesky
    factor stays whole."""
    _, _, nd = mesh_rank(mesh, axis)
    levels = []
    for lvl in h.levels:
        hop, hu, hut = (None if p is None
                        else shard_halo_operator(p, mesh, axis)
                        for p in level_plans(lvl, nd))
        levels.append(HaloLevel(op=hop, u=hu, ut=hut, cheb=lvl.cheb))
    return HaloSolver(levels=tuple(levels), coarse_chol=h.coarse_chol)


def _halo_coarse(hs: HaloSolver, b: torch.Tensor, mesh, axis: str):
    """This rank's rows of the coarsest level's exact solve."""
    group, rank, _ = mesh_rank(mesh, axis)
    x = coarse_solve(hs.coarse_chol, all_gather(b, group))
    vd = b.shape[0]
    return x[rank * vd:(rank + 1) * vd]


def _halo_descend(hs: HaloSolver, li: int, x, b, cfg: MultigridConfig,
                  mesh, axis: str, x0_zero: bool = False):
    if li == len(hs.levels) - 1:
        return _halo_coarse(hs, b, mesh, axis)
    lvl = hs.levels[li]
    mv = functools.partial(halo_matvec, lvl.op, mesh=mesh, axis=axis)
    x = smooth_with(lvl.op, lvl.cheb, mv, x, b, cfg.pre_smooth, cfg,
                    x0_zero=x0_zero)
    r = b - mv(x)
    rc = halo_matvec(lvl.ut, r, mesh, axis)
    # Coarse corrections start from zero: x0_zero skips their
    # pre-smooth's first matvec and its exchange on every rank alike.
    ec = _halo_descend(hs, li + 1, torch.zeros_like(rc), rc, cfg, mesh, axis,
                       x0_zero=True)
    if li + 1 < len(hs.levels) - 1:
        for _ in range(cfg.cycle_gamma - 1):
            ec = _halo_descend(hs, li + 1, ec, rc, cfg, mesh, axis)
    x = x + halo_matvec(lvl.u, ec, mesh, axis)
    return smooth_with(lvl.op, lvl.cheb, mv, x, b, cfg.post_smooth, cfg)


def halo_v_cycle(hs: HaloSolver, x: torch.Tensor, b: torch.Tensor,
                 cfg: MultigridConfig, mesh, axis: str = "data",
                 x0_zero: bool = False) -> torch.Tensor:
    """One multigrid cycle on this rank's rows, every operator
    application a halo exchange instead of an all-gather."""
    return _halo_descend(hs, 0, x, b, cfg, mesh, axis, x0_zero=x0_zero)


def halo_solve(hs: HaloSolver, b: torch.Tensor, cfg: MultigridConfig,
               mesh, axis: str = "data", n_real: Optional[int] = None,
               method: str = "mg_pcg"):
    """MG-preconditioned CG (or flexible CG, ``method`` "mg_fcg") with
    halo-sharded levels.  ``b`` is the whole unpadded right-hand side
    (every rank passes the same); returns (this rank's rows of x among
    the first ``n_real`` (default len(b)) global rows, relative residual,
    iterations), the last two the same on every rank."""
    group, rank, nd = mesh_rank(mesh, axis)
    fn = {"mg_pcg": pcg, "mg_fcg": fcg}[method]
    n = b.shape[0] if n_real is None else n_real
    op0 = hs.levels[0].op
    vd = op0.n_rows // nd
    bp = b.new_zeros((op0.n_rows,))
    bp[:b.shape[0]] = b
    span = (rank * vd, (rank + 1) * vd)
    bl = bp[span[0]:span[1]].contiguous()

    def precond(r):
        return _halo_descend(hs, 0, torch.zeros_like(r), r, cfg, mesh, axis,
                             x0_zero=True)

    x, rel, it = fn(op0, bl, precond, tol=cfg.tolerance,
                    max_iters=cfg.max_cycles,
                    mv=functools.partial(halo_matvec, op0, mesh=mesh,
                                         axis=axis),
                    dot=sharded_dot(group))
    return local_rows(x, span, n), rel, it
