"""Vertex-sharded and batched solves over ``torch.distributed``
(counterpart of ``gravomg_tpu/parallel/sharding.py``), and the padding
they share with the mesh collections.

Padding: padded rows are decoupled identity rows (diag 1, no
neighbours, zero prolongation weights, INVALID restriction rows, and,
where the coarsest level grows, the Cholesky factor extended by an
identity block).  Zero is a fixed point of every padded row under
smoothing, transfer and the coarse solve, so a cycle on a zero-padded
right-hand side leaves the real rows as they were.
``parallel/batch.py`` pads a mesh collection to one shape this way.

Sharding: JAX lays the arrays out over a device ``Mesh`` and lets XLA
place the collectives; here every rank of an initialised process group
runs the same code on its own row block, with explicit collectives
(``parallel/launch.py``).  :func:`shard_solver` keeps this rank's rows
of every level's operator, U and U^T (the level's rows divided into
equal blocks, so pad first: :func:`pad_solver_levels`); the coarsest
level and its Cholesky factor stay whole on every rank, and so does any
level whose row count the world size does not divide.  A matvec
all-gathers its source vector, then gathers the rank's rows from it;
dot products are all-reduced partial dots.  Vectors of a sharded level
are this rank's row block, of a whole level the whole vector.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator
from gravomg_tpu_torch.ops.uniform_cuda import uniform_matvec
from gravomg_tpu_torch.parallel.launch import all_gather, all_reduce_sum
from gravomg_tpu_torch.prolong.operator import prolong, restrict_gather
from gravomg_tpu_torch.solve.cg import fcg, pcg
from gravomg_tpu_torch.solve.coarse import coarse_solve
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            apply_fast, attach_restrictions,
                                            smooth_with, v_cycle)
from gravomg_tpu_torch.types import (INVALID_INDEX, EllOperator, Prolongation,
                                     Restriction)
from gravomg_tpu_torch.utils.device import resolve_device


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


# ---------------------------------------------------------------------------
# The device mesh and the vertex-sharded hierarchy
# ---------------------------------------------------------------------------


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device_type: Optional[str] = None):
    """A one-dimensional ``DeviceMesh`` named ``axis`` over the ranks of
    the initialised default process group (``n_devices`` of them, all
    by default).  ``device_type`` is "cuda" unless the caller names
    another ("cpu" for gloo ranks on the CPU)."""
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = resolve_device(None).type
    n = n_devices or dist.get_world_size()
    return init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))


def mesh_rank(mesh, axis: str = "data"):
    """(process group, this rank's index, rank count) of ``axis``."""
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


class ShardedSolver(NamedTuple):
    """This rank's part of a vertex-sharded hierarchy.

    ``levels`` hold, for a sharded level, the rows ``spans[i]`` = (lo,
    hi) of its operator and U (global column ids) and, when the next
    level is sharded, that level's rows of U^T; a whole level holds
    everything.  ``n_rows[i]`` is level i's global row count and
    ``sharded[i]`` whether its vectors are row blocks.  Fast forms are
    row-local uniform forms (:func:`shard_fast_operator`) or whole."""

    levels: Tuple[SolverLevel, ...]
    coarse_chol: torch.Tensor
    spans: Tuple[Tuple[int, int], ...]
    n_rows: Tuple[int, ...]
    sharded: Tuple[bool, ...]


def _row_span(n: int, rank: int, nd: int, sharded: bool) -> Tuple[int, int]:
    if not sharded:
        return 0, n
    vd = n // nd
    return rank * vd, (rank + 1) * vd


def shard_fast_operator(bop, mesh, axis: str = "data"):
    """This rank's part of a uniform block-dense form: its row blocks of
    ``m``, ``win_start`` and ``diag``, and the escape entries of its own
    rows (row ids made local, padding slots pointing past them), when
    the block count divides the rank count and the blocks cover exactly
    the operator's rows; otherwise the whole form, which every rank then
    applies to all rows (correct, not scaled), as JAX replicates it.
    Slab forms, whose bucket permutation is a single-device layout, stay
    whole too.  Build the form with ``block = rows / ranks`` (or a
    divisor of it) to shard it."""
    if bop is None or not isinstance(bop, BlockDenseOperator):
        return bop
    _, rank, nd = mesh_rank(mesh, axis)
    nblk, blk = bop.m.shape[0], bop.m.shape[1]
    if nblk % nd or nblk * blk != bop.n_rows:
        return bop
    nb = nblk // nd
    lo, hi = rank * nb * blk, (rank + 1) * nb * blk
    sel = (bop.esc_rows >= lo) & (bop.esc_rows < hi)
    # The chute is sorted by row: this rank's entries are one run.
    esc = torch.nonzero(sel).reshape(-1)
    return bop._replace(
        m=bop.m[rank * nb:(rank + 1) * nb].contiguous(),
        win_start=bop.win_start[rank * nb:(rank + 1) * nb].contiguous(),
        diag=None if bop.diag is None else bop.diag[lo:hi].contiguous(),
        esc_rows=(bop.esc_rows[esc] - lo).contiguous(),
        esc_cols=bop.esc_cols[esc].contiguous(),
        esc_w=bop.esc_w[esc].contiguous(), n_rows=hi - lo)


def shard_solver(h: SolverHierarchy, mesh, axis: str = "data"
                 ) -> ShardedSolver:
    """This rank's part of a hierarchy padded with
    :func:`pad_solver_levels` (a level shards when the rank count
    divides its rows; the coarsest level never does).  Uniform fast
    forms attached after padding shard with :func:`shard_fast_operator`;
    other fast forms stay whole."""
    _, rank, nd = mesh_rank(mesh, axis)
    h = attach_restrictions(h)
    nlev = len(h.levels)
    n_rows = tuple(lvl.op.num_vertices for lvl in h.levels)
    sharded = tuple(li < nlev - 1 and n % nd == 0
                    for li, n in enumerate(n_rows))
    spans = tuple(_row_span(n, rank, nd, s) for n, s in zip(n_rows, sharded))

    def rows(t, span):
        return t[span[0]:span[1]].contiguous()

    levels = []
    for li, lvl in enumerate(h.levels):
        span = spans[li]
        op = EllOperator(rows(lvl.op.neighbors, span),
                         rows(lvl.op.offdiag, span), rows(lvl.op.diag, span))
        u = ut = None
        if lvl.u is not None:
            u = Prolongation(rows(lvl.u.cols, span), rows(lvl.u.weights, span),
                             lvl.u.n_coarse)
            cspan = spans[li + 1]
            ut = Restriction(rows(lvl.ut.rows, cspan),
                             rows(lvl.ut.weights, cspan), lvl.ut.n_fine)
        # A form's rows split only where its level's vectors do: A's and
        # U's with level li, U^T's with level li + 1.
        fast = {f: (shard_fast_operator(getattr(lvl, f), mesh, axis)
                    if sharded[li + (f == "utw")] else getattr(lvl, f))
                for f in ("banded", "uw", "utw")
                if getattr(lvl, f) is not None}
        levels.append(lvl._replace(op=op, u=u, ut=ut, **fast))
    return ShardedSolver(levels=tuple(levels), coarse_chol=h.coarse_chol,
                         spans=spans, n_rows=n_rows, sharded=sharded)


def _whole(x: torch.Tensor, sharded: bool, group) -> torch.Tensor:
    """The whole vector of a level from this rank's part of it."""
    return all_gather(x, group) if sharded else x


def _fast_rows(form, x_full: torch.Tensor, span) -> torch.Tensor:
    """Rows ``span`` of a fast form's product with the whole x: a
    row-local uniform form computes only them, a whole form all rows."""
    if (isinstance(form, BlockDenseOperator)
            and form.n_rows == span[1] - span[0]):
        y = uniform_matvec(form._replace(diag=None), x_full)
        if form.diag is None:
            return y
        diag = form.diag if x_full.ndim == 1 else form.diag[:, None]
        return y + diag * x_full[span[0]:span[1]]
    return apply_fast(form, x_full)[span[0]:span[1]]


def _ell_rows(op: EllOperator, x_full: torch.Tensor,
              x_local: torch.Tensor) -> torch.Tensor:
    """This rank's rows of A x (``spmv``'s arithmetic, row for row)."""
    safe = op.safe_neighbors()
    w = torch.where(op.mask, op.offdiag, torch.zeros_like(op.offdiag))
    if x_full.ndim == 1:
        return op.diag * x_local + torch.sum(w * x_full[safe], dim=1)
    return (op.diag[:, None] * x_local
            + torch.einsum("vk,vkd->vd", w, x_full[safe]))


def sharded_matvec(hs: ShardedSolver, li: int, x: torch.Tensor,
                   group) -> torch.Tensor:
    """This rank's rows of A_li x, x this rank's part of level li."""
    lvl, span = hs.levels[li], hs.spans[li]
    x_full = _whole(x, hs.sharded[li], group)
    if lvl.banded is not None:
        return _fast_rows(lvl.banded, x_full, span)
    return _ell_rows(lvl.op, x_full, x)


def _restrict(hs: ShardedSolver, li: int, r: torch.Tensor, group):
    """Level li+1's part of U^T r, r this rank's part of level li."""
    lvl, cspan = hs.levels[li], hs.spans[li + 1]
    r_full = _whole(r, hs.sharded[li], group)
    if lvl.utw is not None:
        return _fast_rows(lvl.utw, r_full, cspan)
    return restrict_gather(lvl.ut, r_full)


def _prolong(hs: ShardedSolver, li: int, ec: torch.Tensor, group):
    """Level li's part of U ec, ec level li+1's part on this rank."""
    lvl, span = hs.levels[li], hs.spans[li]
    ec_full = _whole(ec, hs.sharded[li + 1], group)
    if lvl.uw is not None:
        return _fast_rows(lvl.uw, ec_full, span)
    return prolong(lvl.u, ec_full)


def _sharded_descend(hs: ShardedSolver, li: int, x, b,
                     cfg: MultigridConfig, group, x0_zero: bool = False):
    if li == len(hs.levels) - 1:
        return coarse_solve(hs.coarse_chol, b)
    lvl = hs.levels[li]
    mv = functools.partial(sharded_matvec, hs, li, group=group)
    x = smooth_with(lvl.op, lvl.cheb, mv, x, b, cfg.pre_smooth, cfg,
                    x0_zero=x0_zero)
    r = b - mv(x)
    rc = _restrict(hs, li, r, group)
    ec = _sharded_descend(hs, li + 1, torch.zeros_like(rc), rc, cfg, group,
                          x0_zero=True)
    if li + 1 < len(hs.levels) - 1:
        for _ in range(cfg.cycle_gamma - 1):
            ec = _sharded_descend(hs, li + 1, ec, rc, cfg, group)
    x = x + _prolong(hs, li, ec, group)
    return smooth_with(lvl.op, lvl.cheb, mv, x, b, cfg.post_smooth, cfg)


def sharded_v_cycle(hs: ShardedSolver, x: torch.Tensor, b: torch.Tensor,
                    cfg: MultigridConfig, mesh, axis: str = "data",
                    x0_zero: bool = False) -> torch.Tensor:
    """One cycle (``v_cycle``'s recursion) with x and b this rank's part
    of the finest level."""
    group, _, _ = mesh_rank(mesh, axis)
    return _sharded_descend(hs, 0, x, b, cfg, group, x0_zero=x0_zero)


def sharded_dot(group):
    """The dot product of two row-sharded vectors: this rank's partial
    dot, all-reduced (every rank receives the same value)."""
    return lambda a, b: all_reduce_sum(torch.dot(a, b), group)


def local_rows(x: torch.Tensor, span: Tuple[int, int], n: int):
    """This rank's rows of a global vector padded to ``span``'s level,
    cut to the first ``n`` global rows (rows of padding dropped)."""
    return x[:max(min(span[1], n) - span[0], 0)]


def sharded_solve(hs: ShardedSolver, b: torch.Tensor, cfg: MultigridConfig,
                  mesh, axis: str = "data", method: str = "mg_pcg"):
    """MG-preconditioned CG (``method`` "mg_pcg") or flexible CG
    ("mg_fcg") to ``cfg.tolerance`` with every sharded level's vectors
    row-sharded.  ``b`` is the whole UNPADDED right-hand side (every
    rank passes the same).  Returns (this rank's rows of x among the
    first len(b), relative residual, iterations); the residual and the
    count are the same on every rank."""
    group, _, _ = mesh_rank(mesh, axis)
    fn = {"mg_pcg": pcg, "mg_fcg": fcg}[method]
    span, n = hs.spans[0], b.shape[0]
    bp = b.new_zeros((hs.n_rows[0],))
    bp[:n] = b
    bl = bp[span[0]:span[1]].contiguous()
    dot = sharded_dot(group) if hs.sharded[0] else None

    def precond(r):
        return _sharded_descend(hs, 0, torch.zeros_like(r), r, cfg, group,
                                x0_zero=True)

    x, rel, it = fn(hs.levels[0].op, bl, precond, tol=cfg.tolerance,
                    max_iters=cfg.max_cycles,
                    mv=functools.partial(sharded_matvec, hs, 0, group=group),
                    dot=dot)
    return local_rows(x, span, n), rel, it


def batched_vcycle(h: SolverHierarchy, cfg: MultigridConfig, mesh,
                   axis: str = "data"):
    """A function (xs, bs) -> this rank's rows of one V-cycle per
    right-hand side, for (B, V) xs and bs whole on every rank: rank r
    takes rows [r B/n, (r+1) B/n) (B a multiple of the rank count) and
    runs them as one (V, B/n) cycle on the whole hierarchy ``h``, fast
    forms included (the 8-row slab forms take the batched kernel B1).
    One hierarchy, many right-hand sides, the batch split over ranks."""
    _, rank, nd = mesh_rank(mesh, axis)

    def step(xs: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
        if xs.shape[0] % nd:
            raise ValueError(f"{xs.shape[0]} right-hand sides do not split "
                             f"over {nd} ranks")
        per = xs.shape[0] // nd
        sl = slice(rank * per, (rank + 1) * per)
        out = v_cycle(h, xs[sl].T.contiguous(), bs[sl].T.contiguous(), cfg)
        return out.T.contiguous()

    return step


def vertex_sharded_cg_step(hs: ShardedSolver, cfg: MultigridConfig, mesh,
                           axis: str = "data"):
    """A function (x, r, p, rz) -> (x, r, p, rz_new): one
    MG-preconditioned CG step with the fine vectors this rank's rows
    (``rz`` the all-reduced r.z, a 0-d tensor)."""
    group, _, _ = mesh_rank(mesh, axis)
    dot = sharded_dot(group) if hs.sharded[0] else torch.dot

    def step(x, r, p, rz):
        ap = sharded_matvec(hs, 0, p, group)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = _sharded_descend(hs, 0, torch.zeros_like(r), r, cfg, group,
                             x0_zero=True)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new

    return step
