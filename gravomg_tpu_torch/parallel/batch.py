"""Batched multi-mesh solves (counterpart of
``gravomg_tpu/parallel/batch.py``): a collection of hierarchies stacked
along a leading mesh axis and driven by one cycle.

The JAX package stacks meshes whose levels share a size bucket.  The
port's levels hold real rows only, so :func:`stack_solvers` first pads
every level of every mesh to that level's largest row count in the
collection, and its ELL and children tables to the widest
(``parallel/sharding.py::pad_solver_to``: decoupled identity rows and
empty slots, zero a fixed point), then stacks.  The stacked cycle is the
port's own ``v_cycle``: ``spmv``, the smoothers (one Chebyshev interval
per mesh, as (B,) tensors), the transfers, ``coarse_solve`` (one factor
per mesh) and the uniform block-dense forms take the leading axis, so
each mesh gets the numbers of its own cycle.  A block-diagonal
concatenation would share one Chebyshev interval across the meshes and
build a (B * n_c)^2 coarse factor; it is not used.  Slab forms do not
stack (their buckets depend on each mesh's data): :func:`attach_collection`
gives uniform forms with one shared geometry instead, as in JAX.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.ops.slab import SlabOperator
from gravomg_tpu_torch.parallel.sharding import (drop_fast_forms,
                                                 pad_solver_to)
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy,
                                            attach_fast_operators, v_cycle)


def _same_shape(a, b) -> bool:
    """Whether two hierarchies (or parts of them) stack: the same
    structure, tensors of one shape, dtype and device, equal sizes and
    flags; floats (Chebyshev bounds) may differ.  Slab forms never
    stack."""
    if type(a) is not type(b) or isinstance(a, SlabOperator):
        return False
    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and a.dtype == b.dtype \
            and a.device == b.device
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same_shape(x, y)
                                        for x, y in zip(a, b))
    return isinstance(a, float) or a == b


def stackable(hs: Sequence[SolverHierarchy]) -> bool:
    """True if all hierarchies share their level count and shapes."""
    return all(_same_shape(hs[0], h) for h in hs)


def _stack(objs, device):
    first = objs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(objs)
    if isinstance(first, float):
        return torch.tensor(objs, dtype=torch.float64, device=device)
    if isinstance(first, tuple):
        items = [_stack([o[i] for o in objs], device)
                 for i in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") \
            else tuple(items)
    return first            # None, sizes and flags: equal across objs


def pad_collection(hs: Sequence[SolverHierarchy]
                   ) -> List[SolverHierarchy]:
    """Every level of every hierarchy padded to the collection's largest
    row count, ELL width and U^T children width of that level
    (``pad_solver_to``).  Raises if the level counts differ."""
    counts = {len(h.levels) for h in hs}
    if len(counts) != 1:
        raise ValueError(f"hierarchies of {sorted(counts)} levels do not "
                         f"stack: the level counts must agree")
    nlev = counts.pop()

    def most(size):
        return [max(size(h.levels[li]) for h in hs) for li in range(nlev)]

    rows = most(lambda lvl: lvl.op.num_vertices)
    degrees = most(lambda lvl: lvl.op.max_degree)
    children = most(lambda lvl: 0 if lvl.ut is None
                    else lvl.ut.rows.shape[-1])
    return [pad_solver_to(h, rows, degrees, children) for h in hs]


def stack_solvers(hs: Sequence[SolverHierarchy]) -> SolverHierarchy:
    """Pad every level of every hierarchy to that level's largest sizes
    in the collection (:func:`pad_collection`), then stack along a new
    leading axis.
    Chebyshev bounds become (B,) float64 tensors.  Raises if the level
    counts differ, or if the padded hierarchies still differ in shape
    (fast forms attached before padding: use :func:`attach_collection`)."""
    hs = pad_collection(hs)
    if not stackable(hs):
        raise ValueError("the padded hierarchies differ in shape (fast "
                         "forms of different geometry, or slab forms)")
    return _stack(hs, hs[0].coarse_chol.device)


def attach_collection(hs: Sequence[SolverHierarchy], block: int = 256,
                      window: int = 128, dtype=None
                      ) -> List[SolverHierarchy]:
    """The collection padded to one row count per level, with uniform
    block-dense forms of IDENTICAL shapes on every mesh, so the results
    stack.

    ``attach_fast_operators`` alone picks each operator's window count
    and escape capacity by a retry that depends on the data, and trims
    the escape chute to its fill.  Here every mesh is converted with
    trimming off and a shared (nw, cap) floor, raised to the largest any
    mesh needed and converted again until all agree (a fixpoint, as
    ``gravomg_tpu/parallel/batch.py:43-81``).  Fast forms already
    attached are replaced; slab forms are never made."""
    hs = [drop_fast_forms(h) for h in pad_collection(hs)]
    geo: dict = {}
    for _ in range(8):
        outs, grown = [], False
        for h in hs:
            used: dict = {}
            outs.append(attach_fast_operators(
                h, block=block, window=window, dtype=dtype, trim=False,
                geometry=geo, used_geometry=used))
            for k, v in used.items():
                cur = geo.get(k, (0, 0))
                nv = (max(v[0], cur[0]), max(v[1], cur[1]))
                if nv != cur:
                    geo[k] = nv
                    grown = grown or cur != (0, 0)
        if not grown:
            return outs
    raise RuntimeError("attach_collection geometry did not converge")


def _check_stack(hb: SolverHierarchy, xs: torch.Tensor) -> None:
    if hb.coarse_chol.ndim != 3:
        raise ValueError("expected a stacked hierarchy (stack_solvers)")
    shape = (hb.coarse_chol.shape[0], hb.levels[0].op.num_vertices)
    if tuple(xs.shape) != shape:
        raise ValueError(f"expected (meshes, rows) = {shape}, got "
                         f"{tuple(xs.shape)}")


def batched_v_cycle(hb: SolverHierarchy, xs: torch.Tensor, bs: torch.Tensor,
                    cfg: MultigridConfig) -> torch.Tensor:
    """One V-cycle per mesh of the stacked ``hb``: xs, bs (B, V)."""
    _check_stack(hb, xs)
    _check_stack(hb, bs)
    return v_cycle(hb, xs, bs, cfg)


def batched_solve(hb: SolverHierarchy, bs: torch.Tensor,
                  cfg: MultigridConfig):
    """Stationary V-cycle solves of every mesh with one shared iteration
    count: cycles until every mesh's relative residual (ELL form) is at
    most ``cfg.tolerance`` or ``cfg.max_cycles`` is reached.  Returns
    (xs, relative residuals (B,), iterations); the stopping test reads
    the largest residual on the host each cycle."""
    _check_stack(hb, bs)
    a0 = hb.levels[0].op
    bnorm = torch.linalg.norm(bs, dim=1).clamp(min=1e-30)

    def rel(xs):
        return torch.linalg.norm(bs - spmv(a0, xs), dim=1) / bnorm

    xs = torch.zeros_like(bs)
    rels, it = rel(xs), 0
    while float(rels.max()) > cfg.tolerance and it < cfg.max_cycles:
        xs = v_cycle(hb, xs, bs, cfg)
        rels = rel(xs)
        it += 1
    return xs, rels, it
