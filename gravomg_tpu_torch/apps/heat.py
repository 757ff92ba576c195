"""Geodesic distance by the heat method on a reused hierarchy
(counterpart of ``gravomg_tpu/apps/heat.py``).

Two solves on the levels of one hierarchy, refitted to each operator
(the coarsening, parents and U stay; only the Galerkin chain is redone):
  1. heat step:     (M + t L) u = M delta_source
  2. Poisson step:  (L + eps M) phi = div X - mean(div X),
X = -sign of the edge gradient of u.  The gradient lives on the graph's
directed edges, g_ij = (u_j - u_i) / d_ij; the divergence at i sums
X_ij / d_ij over its edges.  phi is shifted to phi[source] = 0 and
scaled to a mean edge gradient of 1.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.hierarchy import Hierarchy
from gravomg_tpu_torch.solve.cg import mg_pcg
from gravomg_tpu_torch.solve.coarse import factor_coarse
from gravomg_tpu_torch.solve.rap import galerkin_rap
from gravomg_tpu_torch.solve.smoothers import ChebyshevParams
from gravomg_tpu_torch.solve.vcycle import SolverHierarchy, SolverLevel
from gravomg_tpu_torch.types import EllOperator, Graph
from gravomg_tpu_torch.utils.stage import stage


def refit_hierarchy(h: Union[Hierarchy, SolverHierarchy],
                    new_fine_op: EllOperator,
                    cfg: MultigridConfig) -> SolverHierarchy:
    """The solver hierarchy of ``h`` (a :class:`Hierarchy` or a
    :class:`SolverHierarchy`) for a new fine operator: the Galerkin
    chain U^T A U redone from ``new_fine_op``, U unchanged.

    U's gather table and its fast forms (``ut``, ``uw``, ``utw``) are
    kept, since U did not change; ``banded`` is dropped, since A's values
    did.  Chebyshev bounds (for ``cfg.smoother == "chebyshev"``) and the
    coarsest factor are recomputed.
    """
    hs = h.solver if isinstance(h, Hierarchy) else h
    ops = [new_fine_op]
    for lvl in hs.levels[:-1]:
        ops.append(galerkin_rap(ops[-1], lvl.u, cfg.degree_multiple))
    levels = tuple(
        SolverLevel(op=o, u=old.u, ut=old.ut, uw=old.uw, utw=old.utw,
                    cheb=(ChebyshevParams.from_operator(o, cfg.chebyshev_ratio)
                          if cfg.smoother == "chebyshev" else None))
        for o, old in zip(ops, hs.levels))
    return SolverHierarchy(levels=levels, coarse_chol=factor_coarse(ops[-1]))


def mean_edge_length(graph: Graph) -> torch.Tensor:
    """Mean length of the graph's edges (0-d tensor)."""
    mask = graph.mask
    return (torch.sum(torch.where(mask, graph.distances,
                                  torch.zeros_like(graph.distances)))
            / torch.sum(mask))


def _solve(name: str, h, op: EllOperator, b: torch.Tensor,
           cfg: MultigridConfig, record: Optional[dict]):
    """MG-PCG on ``h`` refitted to ``op``; the refit's and the solve's
    seconds, iterations and residual into ``record``."""
    with stage(record, f"refit_{name}_s", b.device):
        sh = refit_hierarchy(h, op, cfg)
    with stage(record, f"{name}_s", b.device):
        x, rel, it = mg_pcg(sh, b, cfg)
    if record is not None:
        record[f"{name}_iters"], record[f"{name}_rel"] = it, rel
    return x


def _edge_lengths(graph: Graph) -> torch.Tensor:
    """(V, K) edge lengths, +inf in the padding slots."""
    return torch.where(graph.mask, graph.distances,
                       torch.full_like(graph.distances, float("inf")))


def edge_field(graph: Graph, u: torch.Tensor):
    """(edge gradient (V, K) of ``u``, unit edge field -sign(gradient)).
    Padding slots have a zero gradient; a zero gradient gives a zero
    field, as ``jnp.sign`` does."""
    grad = (u[graph.safe_neighbors()] - u[:, None]) / _edge_lengths(graph)
    return grad, -torch.sign(grad)


def heat_geodesics(graph: Graph, h: Union[Hierarchy, SolverHierarchy],
                   source: int, t_factor: float = 1.0,
                   cfg: MultigridConfig = MultigridConfig(),
                   record: Optional[dict] = None) -> torch.Tensor:
    """Approximate geodesic distance from ``source`` to every vertex, on
    the device of the graph.

    ``h`` is reused for both solves (see :func:`refit_hierarchy`); both
    are MG-PCG, since stationary f32 cycles stall above a 1e-8
    tolerance.  ``record`` (a dict) receives per solve (``heat``,
    ``poisson``) the seconds of its refit and of its solve, its
    iterations and its relative residual."""
    lap, mass = graph_laplacian(graph, "invdist")
    mask = graph.mask
    t = t_factor * mean_edge_length(graph) ** 2

    heat_op = lap._replace(diag=lap.diag * t + mass, offdiag=lap.offdiag * t)
    delta = torch.zeros_like(mass)
    delta[source] = 1.0
    u = _solve("heat", h, heat_op, mass * delta, cfg, record)

    _, xdir = edge_field(graph, u)
    d = _edge_lengths(graph)
    w = torch.where(mask, 1.0 / torch.clamp(d, min=1e-8),
                    torch.zeros_like(d))
    div = torch.sum(w * xdir, dim=1)
    # L is singular on constants: shift it by the same floor as
    # screened_poisson_operator(alpha="auto"), 1e-4 of the mean
    # diagonal, which stays representable in f32 at any density.
    eps = 1e-4 * torch.mean(lap.diag) / torch.mean(mass)
    pois_op = lap._replace(diag=lap.diag + eps * mass)
    phi = _solve("poisson", h, pois_op, div - torch.mean(div), cfg, record)
    phi = phi[source] - phi          # increasing away from the source
    # Unit speed: the mean |edge gradient| of phi becomes 1.
    gphi = torch.abs(phi[graph.safe_neighbors()] - phi[:, None]) / d
    mean_grad = (torch.sum(torch.where(mask, gphi, torch.zeros_like(gphi)))
                 / torch.clamp(torch.sum(mask), min=1))
    return phi / torch.clamp(mean_grad, min=1e-12)
