"""Implicit Laplacian smoothing of a point cloud (counterpart of
``gravomg_tpu/apps/smoothing.py``).

Backward Euler, (M + t L) V_new = M V_old, all three coordinates in one
solve with a (V, 3) right-hand side on the refitted hierarchy.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from gravomg_tpu_torch.apps.heat import mean_edge_length, refit_hierarchy
from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.hierarchy import Hierarchy
from gravomg_tpu_torch.solve.vcycle import SolverHierarchy, solve
from gravomg_tpu_torch.types import Graph
from gravomg_tpu_torch.utils.stage import stage


def implicit_smooth(graph: Graph, h: Union[Hierarchy, SolverHierarchy],
                    t_factor: float = 1.0, steps: int = 1,
                    cfg: MultigridConfig = MultigridConfig(),
                    record: Optional[dict] = None) -> torch.Tensor:
    """Vertex positions after ``steps`` implicit steps, t = ``t_factor``
    times the squared mean edge length.  Each step is one stationary
    :func:`solve` with a (V, 3) right-hand side: U and U^T take the
    batched kernel B1 on every 8-row slab form the refit keeps, and A
    runs on the ELL gather (the refit drops its forms, as its values
    change).  ``record`` (a dict) receives the refit's seconds and,
    per step, the solve's seconds, cycles and relative residual."""
    lap, mass = graph_laplacian(graph, "invdist")
    t = t_factor * mean_edge_length(graph) ** 2
    op = lap._replace(diag=lap.diag * t + mass, offdiag=lap.offdiag * t)
    dev = mass.device
    with stage(record, "refit_s", dev):
        sh = refit_hierarchy(h, op, cfg)
    pts = graph.points
    for _ in range(steps):
        step = None if record is None else {}
        with stage(step, "solve_s", dev):
            pts, rel, it = solve(sh, mass[:, None] * pts, cfg)
        if record is not None:
            record.setdefault("steps", []).append(
                {**step, "cycles": it, "rel": rel})
    return pts
