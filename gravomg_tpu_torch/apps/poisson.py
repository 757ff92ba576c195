"""Screened-Poisson operator (counterpart of
``gravomg_tpu/apps/poisson.py::screened_poisson_operator``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.types import EllOperator, Graph


def screened_poisson_operator(graph: Graph, alpha=0.5,
                              weighting: str = "invdist",
                              rel_floor: float = 1e-4,
                              lap_mass: Optional[Tuple] = None,
                              ) -> Tuple[EllOperator, torch.Tensor]:
    """A = L + alpha * diag(mass): an SPD screened-Poisson operator.

    ``alpha="auto"`` sets alpha so the mean screening shift is
    ``rel_floor`` of the mean diagonal: with invdist weights a fixed
    alpha's shift falls below f32 resolution as the density grows, and
    the stored operator degenerates to a singular Laplacian.
    """
    lap, mass = (lap_mass if lap_mass is not None
                 else graph_laplacian(graph, weighting))
    if isinstance(alpha, str):
        if alpha != "auto":
            raise ValueError(f"unknown alpha mode {alpha!r}")
        alpha = rel_floor * torch.mean(lap.diag) / torch.mean(mass)
    return lap._replace(diag=lap.diag + alpha * mass), mass
