"""Weighted graph Laplacian in padded ELL form (counterpart of
``gravomg_tpu/geometry/laplacian.py::graph_laplacian``)."""

from __future__ import annotations

from typing import Tuple

import torch

from gravomg_tpu_torch.types import EllOperator, Graph


def graph_laplacian(graph: Graph, weighting: str = "invdist"
                    ) -> Tuple[EllOperator, torch.Tensor]:
    """L = D - W plus a lumped mass vector.

    Weights: "uniform" w_ij = 1; "invdist" w_ij = 1 / max(d_ij, 1e-8).
    The mass is the mean squared neighbour distance (a local-area proxy
    for point clouds), floored at 1e-12.
    """
    mask = graph.mask
    zero = torch.zeros_like(graph.distances)
    d = torch.where(mask, graph.distances, zero)
    if weighting == "uniform":
        w = mask.to(d.dtype)
    elif weighting == "invdist":
        w = torch.where(mask, 1.0 / torch.clamp(d, min=1e-8), zero)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    diag = torch.sum(w, dim=1)
    lap = EllOperator(neighbors=graph.neighbors, offdiag=-w, diag=diag)
    deg = torch.clamp(torch.sum(mask, dim=1), min=1)
    mass = torch.clamp(torch.sum(d * d, dim=1) / deg, min=1e-12)
    return lap, mass
