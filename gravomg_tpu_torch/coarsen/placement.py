"""Coarse point placement: mean of the fine children (counterpart of
``gravomg_tpu/coarsen/placement.py``).

Each coarse point moves to the mean of the fine points of its Voronoi
cell; a "lonely" cell that holds only its seed also takes the seed's
fine-graph neighbours into the average, as the reference does.  ELL rows
hold distinct non-self entries, so the patched cell is the seed and its
neighbours, each once.
"""

from __future__ import annotations

import torch

from gravomg_tpu_torch.ops.segment import group_ordered
from gravomg_tpu_torch.types import (INVALID_INDEX, Graph,
                                     safe_gather_index)


def coarse_from_mean_of_fine_children(graph: Graph, parents: torch.Tensor,
                                      coarse_samples: torch.Tensor
                                      ) -> torch.Tensor:
    """(C, 3) coarse positions.

    The cell sums run over a (C, largest cell) table of each cell's
    children in ascending order, not through ``index_add_``: on a CUDA
    device that adds in no fixed order, and a coarse point that moves in
    its last digit from run to run can flip a sampling near-tie on the
    next level.  This way the same inputs give the same hierarchy every
    time, on the card as on the CPU.
    """
    points = graph.points
    v, c = points.shape[0], coarse_samples.shape[0]
    dev = points.device
    children, counts = group_ordered(
        parents, torch.arange(v, device=dev),
        torch.ones((v,), dtype=torch.bool, device=dev), c)
    has = children != INVALID_INDEX
    child_pts = points[safe_gather_index(children).long()]     # (C, W, 3)
    sums = torch.sum(torch.where(has[:, :, None], child_pts,
                                 torch.zeros_like(child_pts)), dim=1)

    seeds = coarse_samples.long()
    nbr_mask = graph.mask[seeds]                               # (C, K)
    nbr_pts = points[graph.safe_neighbors()[seeds].long()]     # (C, K, 3)
    patched_sum = points[seeds] + torch.sum(
        torch.where(nbr_mask[:, :, None], nbr_pts,
                    torch.zeros_like(nbr_pts)), dim=1)
    patched_count = 1 + nbr_mask.sum(dim=1)

    lonely = counts == 1
    final_sum = torch.where(lonely[:, None], patched_sum, sums)
    final_count = torch.where(lonely, patched_count, counts.clamp(min=1))
    return final_sum / final_count[:, None].to(points.dtype)
