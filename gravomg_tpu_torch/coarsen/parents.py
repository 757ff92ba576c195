"""Fine-to-coarse parent assignment: graph Voronoi clustering
(counterpart of ``gravomg_tpu/coarsen/parents.py::assign_parents``).

The reference runs a multi-source Dijkstra seeded at every coarse sample
with distance 0 and the sample's coarse-side index as parent.  Here the
same shortest-path partition is the fixpoint of Bellman-Ford sweeps:
each sweep is one (V, K) gather and a row minimum, and the fixpoint is
reached in as many sweeps as the widest cell has hops.  Equal path
lengths (measure zero for generic clouds) go to the lowest neighbour
slot.  Unreached vertices keep parent 0, the reference's default.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gravomg_tpu_torch.types import Graph


def assign_parents(graph: Graph, coarse_samples: torch.Tensor,
                   max_sweeps: int = 10_000
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nearest coarse seed of every fine vertex along graph paths.

    ``coarse_samples``: (C,) fine-vertex ids of the seeds, ascending.
    Returns (parents (V,) int32 in [0, C), path lengths (V,) float).
    """
    v, k = graph.neighbors.shape
    dev = graph.neighbors.device
    nbr = graph.safe_neighbors().long()
    inf = torch.full_like(graph.distances, float("inf"))
    d = torch.where(graph.mask, graph.distances, inf)
    seeds = coarse_samples.long()
    dist = inf.new_full((v,), float("inf"))
    dist[seeds] = 0.0
    par = torch.zeros((v,), dtype=torch.int32, device=dev)
    par[seeds] = torch.arange(seeds.numel(), dtype=torch.int32, device=dev)
    slots = torch.arange(k, device=dev)
    for _ in range(max_sweeps):
        cand = dist[nbr] + d                    # (V, K) path via neighbour
        best = cand.min(dim=1).values
        # The first slot that attains the minimum.
        best_k = torch.where(cand == best[:, None], slots,
                             slots.new_full((), k)).min(dim=1).values
        best_k = best_k.clamp(max=k - 1)        # a row of NaN has no slot
        best_par = par[torch.gather(nbr, 1, best_k[:, None])[:, 0]]
        improved = best < dist
        if not bool(improved.any()):
            break
        dist = torch.where(improved, best, dist)
        par = torch.where(improved, best_par, par)
    return par, dist
