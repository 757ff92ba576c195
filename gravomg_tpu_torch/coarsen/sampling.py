"""Coarse-node selection: fast disc sampling (counterpart of
``gravomg_tpu/coarsen/sampling.py``).

The reference's ``fastDiscSample`` is a sequential greedy scan: visit
the vertices in index order, select a vertex that is not yet covered,
and cover every 1-hop neighbour closer than ``radius`` and every 2-hop
neighbour whose two hop lengths sum to less than ``radius``.

Define the conflict relation  i ~ j  iff (i, j) is a graph edge with
d(i, j) < r, or some common neighbour n has d(i, n) + d(n, j) < r.  It
is symmetric, and the greedy scan's output is the lexicographically
first maximal independent set of it: a vertex is selected iff no
selected vertex of smaller index conflicts with it.  That fixpoint is
reached by parallel rounds, each deciding every vertex whose earlier
conflicts are all decided, and equals the sequential scan bit for bit.
Under another total order of the vertices (random priorities) the same
rounds give another maximal independent set of the same relation, with
the same spacing and coverage, in far fewer rounds when the index order
is spatial.

The conflict relation is tabulated once per call as a flat list of
(vertex, earlier conflicting vertex) pairs; a round reduces over the
pairs whose vertex is still undecided, and decided pairs are dropped as
the rounds go.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from gravomg_tpu_torch.types import Graph

_UNDECIDED, _SELECTED, _REJECTED = 0, 1, 2

# Two-hop candidates (rows x Kr x Kr) one chunk of the pair table holds.
_CHUNK_ELEMS = 1 << 25


def average_edge_length(graph: Graph) -> torch.Tensor:
    """Mean length of the stored edges, both directions of each
    undirected edge counted (the reference's ``averageEdgeLength``; the
    graph stores no self-loops, so none is subtracted)."""
    mask = graph.mask
    total = torch.sum(torch.where(mask, graph.distances,
                                  torch.zeros_like(graph.distances)))
    return total / torch.sum(mask)


def sampling_radius(graph: Graph,
                    reduction_ratio: float = 2.0) -> torch.Tensor:
    """radius = cbrt(ratio) * mean edge length (the reference demo's
    convention), a 0-d tensor on the graph's device."""
    return math.cbrt(reduction_ratio) * average_edge_length(graph)


def _prune_for_radius(graph: Graph, radius):
    """The edges shorter than ``radius``, compacted to a (V, Kr) prefix
    in ascending neighbour order; Kr is the largest such degree.  Both
    conflict clauses need every hop shorter than ``radius``, so the
    relation over the pruned graph is the same.  Returns (neighbours
    with 0 in padding, mask, distances with +inf in padding)."""
    keep = graph.mask & (graph.distances < radius)
    width = max(int(keep.sum(dim=1).max()), 1)
    order = torch.argsort((~keep).to(torch.int8), dim=1,
                          stable=True)[:, :width]
    m = torch.gather(keep, 1, order)
    nbr = torch.gather(graph.safe_neighbors().long(), 1, order)
    d = torch.gather(graph.distances, 1, order)
    return (torch.where(m, nbr, torch.zeros_like(nbr)), m,
            torch.where(m, d, torch.full_like(d, float("inf"))))


def _conflict_pairs(graph: Graph, radius,
                    ranks: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, dst): every conflict (1-hop or 2-hop, duplicates kept) of
    vertex src with a vertex dst that comes earlier in the order
    (``ranks[dst] < ranks[src]``; the index order if ``ranks`` is
    None)."""
    nbr, m, d = _prune_for_radius(graph, radius)
    v, kr = nbr.shape
    dev = nbr.device
    chunk = max(1, _CHUNK_ELEMS // (kr * kr))
    srcs, dsts = [], []
    for c0 in range(0, v, chunk):
        cn, cm, cd = nbr[c0:c0 + chunk], m[c0:c0 + chunk], d[c0:c0 + chunk]
        idx = torch.arange(c0, c0 + cn.shape[0], device=dev)
        nn = nbr[cn]                                    # (B, Kr, Kr)
        ok2 = cm[:, :, None] & m[cn] & (cd[:, :, None] + d[cn] < radius)
        if ranks is None:
            ok1 = cm & (cn < idx[:, None])
            ok2 &= nn < idx[:, None, None]
        else:
            rk = ranks[idx]
            ok1 = cm & (ranks[cn] < rk[:, None])
            ok2 &= ranks[nn] < rk[:, None, None]
        srcs += [idx[:, None].expand_as(cn)[ok1],
                 idx[:, None, None].expand_as(nn)[ok2]]
        dsts += [cn[ok1], nn[ok2]]
    return torch.cat(srcs), torch.cat(dsts)


def disc_sample_rounds(graph: Graph, radius,
                       ranks: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, int]:
    """The maximal independent set of the conflict relation that is
    greedy in the order of ``ranks`` (pairwise distinct integers, the
    smallest first; the index order if None), by parallel rounds.

    Returns ((V,) bool mask, number of rounds).  The rounds end: the
    earliest undecided vertex is decided in every round.
    """
    v = graph.num_vertices
    dev = graph.neighbors.device
    src, dst = _conflict_pairs(graph, radius, ranks)
    status = torch.zeros((v,), dtype=torch.int8, device=dev)
    rounds = 0
    while True:
        sd = status[dst]
        sel_hit = torch.zeros((v,), dtype=torch.bool, device=dev)
        sel_hit[src[sd == _SELECTED]] = True
        und_hit = torch.zeros((v,), dtype=torch.bool, device=dev)
        und_hit[src[sd == _UNDECIDED]] = True
        und = status == _UNDECIDED
        # A selected conflict of an undecided vertex is an earlier one (a
        # vertex is selected only once its earlier conflicts are
        # decided), so the earlier-only pairs serve both reductions.
        status = torch.where(
            und & sel_hit, torch.full_like(status, _REJECTED),
            torch.where(und & ~und_hit, torch.full_like(status, _SELECTED),
                        status))
        rounds += 1
        if not bool((status == _UNDECIDED).any()):
            break
        keep = (status[src] == _UNDECIDED) & (status[dst] != _REJECTED)
        src, dst = src[keep], dst[keep]
    return status == _SELECTED, rounds


def fast_disc_sample_mask(graph: Graph, radius) -> torch.Tensor:
    """Greedy Poisson-disc selection mask of the reference's scan: the
    lexicographically first maximal independent set.  ``mask.nonzero()``
    (ascending) is the reference's selection list."""
    return disc_sample_rounds(graph, radius)[0]


def priority_ranks(v: int, device, priorities: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """int64 priorities of ``v`` vertices on ``device``, the smallest
    first: the first ``v`` of ``priorities`` (pairwise distinct integers,
    checked) or a permutation drawn from ``generator`` (seed 0 if None)."""
    if priorities is not None:
        if priorities.is_floating_point() or priorities.numel() < v:
            raise ValueError("priorities must be at least one integer per "
                             "vertex")
        ranks = priorities[:v].to(device=device, dtype=torch.int64)
        if torch.unique(ranks).numel() != v:
            raise ValueError("priorities must be pairwise distinct: two "
                             "conflicting vertices of one priority would "
                             "both be selected")
        return ranks
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return torch.randperm(v, generator=generator,
                          device=generator.device).to(device)


def fast_disc_sample_priority(graph: Graph, radius,
                              priorities: Optional[torch.Tensor] = None,
                              generator: Optional[torch.Generator] = None
                              ) -> torch.Tensor:
    """Random-priority maximal independent set of the conflict relation
    (the fast mode): the set the greedy scan would select if it visited
    the vertices in ascending priority.  A different but equally valid
    disc sampling than the index-order one, reached in O(log V) rounds
    where a spatial index order needs as many as its longest chain.

    ``priorities`` as in :func:`priority_ranks`.  Returns the (V,) bool
    mask.
    """
    ranks = priority_ranks(graph.num_vertices, graph.neighbors.device,
                           priorities, generator)
    return disc_sample_rounds(graph, radius, ranks)[0]


def fast_disc_sample(graph: Graph, radius,
                     max_samples: Optional[int] = None) -> torch.Tensor:
    """Ascending selected vertex ids (int32), the reference's return
    convention."""
    sel = torch.nonzero(fast_disc_sample_mask(graph, radius)).reshape(-1)
    if max_samples is not None:
        sel = sel[:max_samples]
    return sel.to(torch.int32)
