"""Core fixed-shape containers of the PyTorch port.

The counterparts of ``gravomg_tpu/types.py``: every irregular structure
(neighbour graphs, prolongation operators with <=3 nnz/row) is a padded
ELL table with the same conventions as the JAX package, so arrays move
between the two packages unchanged:

  * empty neighbour slots hold ``INVALID_INDEX`` (large positive, so
    ascending sorts put padding last);
  * valid entries of a row are ascending by column index;
  * no self-loops are stored; operators carry their diagonal apart.

Plain ``NamedTuple``s of tensors; nothing here needs autograd.  A
stack of same-shape containers (``parallel/batch.py``) carries a leading
mesh axis on every tensor; the size properties read the trailing axes,
so they hold for a stack too.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_INDEX = 2**31 - 1


def safe_gather_index(idx: torch.Tensor) -> torch.Tensor:
    """Replace INVALID_INDEX slots with 0 so gathers stay in bounds."""
    return torch.where(idx != INVALID_INDEX, idx, torch.zeros_like(idx))


def batched_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[i][idx[i]]`` for every i of a leading batch axis: x (B, N),
    idx (B, ...) in range; returns idx's shape in x's dtype."""
    b = x.shape[0]
    return torch.gather(x, 1, idx.reshape(b, -1).long()).reshape(idx.shape)


class Graph(NamedTuple):
    """Symmetric neighbourhood graph in padded ELL layout.

    neighbors: (V, K) int32, ascending per row, INVALID_INDEX padding.
    distances: (V, K) float, Euclidean edge lengths; +inf in padding.
    points:    (V, 3) float vertex positions.
    """

    neighbors: torch.Tensor
    distances: torch.Tensor
    points: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.points.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        return self.neighbors != INVALID_INDEX

    @property
    def degrees(self) -> torch.Tensor:
        """(V,) valid neighbour slots per vertex."""
        return torch.sum(self.mask, dim=1)

    @property
    def num_edges(self) -> torch.Tensor:
        """Directed edge count (each undirected edge counted twice)."""
        return torch.sum(self.degrees)

    def safe_neighbors(self) -> torch.Tensor:
        return safe_gather_index(self.neighbors)


class Prolongation(NamedTuple):
    """ELL prolongation U: (n_fine, n_coarse), <=3 nnz/row.

    cols:    (V_f, 3) int32 coarse columns (unused slots repeat slot 0's
             column with weight 0).
    weights: (V_f, 3) float row weights.
    n_coarse: number of coarse vertices.
    """

    cols: torch.Tensor
    weights: torch.Tensor
    n_coarse: int

    @property
    def n_fine(self) -> int:
        return self.cols.shape[-2]

    def as_dense(self) -> torch.Tensor:
        """Dense (n_fine, n_coarse) matrix; for tests and small levels."""
        u = torch.zeros((self.n_fine, self.n_coarse),
                        dtype=self.weights.dtype, device=self.weights.device)
        rows = torch.arange(self.n_fine, device=self.cols.device)[:, None]
        u.index_put_((rows.expand_as(self.cols).reshape(-1),
                      self.cols.reshape(-1).long()),
                     self.weights.reshape(-1), accumulate=True)
        return u


class Restriction(NamedTuple):
    """Gather-form U^T: per coarse vertex, its (fine row, weight) pairs.

    rows:    (n_coarse, C) int32 fine rows, INVALID_INDEX padding.
    weights: (n_coarse, C) float U[rows[c, j], c]; 0 in padding.
    n_fine:  number of fine rows of U.
    """

    rows: torch.Tensor
    weights: torch.Tensor
    n_fine: int

    @property
    def n_coarse(self) -> int:
        return self.rows.shape[-2]

    @property
    def max_children(self) -> int:
        """Width of the children table."""
        return self.rows.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        return self.rows != INVALID_INDEX

    def safe_rows(self) -> torch.Tensor:
        return safe_gather_index(self.rows)


class EllOperator(NamedTuple):
    """Square sparse operator: ``A x = diag*x + sum_k offdiag*x[nbr]``.

    neighbors: (V, K) int32, INVALID_INDEX padding.
    offdiag:   (V, K) float, 0 in padding.
    diag:      (V,) float.
    """

    neighbors: torch.Tensor
    offdiag: torch.Tensor
    diag: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.diag.shape[-1]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[-1]

    @property
    def mask(self) -> torch.Tensor:
        return self.neighbors != INVALID_INDEX

    def safe_neighbors(self) -> torch.Tensor:
        return safe_gather_index(self.neighbors)

    def as_dense(self) -> torch.Tensor:
        """Dense (V, V) matrix; for tests and the coarsest level."""
        v = self.num_vertices
        a = torch.zeros((v, v), dtype=self.diag.dtype,
                        device=self.diag.device)
        rows = torch.arange(v, device=self.diag.device)[:, None]
        rows = rows.expand_as(self.neighbors)
        vals = torch.where(self.mask, self.offdiag,
                           torch.zeros_like(self.offdiag))
        a.index_put_((rows.reshape(-1),
                      self.safe_neighbors().reshape(-1).long()),
                     vals.reshape(-1), accumulate=True)
        return a + torch.diag(self.diag)


class TriangleSet(NamedTuple):
    """All triangles of a coarse graph and per-vertex association lists.

    Triangles are enumerated in lexicographic (v0 < v1 < v2) order, so
    triangle ids and the order of the association lists are those of the
    reference's nested loops, which the prolongation's first-hit
    tie-break depends on.

    vertices:  (T, 3) int32, each row ascending.
    normals:   (T, 3) float, normalize((p1 - p0) x (p2 - p0)).
    assoc:     (C, A) int32 triangle ids incident to each vertex,
               ascending; INVALID_INDEX padding.
    assoc_rot: (C, A) int32 in {0, 1, 2}: the slot of
               ``vertices[assoc[c, a]]`` that equals c; 0 in padding.
    """

    vertices: torch.Tensor
    normals: torch.Tensor
    assoc: torch.Tensor
    assoc_rot: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]

    @property
    def assoc_mask(self) -> torch.Tensor:
        return self.assoc != INVALID_INDEX


class HierarchyStats(NamedTuple):
    """Per-level record of one coarsening step, as host numbers: the
    sizes, the triangle count, how many fine rows took each prolongation
    case (of the rows whose parent has two or more coarse neighbours)
    and the sampling radius."""

    n_fine: int
    n_coarse: int
    n_triangles: int
    triangle_hits: int
    edge_fallbacks: int
    point_fallbacks: int
    radius: float
