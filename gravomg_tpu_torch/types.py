"""Core fixed-shape containers of the PyTorch port.

The counterparts of ``gravomg_tpu/types.py``: every irregular structure
(neighbour graphs, prolongation operators with <=3 nnz/row) is a padded
ELL table with the same conventions as the JAX package, so arrays move
between the two packages unchanged:

  * empty neighbour slots hold ``INVALID_INDEX`` (large positive, so
    ascending sorts put padding last);
  * valid entries of a row are ascending by column index;
  * no self-loops are stored; operators carry their diagonal apart.

Plain ``NamedTuple``s of tensors; nothing here needs autograd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INVALID_INDEX = 2**31 - 1


def safe_gather_index(idx: torch.Tensor) -> torch.Tensor:
    """Replace INVALID_INDEX slots with 0 so gathers stay in bounds."""
    return torch.where(idx != INVALID_INDEX, idx, torch.zeros_like(idx))


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
    def mask(self) -> torch.Tensor:
        return self.neighbors != INVALID_INDEX


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
        return self.cols.shape[0]


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
        return self.rows.shape[0]

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
        return self.diag.shape[0]

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
