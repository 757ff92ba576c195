"""Galerkin coarse operator A_c = U^T A U (counterpart of
``gravomg_tpu/solve/rap.py::galerkin_rap``), as two torch sparse
products converted to ELL."""

from __future__ import annotations

import warnings

import torch

from gravomg_tpu_torch.types import INVALID_INDEX, EllOperator, Prolongation


def _coo(rows, cols, vals, shape) -> torch.Tensor:
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape,
                                   check_invariants=False).coalesce()


def galerkin_rap(op: EllOperator, u: Prolongation,
                 degree_multiple: int = 8) -> EllOperator:
    """U^T A U as an ELL operator whose width is the largest
    off-diagonal row degree rounded up to ``degree_multiple`` (at least
    4).  Rows no U column reaches get an identity diagonal, as in the
    JAX package."""
    dev = op.diag.device
    v, nc = op.num_vertices, u.n_coarse
    mask = op.mask
    ar = torch.arange(v, device=dev)
    nz = u.weights.reshape(-1) != 0.0
    urows = ar.repeat_interleave(3)[nz]
    ucols = u.cols.reshape(-1).long()[nz]
    uvals = u.weights.reshape(-1)[nz].to(op.diag.dtype)
    with warnings.catch_warnings():
        # Construction warns that invariant checks are off (the indices
        # are in range by construction), and sparse.mm goes through CSR,
        # which warns that CSR support is in beta.
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        a = _coo(torch.cat([ar[:, None].expand_as(mask)[mask], ar]),
                 torch.cat([op.neighbors[mask].long(), ar]),
                 torch.cat([op.offdiag[mask], op.diag]), (v, v))
        umat = _coo(urows, ucols, uvals, (v, nc))
        umat_t = _coo(ucols, urows, uvals, (nc, v))
        c = torch.sparse.mm(umat_t, torch.sparse.mm(a, umat)).coalesce()
    (r, col), val = c.indices(), c.values()

    on_diag = r == col
    diag = torch.zeros((nc,), dtype=val.dtype, device=dev)
    diag.index_add_(0, r[on_diag], val[on_diag])
    off = ~on_diag
    r, col, val = r[off], col[off], val[off]       # sorted by (row, col)
    counts = torch.bincount(r, minlength=nc)
    width = int(counts.max()) if r.numel() else 0
    width = -(-max(width, 4) // degree_multiple) * degree_multiple
    slot = torch.arange(r.numel(), device=dev) - (torch.cumsum(counts, 0)
                                                  - counts)[r]
    neighbors = torch.full((nc, width), INVALID_INDEX, dtype=torch.int32,
                           device=dev)
    offdiag = torch.zeros((nc, width), dtype=val.dtype, device=dev)
    neighbors[r, slot] = col.to(torch.int32)
    offdiag[r, slot] = val
    reached = torch.zeros((nc,), dtype=torch.bool, device=dev)
    reached[ucols] = True
    diag = torch.where(reached, diag, torch.ones_like(diag))
    return EllOperator(neighbors=neighbors, offdiag=offdiag, diag=diag)
