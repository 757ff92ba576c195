"""The lowest pairs of the Laplace pencil L v = lam M v, worked out again
in float64 from the reference's own graph (``graph.py::knn_graph``,
``laplacian``): a dense ``eigh`` of M^-1/2 L M^-1/2 where the matrix
fits (:data:`DENSE_ROWS`), else SciPy's ARPACK in shift-invert mode
about a shift just below 0 (L is singular: its constants are the
nullspace).  The pencil does not depend on a call's start block, so a
check solves it once."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from benchmark.reference.graph import RefOperator

DENSE_ROWS = 2000
# The shift of the shift-invert solve, in units of mean(diag) / mean(M):
# below 0, so L - sigma M is positive definite, and far nearer 0 than
# the low eigenvalues' spacing.
SHIFT = 1e-6

# A float32 product on the card may otherwise run in TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _csr(lap: RefOperator) -> sp.csr_matrix:
    nbr = lap.neighbors.cpu().numpy()
    off = lap.offdiag.cpu().double().numpy()
    v = nbr.shape[0]
    keep = nbr >= 0
    rows = np.repeat(np.arange(v), nbr.shape[1]).reshape(nbr.shape)[keep]
    a = sp.csr_matrix((off[keep], (rows, nbr[keep])), shape=(v, v))
    return (a + sp.diags(lap.diag.cpu().double().numpy())).tocsr()


def lowest_pairs(lap: RefOperator, mass: torch.Tensor, n: int):
    """(lam (n,), v (V, n)), float64 on ``mass``'s device: the n smallest
    pairs of (L, M), ascending, v M-orthonormal."""
    dev = mass.device
    m = mass.cpu().double()
    if m.shape[0] <= DENSE_ROWS:
        s = torch.rsqrt(m)
        dense = torch.as_tensor(_csr(lap).toarray())
        lam, u = torch.linalg.eigh(s[:, None] * dense * s[None, :])
        lam, v = lam[:n], s[:, None] * u[:, :n]
    else:
        mn = m.numpy()
        sigma = -SHIFT * float(lap.diag.double().mean()) / float(mn.mean())
        lam, v = spla.eigsh(_csr(lap).tocsc(), k=n, M=sp.diags(mn).tocsc(),
                            sigma=sigma, which="LM")
        order = np.argsort(lam)
        lam, v = torch.as_tensor(lam[order]), torch.as_tensor(v[:, order])
        v = v / torch.sqrt((m[:, None] * v * v).sum(dim=0))[None, :]
    return lam.to(dev), v.to(dev)


def pencil_residual(lap: RefOperator, mass: torch.Tensor, lam: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Per pair, ||L v - lam M v||_{M^-1} / ||v||_M in float64: the
    residual of the normalised problem M^-1/2 L M^-1/2 u = lam u with
    u = M^1/2 v, which reads the same whatever the cloud's spacing."""
    v = v.to(device=mass.device, dtype=torch.float64)
    lam = lam.to(device=mass.device, dtype=torch.float64)
    r = lap(v) - mass[:, None] * v * lam[None, :]
    num = torch.sqrt((r * r / mass[:, None]).sum(dim=0))
    return num / torch.sqrt((mass[:, None] * v * v).sum(dim=0))
