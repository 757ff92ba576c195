"""Smoothers: weighted Jacobi and Chebyshev (counterpart of
``gravomg_tpu/solve/smoothers.py``)."""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gravomg_tpu_torch.types import EllOperator
from gravomg_tpu_torch.solve.spmv import spmv

Matvec = Callable[[torch.Tensor], torch.Tensor]


def weighted_jacobi(op: EllOperator, x: torch.Tensor, b: torch.Tensor,
                    iterations: int, omega: float = 2.0 / 3.0,
                    mv: Optional[Matvec] = None,
                    x0_zero: bool = False) -> torch.Tensor:
    """x <- x + omega D^{-1} (b - A x), ``iterations`` times.

    ``mv`` overrides the matvec (e.g. the slab form).  ``x0_zero=True``
    asserts the incoming ``x`` is exactly zero and skips the first
    iteration's matvec (A 0 = 0 exactly).
    """
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    dinv = 1.0 / op.diag
    if x.ndim > 1:
        dinv = dinv[:, None]
    start = 0
    if x0_zero and iterations >= 1:
        x = omega * dinv * b
        start = 1
    for _ in range(start, iterations):
        x = x + omega * dinv * (b - mv(x))
    return x


def estimate_lambda_max(op: EllOperator, iterations: int = 30,
                        x0: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Power iteration on D^{-1} A, for scaling the Chebyshev interval
    at set-up.  Starts from ``x0``, or from a standard normal vector
    drawn from ``generator`` (seed 0 if None).  Returns the Rayleigh
    quotient as a 0-d tensor."""
    dinv = 1.0 / op.diag
    if x0 is None:
        dev = op.diag.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        x0 = torch.randn(op.num_vertices, dtype=op.diag.dtype,
                         generator=generator,
                         device=generator.device).to(dev)
    x = x0
    for _ in range(iterations):
        y = dinv * spmv(op, x)
        x = y / torch.linalg.norm(y).clamp(min=1e-30)
    y = dinv * spmv(op, x)
    return torch.dot(x, y) / torch.dot(x, x).clamp(min=1e-30)


def gershgorin_lambda_max(op: EllOperator) -> torch.Tensor:
    """Gershgorin upper bound on lambda_max(D^{-1} A): one row-sum pass,
    max_i (1 + sum_j |a_ij| / a_ii) over rows with a positive diagonal."""
    absrow = torch.sum(torch.where(op.mask, op.offdiag.abs(),
                                   torch.zeros_like(op.offdiag)), dim=1)
    pos = op.diag > 0
    safe_d = torch.where(pos, op.diag, torch.ones_like(op.diag))
    return torch.max(torch.where(pos, 1.0 + absrow / safe_d,
                                 torch.zeros_like(op.diag)))


class ChebyshevParams(NamedTuple):
    """Smoothing interval [lambda_max/ratio, lambda_max] of D^{-1} A, as
    host floats (read once at setup, never synchronised in a cycle)."""
    lam_min: float
    lam_max: float

    @staticmethod
    def from_operator(op: EllOperator,
                      ratio: float = 4.0) -> "ChebyshevParams":
        lmax = float(gershgorin_lambda_max(op))
        return ChebyshevParams(lam_min=lmax / ratio, lam_max=lmax)


def chebyshev(op: EllOperator, x: torch.Tensor, b: torch.Tensor,
              params: ChebyshevParams, degree: int,
              mv: Optional[Matvec] = None,
              x0_zero: bool = False) -> torch.Tensor:
    """Chebyshev polynomial smoother of the given degree on D^{-1} A
    (three-term recurrence over [lam_min, lam_max]; ``degree`` matvecs,
    one fewer with ``x0_zero``)."""
    if mv is None:
        mv = lambda y: spmv(op, y)  # noqa: E731
    dinv = 1.0 / op.diag
    if x.ndim > 1:
        dinv = dinv[:, None]
    theta = 0.5 * (params.lam_max + params.lam_min)
    delta = 0.5 * (params.lam_max - params.lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma

    r = dinv * b if x0_zero else dinv * (b - mv(x))
    d = r / theta
    x = x + d
    for _ in range(degree - 1):
        r = dinv * (b - mv(x))
        rho_next = 1.0 / (2.0 * sigma - rho)
        d = rho_next * rho * d + (2.0 * rho_next / delta) * r
        x = x + d
        rho = rho_next
    return x
