"""Applications over the multigrid stack (counterpart of
``gravomg_tpu/apps``): Poisson solves, geodesics by the heat method,
implicit smoothing and the lowest Laplace eigenpairs."""

from gravomg_tpu_torch.apps.poisson import (poisson_hierarchy,
                                            screened_poisson_operator,
                                            solve_poisson)
from gravomg_tpu_torch.apps.smoothing import implicit_smooth
from gravomg_tpu_torch.apps.heat import heat_geodesics, refit_hierarchy
from gravomg_tpu_torch.apps.spectral import laplace_eigs

__all__ = [
    "poisson_hierarchy", "screened_poisson_operator", "solve_poisson",
    "implicit_smooth", "heat_geodesics", "refit_hierarchy",
    "laplace_eigs",
]
