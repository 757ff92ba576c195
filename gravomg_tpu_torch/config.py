"""Solver and hierarchy configuration (counterpart of
``gravomg_tpu/config.py``, same defaults).

The weighting constants are defined here rather than imported: the JAX
package defines them in ``prolong/operator.py``, which imports jax.
"""

from __future__ import annotations

import dataclasses

# Prolongation weighting schemes (the csrc coarsener's ``scheme``).
BARYCENTRIC, UNIFORM, INVDIST = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    # --- hierarchy construction ---
    reduction_ratio: float = 2.0
    weighting: int = BARYCENTRIC
    max_levels: int = 8
    coarse_threshold: int = 512       # stop coarsening; dense-solve below
    degree_multiple: int = 8          # round max degrees up to this
    # --- smoothing ---
    smoother: str = "jacobi"          # "jacobi" | "chebyshev"
    pre_smooth: int = 2
    post_smooth: int = 2
    jacobi_omega: float = 2.0 / 3.0
    chebyshev_degree: int = 4
    chebyshev_ratio: float = 16.0
    # --- cycling ---
    cycle_gamma: int = 1              # 1 = V-cycle, 2 = W-cycle
    # --- outer iteration ---
    tolerance: float = 1e-8           # relative residual target
    max_cycles: int = 200
    # At or above this many fine rows ``mg_solve`` preconditions flexible
    # CG with a bf16-cast V-cycle (the window matrices are the dominant
    # memory stream and bf16 halves them).
    bf16_threshold: int = 500_000
