"""gravomg_tpu_torch: the PyTorch and CUDA port of gravomg_tpu.

Plain torch on any device; the block-window SpMV that carries the solve
is a hand-written CUDA kernel for Hopper (``csrc/blockdense_matvec.cu``),
as are the transposed-tile SpMV of the ``mxu`` slab form
(``csrc/mxu_matvec.cu``) and the gather probe's windowed SpMV
(``csrc/window_gather.cu``); each has a plain torch twin that CPU tensors
take.  The JAX package
``gravomg_tpu`` is the reference the port is tested against; this
package never imports it.
"""

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.types import (INVALID_INDEX, EllOperator, Graph,
                                     Prolongation, Restriction)
from gravomg_tpu_torch.solve.spmv import residual, spmv
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            attach_fast_operators,
                                            attach_operators,
                                            attach_restrictions,
                                            attach_slab_operators,
                                            cast_fast_operators,
                                            level_matvec, solve, v_cycle)
from gravomg_tpu_torch.solve.cg import fcg, mg_fcg, mg_pcg, mg_solve, pcg
from gravomg_tpu_torch.io.serialization import load_solver, save_solver
from gravomg_tpu_torch.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.apps.poisson import screened_poisson_operator
from gravomg_tpu_torch.hierarchy import build_hierarchy_host

__all__ = [
    "INVALID_INDEX", "EllOperator", "Graph", "MultigridConfig",
    "Prolongation", "Restriction", "SolverHierarchy", "SolverLevel",
    "attach_fast_operators", "attach_operators", "attach_restrictions",
    "attach_slab_operators", "build_hierarchy_host",
    "cast_fast_operators", "fcg", "graph_laplacian", "grid_knn_graph_nosync",
    "level_matvec", "load_solver", "mg_fcg", "mg_pcg", "mg_solve", "pcg",
    "residual", "save_solver", "screened_poisson_operator", "solve", "spmv",
    "v_cycle",
]
