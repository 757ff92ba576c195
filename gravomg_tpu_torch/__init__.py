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

from gravomg_tpu_torch.config import (BARYCENTRIC, INVDIST, UNIFORM,
                                      MultigridConfig)
from gravomg_tpu_torch.types import (INVALID_INDEX, EllOperator, Graph,
                                     HierarchyStats, Prolongation,
                                     Restriction, TriangleSet)
from gravomg_tpu_torch.solve.spmv import residual, spmv
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            attach_fast_operators,
                                            attach_operators,
                                            attach_restrictions,
                                            attach_slab_operators,
                                            cast_fast_operators,
                                            fmg, level_matvec, solve,
                                            solve_refined,
                                            solve_with_history, v_cycle)
from gravomg_tpu_torch.solve.smoothers import (ChebyshevParams, chebyshev,
                                               estimate_lambda_max,
                                               weighted_jacobi)
from gravomg_tpu_torch.solve.rap import galerkin_rap
from gravomg_tpu_torch.solve.cg import fcg, mg_fcg, mg_pcg, mg_solve, pcg
from gravomg_tpu_torch.io.serialization import (graph_from_numpy,
                                                hierarchy_to_numpy,
                                                level_to_numpy, load_solver,
                                                save_solver,
                                                solver_from_numpy)
from gravomg_tpu_torch.coarsen.sampling import (average_edge_length,
                                                fast_disc_sample,
                                                fast_disc_sample_mask,
                                                fast_disc_sample_priority,
                                                sampling_radius)
from gravomg_tpu_torch.coarsen.parents import assign_parents
from gravomg_tpu_torch.coarsen.graph import coarse_graph, extract_coarse_edges
from gravomg_tpu_torch.coarsen.placement import \
    coarse_from_mean_of_fine_children
from gravomg_tpu_torch.prolong.triangles import construct_voronoi_triangles
from gravomg_tpu_torch.prolong.operator import (build_restriction,
                                                construct_prolongation,
                                                projected_points, prolong,
                                                restrict, restrict_gather)
from gravomg_tpu_torch.geometry.transforms import scale_mesh
from gravomg_tpu_torch.geometry.knn import (graph_from_edges, knn_graph,
                                            knn_indices)
from gravomg_tpu_torch.geometry.gridknn import (grid_knn_graph,
                                                grid_knn_graph_nosync)
from gravomg_tpu_torch.geometry.laplacian import (cotan_laplacian,
                                                  extract_edges,
                                                  graph_laplacian,
                                                  to_edge_distance_graph)
from gravomg_tpu_torch.apps.poisson import screened_poisson_operator
from gravomg_tpu_torch.hierarchy import (DegenerateHierarchyError, Hierarchy,
                                         LevelData, build_hierarchy,
                                         build_hierarchy_device,
                                         build_hierarchy_host, coarsen_once)

__all__ = [
    "assign_parents", "attach_fast_operators", "attach_operators",
    "attach_restrictions", "attach_slab_operators", "average_edge_length",
    "BARYCENTRIC", "build_hierarchy", "build_hierarchy_device",
    "build_hierarchy_host", "build_restriction", "cast_fast_operators",
    "chebyshev", "ChebyshevParams", "coarse_graph", "coarsen_once",
    "construct_prolongation", "construct_voronoi_triangles",
    "cotan_laplacian", "DegenerateHierarchyError", "EllOperator",
    "estimate_lambda_max", "extract_coarse_edges", "extract_edges",
    "fast_disc_sample", "fast_disc_sample_mask", "fast_disc_sample_priority",
    "fcg", "fmg", "galerkin_rap", "Graph", "graph_from_edges",
    "graph_from_numpy", "graph_laplacian", "grid_knn_graph",
    "grid_knn_graph_nosync", "Hierarchy", "hierarchy_to_numpy",
    "HierarchyStats", "INVALID_INDEX", "INVDIST", "knn_graph", "knn_indices",
    "level_matvec", "level_to_numpy", "LevelData", "load_solver", "mg_fcg",
    "mg_pcg", "mg_solve", "MultigridConfig", "pcg", "projected_points",
    "prolong", "Prolongation", "residual", "restrict", "restrict_gather",
    "Restriction", "sampling_radius", "save_solver", "scale_mesh",
    "screened_poisson_operator", "solve", "solve_refined",
    "solve_with_history", "solver_from_numpy", "SolverHierarchy",
    "SolverLevel", "spmv", "to_edge_distance_graph", "TriangleSet", "UNIFORM",
    "v_cycle", "weighted_jacobi",
]
