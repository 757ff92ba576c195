"""gravomg_tpu_torch: the PyTorch and CUDA port of gravomg_tpu.

Plain torch on any device; the block-window SpMV that carries the solve
is a hand-written CUDA kernel for Hopper (``csrc/blockdense_matvec.cu``),
as are the transposed-tile SpMV of the ``mxu`` slab form
(``csrc/mxu_matvec.cu``) and the gather probe's windowed SpMV
(``csrc/window_gather.cu``); each has a plain torch twin that CPU tensors
take.  A (V, D) right-hand side on the 8-row slab form runs the batched
kernel B1 (``csrc/blockdense_matmat.cu``), one launch a slab matvec,
which reads the window matrices once for all columns and skips their
all-zero positions.  The uniform block-dense forms of the small levels
run one launch a matvec through the uniform kernel
(``csrc/uniform_matvec.cu``) for a 1-D right-hand side on the card.
The applications (``apps``: Poisson
solves, heat geodesics, implicit smoothing, Laplace eigenpairs) run on
the same stack; ``parallel`` stacks a collection of meshes into one
batched cycle and shards a hierarchy's rows over the ranks of a
``torch.distributed`` group (an all-gather or a halo exchange a
matvec).  The JAX
package ``gravomg_tpu`` is the reference the port is tested against;
this package never imports it.
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
from gravomg_tpu_torch.hierarchy import (DegenerateHierarchyError, Hierarchy,
                                         LevelData, build_hierarchy,
                                         build_hierarchy_device,
                                         build_hierarchy_host, coarsen_once)
from gravomg_tpu_torch.parallel import (attach_collection, batched_solve,
                                        batched_v_cycle, make_mesh, pad_axis,
                                        pad_solver_fine_level,
                                        pad_solver_levels, pad_solver_to,
                                        run_ranks, shard_solver,
                                        sharded_solve, stack_solvers,
                                        stackable)
from gravomg_tpu_torch.apps import (heat_geodesics, implicit_smooth,
                                    laplace_eigs, poisson_hierarchy,
                                    refit_hierarchy,
                                    screened_poisson_operator, solve_poisson)

__all__ = [
    "assign_parents", "attach_collection", "attach_fast_operators",
    "attach_operators",
    "attach_restrictions", "attach_slab_operators", "average_edge_length",
    "BARYCENTRIC", "batched_solve", "batched_v_cycle", "build_hierarchy",
    "build_hierarchy_device",
    "build_hierarchy_host", "build_restriction", "cast_fast_operators",
    "chebyshev", "ChebyshevParams", "coarse_graph", "coarsen_once",
    "construct_prolongation", "construct_voronoi_triangles", "cotan_laplacian",
    "DegenerateHierarchyError", "EllOperator", "estimate_lambda_max",
    "extract_coarse_edges", "extract_edges", "fast_disc_sample",
    "fast_disc_sample_mask", "fast_disc_sample_priority", "fcg", "fmg",
    "galerkin_rap", "Graph", "graph_from_edges", "graph_from_numpy",
    "graph_laplacian", "grid_knn_graph", "grid_knn_graph_nosync",
    "heat_geodesics", "Hierarchy", "hierarchy_to_numpy", "HierarchyStats",
    "implicit_smooth", "INVALID_INDEX", "INVDIST", "knn_graph", "knn_indices",
    "laplace_eigs", "level_matvec", "level_to_numpy", "LevelData",
    "load_solver", "make_mesh", "mg_fcg", "mg_pcg", "mg_solve",
    "MultigridConfig",
    "pad_axis", "pad_solver_fine_level", "pad_solver_levels",
    "pad_solver_to", "pcg",
    "poisson_hierarchy", "projected_points", "prolong", "Prolongation",
    "refit_hierarchy", "residual", "restrict", "restrict_gather",
    "Restriction", "run_ranks", "sampling_radius", "save_solver",
    "scale_mesh", "shard_solver", "sharded_solve",
    "screened_poisson_operator", "solve", "solve_poisson", "solve_refined",
    "solve_with_history", "solver_from_numpy", "SolverHierarchy",
    "stack_solvers", "stackable",
    "SolverLevel", "spmv", "to_edge_distance_graph", "TriangleSet", "UNIFORM",
    "v_cycle", "weighted_jacobi",
]
