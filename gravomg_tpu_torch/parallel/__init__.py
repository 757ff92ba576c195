"""Mesh collections and multi-device solves (counterpart of
``gravomg_tpu/parallel``): stacked hierarchies and their batched cycles
(``batch.py``), the padding and the all-gather vertex sharding
(``sharding.py``), the halo-exchange vertex sharding (``halo.py``), and
the launcher of ``torch.distributed`` ranks (``launch.py``)."""

from gravomg_tpu_torch.parallel.batch import (attach_collection,
                                              batched_solve,
                                              batched_v_cycle,
                                              pad_collection, stack_solvers,
                                              stackable)
from gravomg_tpu_torch.parallel.sharding import (ShardedSolver, batched_vcycle,
                                                 make_mesh, pad_axis,
                                                 pad_solver_fine_level,
                                                 pad_solver_levels,
                                                 pad_solver_to,
                                                 shard_fast_operator,
                                                 shard_solver,
                                                 sharded_solve,
                                                 sharded_v_cycle,
                                                 vertex_sharded_cg_step)
from gravomg_tpu_torch.parallel.halo import (HaloLevel, HaloOperator,
                                             HaloSolver, build_halo_ell,
                                             halo_matvec, halo_shard_solver,
                                             halo_solve, halo_v_cycle,
                                             level_plans,
                                             shard_halo_operator)
from gravomg_tpu_torch.parallel.launch import run_ranks

__all__ = [
    "attach_collection", "batched_solve", "batched_v_cycle",
    "pad_collection", "stack_solvers", "stackable", "pad_axis",
    "pad_solver_fine_level", "pad_solver_levels", "pad_solver_to",
    "ShardedSolver", "batched_vcycle", "make_mesh", "shard_fast_operator",
    "shard_solver", "sharded_solve", "sharded_v_cycle",
    "vertex_sharded_cg_step", "HaloLevel", "HaloOperator", "HaloSolver",
    "build_halo_ell", "halo_matvec", "halo_shard_solver", "halo_solve",
    "halo_v_cycle", "level_plans", "shard_halo_operator", "run_ranks",
]
