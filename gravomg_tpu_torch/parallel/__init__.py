"""Mesh collections (counterpart of ``gravomg_tpu/parallel``): stacked
hierarchies and their batched cycles, and the padding they share with
the sharded path."""

from gravomg_tpu_torch.parallel.batch import (attach_collection,
                                              batched_solve,
                                              batched_v_cycle,
                                              pad_collection, stack_solvers,
                                              stackable)
from gravomg_tpu_torch.parallel.sharding import (pad_axis,
                                                 pad_solver_fine_level,
                                                 pad_solver_levels,
                                                 pad_solver_to)

__all__ = [
    "attach_collection", "batched_solve", "batched_v_cycle",
    "pad_collection", "stack_solvers", "stackable", "pad_axis",
    "pad_solver_fine_level", "pad_solver_levels", "pad_solver_to",
]
