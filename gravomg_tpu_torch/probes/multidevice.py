"""The rank body of ``chip_smoke.py``'s multi-device phase: the solves
of the vertex-sharded paths on one rank of a ``torch.distributed``
group, started by ``parallel/launch.py::run_ranks`` (which needs the
body importable from a module of its own).

Every rank loads the ELL hierarchy from the npz at ``path``, pads and
shards it, and runs ``halo_solve`` and ``sharded_solve`` (MG-PCG) on the
right-hand side b, one ``vertex_sharded_cg_step`` from x = 0, and, with
``n_rhs`` > 0, ``batched_vcycle`` on ``n_rhs`` right-hand sides drawn by
a generator seeded 0 on the rank's device, on the unpadded hierarchy
with its 8-row slab forms (so the batched kernel B1 runs, and its
launches are counted).  It returns its rows of every result on the CPU
with the seconds of each stage (device synchronised) and its peak
device memory.
"""

from __future__ import annotations

import time

import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matmat_cuda
from gravomg_tpu_torch.parallel import halo, sharding
from gravomg_tpu_torch.parallel.launch import all_reduce_sum
from gravomg_tpu_torch.utils.profiling import synchronize


class _Clock:
    """Synchronised seconds since the last reading."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        synchronize(dev)
        self.t = time.perf_counter()

    def lap(self) -> float:
        synchronize(self.dev)
        t, self.t = self.t, time.perf_counter()
        return self.t - t


def solve_rank(rank: int, world_size: int, device: torch.device, path: str,
               b, cfg, n_rhs: int) -> dict:
    """One rank of the multi-device phase (module doc); ``b`` a numpy
    vector of the finest level's length."""
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    clock = _Clock(device)
    mesh = gt.make_mesh(world_size, "data", device_type=device.type)
    group = mesh.get_group("data")
    # NCCL sets up its communicator at the group's first collective:
    # make that one here, outside the timed solves.
    all_reduce_sum(torch.ones(1, device=device), group)
    h = gt.load_solver(path, device=device)
    bt = torch.as_tensor(b, device=device)
    out = {"rank": rank, "device": str(device), "load_s": clock.lap()}

    hs = halo.halo_shard_solver(
        gt.pad_solver_levels(h, world_size, pad_coarse=True), mesh)
    plan_s = clock.lap()
    x, rel, it = halo.halo_solve(hs, bt, cfg, mesh)
    out["halo"] = {"x": x.cpu(), "rel": rel, "iters": it, "s": clock.lap(),
                   "plan_s": plan_s,
                   "halo_frac": [lvl.op.halo_frac for lvl in hs.levels]}
    del hs

    hsh = gt.shard_solver(gt.pad_solver_levels(h, world_size), mesh)
    out["shard_s"] = clock.lap()
    x, rel, it = gt.sharded_solve(hsh, bt, cfg, mesh)
    out["sharded"] = {"x": x.cpu(), "rel": rel, "iters": it,
                      "s": clock.lap()}

    # One CG step from x = 0: r = b, p = z = M b.
    lo, hi = hsh.spans[0]
    bp = bt.new_zeros((hsh.n_rows[0],))
    bp[:bt.shape[0]] = bt
    r = bp[lo:hi].contiguous()
    z = sharding.sharded_v_cycle(hsh, torch.zeros_like(r), r, cfg, mesh,
                                 x0_zero=True)
    rz = sharding.sharded_dot(group)(r, z)
    step = sharding.vertex_sharded_cg_step(hsh, cfg, mesh)
    x1, r1, _, rz1 = step(torch.zeros_like(r), r, z, rz)
    out["step"] = {"x": x1.cpu(), "r": r1.cpu(), "rz": float(rz1),
                   "span": (lo, hi), "s": clock.lap()}
    del hsh

    if n_rhs:
        hslab = gt.attach_slab_operators(h)
        gen = torch.Generator(device=device).manual_seed(0)
        bs = torch.randn((n_rhs, bt.shape[0]), generator=gen, device=device,
                         dtype=bt.dtype)
        slab_s = clock.lap()
        blockdense_matmat_cuda.launches = 0
        y = sharding.batched_vcycle(hslab, cfg, mesh)(torch.zeros_like(bs),
                                                      bs)
        out["batched"] = {"x": y.cpu(), "s": clock.lap(), "slab_s": slab_s,
                          "b1_launches": blockdense_matmat_cuda.launches}
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else None)
    return out
