"""Driver entry points of the port (counterpart of ``__graft_entry__.py``).

    python -m gravomg_tpu_torch.entry    # one entry cycle, then the dryrun

``entry(device=None) -> (fn, (h, x, b))``: one V-cycle of the multigrid
solver on the prebuilt screened-Poisson hierarchy
``assets/entry_hierarchy.npz`` (2,562 rows), b = N(0, 1) from seed 0 in
f32, x = 0; ``fn(h, x, b)`` runs the cycle (h an argument, not a
closure, as in JAX).

``dryrun_multichip(n_devices, device=None, backend=None) -> dict``: the
four multi-device paths of the JAX entry on ``n_devices`` ranks of a
``torch.distributed`` group (``parallel/launch.py::run_ranks``): (1)
``batched_vcycle`` on 2n right-hand sides, (2) ``sharded_solve`` on the
vertex-sharded ELL hierarchy, (3) the same solve on the uniform
block-dense forms with each rank holding only its row blocks of ``m``,
(4) ``halo_solve`` on ``assets/halo_hierarchy.npz`` (24,000 rows) with a
fine ``halo_frac`` below 0.25.  Each solve reaches ``cfg.tolerance`` or
the call raises.

Where the ranks run is the caller's choice; nothing steps down quietly.
``device=None`` means one NCCL rank a card, and raises when there are
fewer than ``n_devices`` cards.  ``device="cpu"`` runs gloo ranks on the
CPU (JAX re-executes itself on virtual CPU devices for this);
``device="cuda", backend="gloo"`` runs all ranks on the one card, the
exchanges through host memory.

Path (3) pads the levels to a multiple of 8n rows, not of n:
``attach_fast_operators`` caps a block at an eighth of a level's rows, so
only then do the blocks cover level 0 exactly and split over the ranks.
JAX's entry pads to n and passes its own check only where 8n divides the
padded rows (``dryrun_multichip(8)``); at n = 2 its level-0 form stays
replicated and the check fails.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator
from gravomg_tpu_torch.parallel import halo, sharding
from gravomg_tpu_torch.parallel.launch import all_gather, run_ranks
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import attach_fast_operators, v_cycle
from gravomg_tpu_torch.utils.device import resolve_device
from gravomg_tpu_torch.utils.profiling import stage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRY_FIXTURE = os.path.join(ROOT, "assets", "entry_hierarchy.npz")
HALO_FIXTURE = os.path.join(ROOT, "assets", "halo_hierarchy.npz")
HALO_FRAC_MAX = 0.25        # the fine level's halo share, tests/test_halo.py


def normal_rhs(n: int, seed: int, device) -> torch.Tensor:
    """N(0, 1) of length ``n`` from numpy's generator seeded ``seed``,
    in f32 on ``device`` (the JAX entry's right-hand sides)."""
    b = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    return torch.as_tensor(b, device=device)


def load_entry_fixture(device=None):
    """(h, x, b): the entry hierarchy on ``device`` (the card unless the
    caller names another), b = N(0, 1) from seed 0 in f32, x = 0."""
    h = load_solver(ENTRY_FIXTURE, device)
    b = normal_rhs(h.levels[0].op.num_vertices, 0, h.levels[0].op.diag.device)
    return h, torch.zeros_like(b), b


def entry(device=None):
    """(fn, (h, x, b)): ``fn(h, x, b)`` is one ``v_cycle`` with the
    default ``MultigridConfig`` on the entry fixture."""
    h, x, b = load_entry_fixture(device)
    cfg = MultigridConfig()

    def step(h, x, b):
        return v_cycle(h, x, b, cfg)

    return step, (h, x, b)


def _solve_record(x, rel: float, it: int, secs: dict) -> dict:
    return {"iters": int(it), "rel": float(rel), "s": secs["s"],
            "finite": bool(torch.isfinite(x).all())}


def _dryrun_rank(rank: int, world_size: int, device: torch.device) -> dict:
    """One rank of :func:`dryrun_multichip`: the four paths, each checked
    here; returns CPU numbers and shapes (``run_ranks`` saves them)."""
    cfg = MultigridConfig()
    mesh = sharding.make_mesh(world_size, "data", device_type=device.type)
    group = mesh.get_group("data")
    h, _, b = load_entry_fixture(device)
    out = {"rank": rank, "device": str(device)}

    # (1) Data-parallel: 2n right-hand sides, this rank's share as one
    # (V, 2) cycle on the whole hierarchy.
    bs = torch.stack([b * (i + 1) for i in range(2 * world_size)])
    rec = {}
    with stage(rec, "s", device):
        ys = sharding.batched_vcycle(h, cfg, mesh)(torch.zeros_like(bs), bs)
    whole = all_gather(ys, group)
    if whole.shape != bs.shape or not bool(torch.isfinite(whole).all()):
        raise AssertionError(f"batched_vcycle gave {tuple(whole.shape)} "
                             f"for {tuple(bs.shape)} right-hand sides")
    out["batched"] = {"shape": tuple(bs.shape), "s": rec["s"]}

    # (2) Vertex-sharded ELL hierarchy, MG-PCG to the tolerance.
    hpad = sharding.pad_solver_levels(h, world_size)
    rec = {}
    with stage(rec, "s", device):
        hs = sharding.shard_solver(hpad, mesh)
        x, rel, it = sharding.sharded_solve(hs, b, cfg, mesh)
    out["sharded"] = _solve_record(x, rel, it, rec)

    # (3) The uniform block-dense forms, m split by row blocks.
    hpad8 = sharding.pad_solver_levels(h, 8 * world_size)
    v0 = hpad8.levels[0].op.num_vertices
    rec = {}
    with stage(rec, "s", device):
        hf = sharding.shard_solver(
            attach_fast_operators(hpad8, block=v0 // world_size), mesh)
        x, rel, it = sharding.sharded_solve(hf, b, cfg, mesh)
    bop = hf.levels[0].banded
    lo, hi = hf.spans[0]
    if not (isinstance(bop, BlockDenseOperator) and bop.n_rows == hi - lo
            and bop.m.shape[0] * bop.m.shape[1] == hi - lo):
        raise AssertionError(f"level 0's fast form is not this rank's row "
                             f"blocks {lo}:{hi} of {v0}: {type(bop)}")
    out["fast"] = _solve_record(x, rel, it, rec)
    out["fast"]["m_rows"] = (hi - lo, v0)

    # (4) Halo exchange on the 24k fixture, every level padded.
    h4 = load_solver(HALO_FIXTURE, device)
    b4 = normal_rhs(h4.levels[0].op.num_vertices, 1, device)
    rec = {}
    with stage(rec, "s", device):
        hh = halo.halo_shard_solver(
            sharding.pad_solver_levels(h4, world_size, pad_coarse=True), mesh)
        x, rel, it = halo.halo_solve(hh, b4, cfg, mesh)
    out["halo"] = _solve_record(x, rel, it, rec)
    out["halo"].update(v=int(b4.shape[0]),
                       halo_frac=float(hh.levels[0].op.halo_frac))

    for name in ("sharded", "fast", "halo"):
        r = out[name]
        if not (r["rel"] < cfg.tolerance and r["finite"]):
            raise AssertionError(f"{name} solve: rel {r['rel']} after "
                                 f"{r['iters']} iterations")
    if not out["halo"]["halo_frac"] < HALO_FRAC_MAX:
        raise AssertionError(f"fine halo_frac {out['halo']['halo_frac']}")
    return out


def _placement(n_devices: int, device, backend):
    """(device, backend) of the ranks, or a RuntimeError naming the
    explicit choices when the request cannot be met as it stands."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        if cards < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) runs one NCCL rank a card "
                f"and this process sees {cards} CUDA devices: pass "
                f"device=\"cpu\" for {n_devices} gloo ranks on the CPU, or "
                f"device=\"cuda\", backend=\"gloo\" for {n_devices} ranks "
                f"sharing one card")
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and (dev.type != "cuda" or cards < n_devices):
        raise RuntimeError(
            f"NCCL needs one card a rank: {n_devices} ranks on {dev} with "
            f"{cards} CUDA devices; pass backend=\"gloo\"")
    return dev, backend


def dryrun_multichip(n_devices: int, device=None, backend=None) -> dict:
    """The four multi-device paths on ``n_devices`` ranks (module doc).
    Returns rank 0's iterations, residuals and seconds per path, the
    fine ``halo_frac``, the shapes, and the wall seconds of the whole
    run (spawn included); prints one line of them."""
    dev, backend = _placement(n_devices, device, backend)
    t0 = time.perf_counter()
    res = run_ranks(_dryrun_rank, n_devices, backend, dev)
    wall = time.perf_counter() - t0
    for name in ("sharded", "fast", "halo"):
        seen = {(r[name]["iters"], r[name]["rel"]) for r in res}
        if len(seen) != 1:
            raise AssertionError(f"{name}: ranks disagree: {sorted(seen)}")
    r0 = res[0]
    out = {"n_devices": n_devices, "backend": backend, "device": str(dev),
           "wall_s": wall,
           **{k: r0[k] for k in ("batched", "sharded", "fast", "halo")},
           "s_per_rank": {k: [r[k]["s"] for r in res]
                          for k in ("batched", "sharded", "fast", "halo")}}
    s, f, hl = out["sharded"], out["fast"], out["halo"]
    print(f"dryrun_multichip({n_devices}): ok on {n_devices} {backend} "
          f"ranks ({dev.type}) (batched {out['batched']['shape']}, sharded "
          f"MG-PCG solve rel={s['rel']:.2e} in {s['iters']} iters; "
          f"sharded-M fast solve rel={f['rel']:.2e} in {f['iters']} iters; "
          f"halo solve@{hl['v']}v rel={hl['rel']:.2e} in {hl['iters']} "
          f"iters, fine halo_frac={hl['halo_frac']:.3f}), {wall:.1f} s",
          flush=True)
    return out


def entry_residual(fn, args) -> float:
    """||b - A fn(h, x, b)|| / ||b|| on the finest level."""
    h, _, b = args
    y = fn(*args)
    return float(torch.linalg.norm(b - spmv(h.levels[0].op, y))
                 / torch.linalg.norm(b))


if __name__ == "__main__":
    fn, args = entry()
    print(f"entry: one V-cycle on {args[2].shape[0]} rows, relative "
          f"residual {entry_residual(fn, args):.3e}", flush=True)
    dryrun_multichip(min(8, torch.cuda.device_count()))
