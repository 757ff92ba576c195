"""Rank bodies of the multi-rank tests (no tests here): each runs in a
process that ``gravomg_tpu_torch.parallel.run_ranks`` spawns, so this
module imports torch and the port only (a spawned rank starts from a
fresh interpreter and never reads tests/conftest.py).  Every body takes
(rank, world_size, device, ...) with numpy inputs and returns this
rank's results as CPU tensors or Python numbers; the test compares
them, in rank order, against the unsharded port and the JAX package.
"""

import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.parallel import halo, sharding


def _mesh(world_size):
    return gt.make_mesh(world_size, "data", device_type="cpu")


def _block(x, rank, world_size):
    """Rank's equal row block of a global (n[, D]) numpy array."""
    t = torch.as_tensor(x)
    vd = t.shape[0] // world_size
    return t[rank * vd:(rank + 1) * vd].contiguous()


def halo_products(rank, world_size, device, path, inputs, b, cfg):
    """On the hierarchy of ``path`` padded for the halo path: every
    level's A, U and U^T (``inputs[li]`` = their x, each (n,) or
    (n, D)) through ``halo_matvec``, and one ``halo_v_cycle`` of the
    padded b from zero."""
    mesh = _mesh(world_size)
    hp = gt.pad_solver_levels(gt.load_solver(path, device=device),
                              world_size, pad_coarse=True)
    hs = halo.halo_shard_solver(hp, mesh)
    out = []
    for hl, xs in zip(hs.levels, inputs):
        res = {}
        for name, x in xs.items():
            op = {"A": hl.op, "U": hl.u, "Ut": hl.ut}[name]
            res[name] = [halo.halo_matvec(op, _block(xx, rank, world_size),
                                          mesh) for xx in x]
        out.append(res)
    bl = _block(b, rank, world_size)
    x = halo.halo_v_cycle(hs, torch.zeros_like(bl), bl, cfg, mesh)
    return {"products": out, "cycle": x,
            "halo_frac": [hl.op.halo_frac for hl in hs.levels]}


def halo_runs(rank, world_size, device, path, b, cfg):
    """On the hierarchy of ``path``, padded for the halo path: one
    ``halo_v_cycle`` of the padded b from zero (x0_zero), and
    ``halo_solve`` by MG-PCG and by MG-FCG."""
    mesh = _mesh(world_size)
    hp = gt.pad_solver_levels(gt.load_solver(path, device=device),
                              world_size, pad_coarse=True)
    hs = halo.halo_shard_solver(hp, mesh)
    bt = torch.as_tensor(b)
    bp = bt.new_zeros((hp.levels[0].op.num_vertices,))
    bp[:bt.shape[0]] = bt
    bl = _block(bp, rank, world_size)
    out = {"cycle": halo.halo_v_cycle(hs, torch.zeros_like(bl), bl, cfg,
                                      mesh, x0_zero=True)}
    for method in ("mg_pcg", "mg_fcg"):
        out[method] = halo.halo_solve(hs, bt, cfg, mesh, method=method)
    return out


def sharded_runs(rank, world_size, device, path, b, step_in, xs, bs, cfg):
    """On the hierarchy of ``path``: ``sharded_solve`` by MG-PCG and
    MG-FCG (all levels padded, the coarsest kept), one
    ``vertex_sharded_cg_step`` from ``step_in`` = (x, r, p, rz) on the
    padded fine level, and ``batched_vcycle`` of (xs, bs) on the
    unpadded hierarchy."""
    mesh = _mesh(world_size)
    h = gt.load_solver(path, device=device)
    hs = gt.shard_solver(gt.pad_solver_levels(h, world_size), mesh)
    bt = torch.as_tensor(b)
    out = {m: gt.sharded_solve(hs, bt, cfg, mesh, method=m)
           for m in ("mg_pcg", "mg_fcg")}
    x, r, p, rz = step_in
    step = sharding.vertex_sharded_cg_step(hs, cfg, mesh)
    out["step"] = step(_block(x, rank, world_size),
                       _block(r, rank, world_size),
                       _block(p, rank, world_size), torch.as_tensor(rz))
    out["batched"] = sharding.batched_vcycle(h, cfg, mesh)(
        torch.as_tensor(xs), torch.as_tensor(bs))
    return out


def sharded_fast_runs(rank, world_size, device, path, b, cfg):
    """``sharded_solve`` by MG-PCG on the padded hierarchy of ``path``
    with ELL forms only and with uniform forms attached after padding at
    ``block = rows / ranks`` (row blocks by ``shard_fast_operator``);
    the row counts of the sharded level-0 forms; and this rank's rows of
    level-0 A through its sharded uniform form against the same rows of
    the whole form's product.  The levels are padded to multiples of 8
    ranks: ``attach_fast_operators`` caps a block at an eighth of the
    rows, so 8 blocks cover each padded level exactly and split over
    the ranks."""
    mesh = _mesh(world_size)
    hp = gt.pad_solver_levels(gt.load_solver(path, device=device),
                              8 * world_size)
    v0 = hp.levels[0].op.num_vertices
    hf = gt.attach_fast_operators(hp, block=v0 // world_size)
    bt = torch.as_tensor(b)
    hs = gt.shard_solver(hf, mesh)
    out = {"ell": gt.sharded_solve(gt.shard_solver(hp, mesh), bt, cfg, mesh),
           "fast": gt.sharded_solve(hs, bt, cfg, mesh),
           "rows": [getattr(hs.levels[0], f).n_rows
                    for f in ("banded", "uw", "utw")],
           # Escape entries of A's form: this rank's, and the whole's.
           "escapes": [int((f.esc_rows < f.n_rows).sum())
                       for f in (hs.levels[0].banded, hf.levels[0].banded)]}
    x = torch.randn(v0, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    lo, hi = hs.spans[0]
    out["A"] = (sharding.sharded_matvec(hs, 0, x[lo:hi].contiguous(),
                                        mesh.get_group("data")),
                gt.level_matvec(hf.levels[0], x)[lo:hi])
    return out


def fail_or_wait(rank, world_size, device, mode):
    """Rank 1 raises (``mode`` "raise") or sleeps past the caller's time
    limit ("sleep") while rank 0 waits for it in a collective."""
    import time
    import torch.distributed as dist
    if rank == 1:
        if mode == "raise":
            raise ValueError("rank 1 failed on purpose")
        time.sleep(60)
    dist.barrier()
    return rank
