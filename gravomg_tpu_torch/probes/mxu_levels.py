"""Transposed-tile slab matvec per level and slot, on the card.

    python -m gravomg_tpu_torch.probes.mxu_levels [N]   # N = 200000 by default

Builds the bench's recipe at N points (Morton-ordered torus, grid kNN,
screened Poisson, the hierarchy built on the card), attaches the transposed-tile
(mxu) slab forms, and for every such form (A and U of each level), with
f32 and bf16 m, prints one JSON line (:func:`measure_form`): the time of
the one-launch wrapper per call (CUDA events, median of 10, from an idle
card, so the wrapper's host time is in it), the kernels alone as
torch.profiler saw them, the bytes the work table makes the kernel move,
the bound those bytes set and the share of it reached, the per-bucket
twins' time and, for f32 m, the library's (one ``torch.bmm`` per bucket
on already gathered windows).  ``chip_smoke.py`` prints the same
measurement in its phase 9.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.ops.mxu_cuda import (mxu_matvec_plain,
                                            mxu_slab_matvec_cuda, plan_bytes)
from gravomg_tpu_torch.ops.slab import SlabOperator
from gravomg_tpu_torch.probes.timing import (bucket_loop, cuda_ms,
                                             kernel_events, library_bmm,
                                             matvec_bound)
from gravomg_tpu_torch.utils.stage import synchronize


BUILD_SEED = 0      # of the generator the sampling priorities come from


def bench_problem(n: int, device=None):
    """The bench's problem at ``n`` points on ``device`` (the card
    unless the caller names another): Morton-ordered torus, grid kNN,
    screened Poisson.  Returns (config, graph, operator, seconds)."""
    t0 = time.perf_counter()
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph = gt.grid_knn_graph_nosync(pts, 16, margin=2.4, device=device)
    op, _ = gt.screened_poisson_operator(graph, alpha="auto")
    synchronize(op.diag.device)
    cfg = gt.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")
    return cfg, graph, op, time.perf_counter() - t0


def bench_hierarchy(n: int, device=None):
    """The bench's recipe at ``n`` points on ``device`` (the card unless
    the caller names another), the hierarchy built there by
    ``build_hierarchy_device`` with random priorities from a generator
    seeded with ``BUILD_SEED`` (no fast forms yet).  Returns (config,
    solver hierarchy, {seconds of the front end and of the hierarchy
    build, per-level stage seconds and statistics, peak device memory
    of the build (None off the card)}, graph, operator)."""
    cfg, graph, op, front_s = bench_problem(n, device)
    dev = op.diag.device
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(BUILD_SEED)
    record = []
    t1 = time.perf_counter()
    h, stats = gt.build_hierarchy_device(graph, op, cfg, generator=gen,
                                         record=record)
    synchronize(dev)
    return cfg, h.solver, {
        "front_s": front_s, "hierarchy_s": time.perf_counter() - t1,
        "build_peak_bytes": (torch.cuda.max_memory_allocated()
                             if on_card else None),
        "stages": record, "stats": [s._asdict() for s in stats]}, graph, op


def slab_forms(h, mxu: bool):
    """(label, slab operator) for every slab form of the hierarchy: the
    transposed-tile ones if ``mxu``, else the 8-row ones."""
    return [(f"L{li} {label}", getattr(lvl, field))
            for li, lvl in enumerate(h.levels)
            for field, label in (("banded", "A"), ("uw", "U"), ("utw", "U^T"))
            if isinstance(getattr(lvl, field), SlabOperator)
            and getattr(lvl, field).mxu == mxu]


def measure_form(sop, x, dt) -> dict:
    """One transposed-tile form with m of dtype ``dt``: twins, kernel,
    kernel, twins per call; the kernels alone; the library's bmm for f32
    (none for bf16 m: ``torch.bmm`` in bf16 rounds its output); the
    bytes by the work table, the bound and the shares.  Every timed call
    starts with L2 flushed: the coarse levels' working sets fit in L2,
    and a V-cycle walks the other levels between two products of one."""
    sd = sop._replace(buckets=tuple(b._replace(m=b.m.to(dt).contiguous())
                                    for b in sop.buckets))
    twin = bucket_loop(mxu_matvec_plain, sd.buckets, x)
    p1 = cuda_ms(twin, cold=True)
    k1 = cuda_ms(lambda: mxu_slab_matvec_cuda(sd, x), cold=True)
    k2 = cuda_ms(lambda: mxu_slab_matvec_cuda(sd, x), cold=True)
    p2 = cuda_ms(twin, cold=True)
    lib_ms = (cuda_ms(library_bmm(sd.buckets, x), cold=True)
              if dt == torch.float32 else None)
    bound_ms, bound_by, io_bytes = matvec_bound(sd.buckets, x, sd.plan)
    pb = plan_bytes(sd.buckets, sd.plan)
    k_ms = min(k1, k2)
    # The kernels alone (the persistent one and the combination),
    # without the wrapper's host time and x's padding.
    evts = kernel_events(lambda: mxu_slab_matvec_cuda(sd, x), "mxu_",
                         cold=True)
    alone_ms = sum(us for _, us in evts) / 1e3 if evts else None
    return {"rows": sop.n_rows, "kernel_ms": [k1, k2], "plain_ms": [p1, p2],
            "kernel_alone_ms": alone_ms,
            "kernels_us": [round(us, 1) for _, us in evts],
            "alone_share_of_bound": bound_ms / alone_ms if alone_ms else None,
            "m_bytes": sd.m_bytes, "bytes": pb, "io_bytes": io_bytes,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / k_ms, "library_ms": lib_ms,
            "items": int(sd.plan.items.shape[0]),
            "alone_GBps": (pb["tiles"] / (alone_ms * 1e-3) / 1e9
                           if alone_ms else None),
            "kernel_GBps": pb["tiles"] / (k_ms * 1e-3) / 1e9}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("mxu_levels: no CUDA device; this probe runs only on a card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    n = int(argv[1]) if len(argv) > 1 else 200_000
    _, h, _, _, _ = bench_hierarchy(n)
    h = gt.attach_slab_operators(h, mxu=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, sop in slab_forms(h, mxu=True):
        x = torch.randn(sop.n_cols, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            print(json.dumps({"slot": label, "dtype": str(dt).split(".")[-1],
                              **measure_form(sop, x, dt)}))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
