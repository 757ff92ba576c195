#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and the
script exits nonzero:

  1. environment: torch, CUDA, the card's name and power limit, nvcc,
     g++ and triton versions;
  2. build: the three kernels (nvcc, sm_90a, one process per source) and
     the C++ coarsener (g++) from the sources in the checkout, all
     started together;
  3. setup at n = 1,000,000 (the bench's recipe): Morton-ordered torus,
     grid kNN (k=16), screened-Poisson operator (alpha="auto"), the
     hierarchy built on the card by ``build_hierarchy_device`` (random
     priorities from a seeded generator; coarse_threshold=1000,
     Chebyshev) with, per level, its sizes, triangles, prolongation case
     counts, sampling rounds and seconds per stage, the build's peak
     device memory, and the same build by ``build_hierarchy`` (the
     reference's sampling, on the card) and by ``build_hierarchy_host``
     (the C++ coarsener) for their seconds; the slab forms; then the
     kernel against its plain twin on every bucket of every slab form
     (A, U and U^T of each level), f32 and bf16 m, at 1e-6 * max|y|;
  4. fixture parity: assets/halo_hierarchy.npz on the card against the
     same fixture on the CPU (one V-cycle, and MG-PCG iterations);
  5. the main path at 1M: V-cycle time (CUDA events, median), MG-PCG
     and mg_solve (bf16-preconditioned flexible CG at this size) to
     1e-8, with the kernel's launch count over this phase; fails if a
     level of at least 4096 rows lacks a slab form; then the same two
     solves on the greedy hierarchy of the C++ coarsener (iteration
     counts within 2 of the main path's);
  6. timing: the kernel against its twin, per level-0 A matvec;
  7. profile: torch.profiler over one 1M V-cycle (device busy share, top
     device kernels), the level-0 A matvec as slab against the plain
     ELL gather, and the kernel's time per level-0 bucket;
  8. the 1M level-0 A's window counts at 128-row blocks: the blocks that
     need more than 24 windows keep the transposed-tile (mxu) form off
     the 1M fine level, so its path runs at 200k;
  9. the mxu path at n = 200,000 (the same recipe, built on the card):
     ``attach_fast_operators(attach_slab_operators(h, mxu=True))``; each
     slot's form (MXU, uniform or ELL), its window count and m bytes,
     failing if a slab slot of at most 24 windows lacks its MXU form;
     the transposed-tile kernel against its twin on every bucket of
     every MXU form (a work table of one bucket), then its one launch
     per slab matvec on every whole MXU form against the per-bucket
     twins and against the plain walk of the same work table, f32 and
     bf16 m, at 1e-6 * max|y|, and twice on one input (the two y must be
     bitwise equal); the V-cycle, MG-PCG and bf16-preconditioned
     flexible CG to 1e-8 on the card, the same solves on a CPU copy of
     the hierarchy (run last; iteration counts within 1, the bf16
     solve's within 3: see phase_mxu_compare); per level and slot the
     kernel's time per matvec, the kernels alone, the bytes the work
     table makes it read (a bucket's padding blocks are not read), GB/s
     of them, bound and share of bound, f32 and bf16, with one torch.bmm
     per bucket on already gathered windows as the library's time for
     f32; the level-0 A matvec in the 8-row slab form (block-window
     kernel); the bf16 solve on the card with its matvecs through the
     kernel, the plain walk and the per-bucket twins (phase_fcg_order);
     peak device memory;
 10. the gather probes (``gravomg_tpu_torch/probes/gather.py``) at
     V = 200,000 and 1,000,000: their kernel against its twin at
     1e-6 * max|y|, bitwise repeatable, times, GB/s, bound and share;
 11. the build against the C++ coarsener at 200k
     (``gravomg_tpu_torch/probes/build_check.py``): ``build_hierarchy``
     on the card in f64 (samples equal, parents equal up to ties,
     adjacency equal, U rows at 1e-10, level sizes) and in f32 (each
     level against the coarsener on that level's graph: sample flips
     with their margin to the radius, U rows at 1e-5 with under 0.5%
     flipped), with the case counts per level;
 12. the other solve loops at 200k, once each: ``fmg``,
     ``solve_with_history`` (30 cycles) and ``solve_refined`` (to 1e-8).

A kernel's bound is the least time the card could take: the bytes of its
inputs and outputs that it must move, each once, over the H100's
published 3.35 TB/s, or its multiply-adds over the published 67 TFLOP/s
of f32 outside the tensor cores, whichever is larger (bytes, for all
three kernels); gravomg_tpu_torch/probes/timing.py computes it.

The line before the last is a JSON object describing the three kernels;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the package beside this script, it exits nonzero and prints
no result.  Longer results go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 1_000_000
N_MXU = 200_000            # the mxu path's size (phase 8 says why)
TOL_KERNEL = 1e-6          # max|kernel - twin| / max|twin|
FIELDS = (("banded", "A"), ("uw", "U"), ("utw", "U^T"))


def _run(cmd):
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e.__class__.__name__})"
    return (proc.stdout or proc.stderr).strip()


def phase_environment(torch):
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    from gravomg_tpu_torch.utils.build import nvcc as nvcc_path
    nvcc = _run([nvcc_path(), "--version"]).splitlines()
    gxx = _run(["g++", "--version"]).splitlines()
    try:
        import triton
        tri = triton.__version__
    except ImportError:
        tri = "not installed"
    print(f"[1] nvcc: {nvcc[-1] if nvcc else '?'} | g++: "
          f"{gxx[0] if gxx else '?'} | triton: {tri}")
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "nvidia_smi": smi[0] if smi else None,
            "device": torch.cuda.get_device_name(0)}


def _libraries():
    from gravomg_tpu_torch.ops import blockdense_cuda, mxu_cuda, window_gather
    return {"blockdense_matvec": blockdense_cuda.LIBRARY,
            "mxu_matvec": mxu_cuda.LIBRARY,
            "window_gather": window_gather.LIBRARY}


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from gravomg_tpu_torch.io import native
    from gravomg_tpu_torch.utils.build import NVCC_FLAGS

    def timed(build):
        t0 = time.perf_counter()
        build()
        return time.perf_counter() - t0

    libs = _libraries()
    builds = {name: (lambda lib=lib: lib.build(force=True))
              for name, lib in libs.items()}
    builds["coarsener"] = lambda: native.build_library(force=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, fn)
                   for name, fn in builds.items()}
        secs = {name: f.result() for name, f in futures.items()}
    wall = time.perf_counter() - t0
    for lib in libs.values():
        lib.load()
    print(f"[2] built in {wall:.2f} s, all started together: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in secs.items())
          + f" (nvcc {' '.join(NVCC_FLAGS)}; coarsener g++)")
    return {"wall_s": wall, "build_s": secs}


def build_problem(torch, n, tag):
    """The bench's recipe at ``n`` points, hierarchy built on the card
    (no fast forms yet), with its set-up times and the per-level table
    of the build."""
    from gravomg_tpu_torch.hierarchy import STAGES
    from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
    cfg, h, info, graph, op = bench_hierarchy(n)
    info["levels"] = [lvl.op.num_vertices for lvl in h.levels]
    print(f"[{tag}] setup n={n}: graph+operator {info['front_s']:.1f} s, "
          f"hierarchy on the card (build_hierarchy_device) "
          f"{info['hierarchy_s']:.3f} s, peak device memory of the build "
          f"{info['build_peak_bytes']} bytes; levels {info['levels']}")
    for st, rec in zip(info["stats"], info["stages"]):
        print(f"[{tag}]   {st['n_fine']} -> {st['n_coarse']} rows, "
              f"{st['n_triangles']} triangles, cases hit/edge/point "
              f"{st['triangle_hits']}/{st['edge_fallbacks']}/"
              f"{st['point_fallbacks']}, {rec['sampling_rounds']} sampling "
              f"rounds; s: " + ", ".join(f"{k} {rec[k]:.3f}" for k in STAGES))
    return cfg, h, info, graph, op


def phase_setup(torch):
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.hierarchy import STAGES, build_hierarchy
    cfg, h, info, graph, op = build_problem(torch, N, "3")
    # The same build with the reference's sampling, on the card and by
    # the C++ coarsener on the host.
    rec = []
    t0 = time.perf_counter()
    build_hierarchy(graph, op, cfg, record=rec)
    torch.cuda.synchronize()
    info["exact_s"] = time.perf_counter() - t0
    info["exact_rounds"] = [r["sampling_rounds"] for r in rec]
    info["exact_sampling_s"] = [r["sampling"] for r in rec]
    info["exact_stages"] = rec
    t0 = time.perf_counter()
    h_greedy = gt.build_hierarchy_host(graph, op, cfg)
    torch.cuda.synchronize()
    info["host_s"] = time.perf_counter() - t0
    info["host_levels"] = [lvl.op.num_vertices for lvl in h_greedy.levels]
    print(f"[3] build total: random priorities on the card "
          f"{info['hierarchy_s']:.3f} s; the reference's sampling on the "
          f"card {info['exact_s']:.3f} s (sampling rounds "
          f"{info['exact_rounds']}, sampling s "
          f"{[round(x, 3) for x in info['exact_sampling_s']]}); C++ "
          f"coarsener on the host {info['host_s']:.3f} s (levels "
          f"{info['host_levels']})")
    # The second build of the process: its level-0 stages no longer hold
    # what a library sets up at its first call.
    print("[3] level-0 stage s of that second build (the reference's "
          "sampling): " + ", ".join(f"{k} {rec[0][k]:.3f}" for k in STAGES))
    t0 = time.perf_counter()
    h = gt.attach_slab_operators(h)
    torch.cuda.synchronize()
    info["slab_s"] = time.perf_counter() - t0
    print(f"[3] slab forms {info['slab_s']:.1f} s")
    return cfg, h, h_greedy, info


def _bucket_on(b, dtype):
    return b._replace(m=b.m.to(dtype).contiguous())


def _slab_on(sop, dtype):
    return sop._replace(buckets=tuple(_bucket_on(b, dtype)
                                      for b in sop.buckets))


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _slabs(h, mxu=False):
    from gravomg_tpu_torch.probes.mxu_levels import slab_forms
    return slab_forms(h, mxu)


def phase_kernel_check(torch, h):
    """The kernel against its twin on every bucket of every slab form of
    the 1M hierarchy (A, U and U^T of each level), f32 and bf16 m."""
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain)
    return _check_buckets(torch, _slabs(h), blockdense_matvec_cuda,
                          blockdense_matvec_plain, "3", "kernel")


def _check_buckets(torch, slabs, kernel, plain, tag, what):
    """``kernel`` against its twin ``plain`` on every bucket of every
    slab form in ``slabs``, f32 and bf16 m, at ``TOL_KERNEL``."""
    from gravomg_tpu_torch.ops.blockdense import pad_x
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, shapes, worst_rel, worst_abs = [], set(), 0.0, 0.0
    for label, sop in slabs:
        x = torch.randn(sop.n_cols, generator=gen, device="cuda")
        xp = pad_x(sop.buckets[0], x)
        worst, bad = {}, []
        for dt in (torch.float32, torch.bfloat16):
            name = _dtype_name(dt)
            worst[name] = 0.0
            for b in sop.buckets:
                bb = _bucket_on(b, dt)
                yk = kernel(bb, x, xp)
                yp = plain(bb, x, xp)
                torch.cuda.synchronize()
                err = float((yk - yp).abs().max())
                rel = err / max(float(yp.abs().max()), 1e-30)
                worst[name] = max(worst[name], rel)
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
                shapes.add((b.nw, b.n_rows, b.n_cols))
                rows.append({"slab": label, "nw": b.nw,
                             "nblk": b.m.shape[0], "n_cols": b.n_cols,
                             "dtype": name, "max_abs_err": err,
                             "rel_err": rel})
                if not rel <= TOL_KERNEL:
                    bad.append(f"cap {b.nw} {name}: {rel:.3e}")
        print(f"[{tag}] {what} vs twin {label:6s} {sop.n_rows}x"
              f"{sop.n_cols}, caps {[b.nw for b in sop.buckets]}: "
              f"max|d|/max|y| f32 {worst['float32']:.3e}, bf16 "
              f"{worst['bfloat16']:.3e}")
        if bad:
            raise AssertionError(f"{what} disagrees with its twin on "
                                 f"{label} beyond {TOL_KERNEL}: {bad}")
    if not slabs:
        raise AssertionError(f"no slab form to check the {what} on")
    print(f"[{tag}] {what} vs twin ok on {len(slabs)} slab forms, "
          f"{len(shapes)} distinct (cap, n_rows, n_cols) bucket shapes, "
          f"f32 and bf16 m, worst {worst_rel:.3e} <= {TOL_KERNEL}")
    return {"buckets": rows, "shapes": len(shapes), "worst_rel": worst_rel,
            "worst_abs": worst_abs}


def phase_fixture(torch):
    import numpy as np
    import gravomg_tpu_torch as gt
    path = os.path.join(ROOT, "assets", "halo_hierarchy.npz")
    cfg = gt.MultigridConfig(smoother="chebyshev")
    b = np.random.default_rng(0).normal(size=24000).astype(np.float32)
    runs = {}
    for dev in ("cpu", "cuda"):
        h = gt.attach_slab_operators(gt.load_solver(path, device=dev))
        bt = torch.as_tensor(b, device=dev)
        x1 = gt.v_cycle(h, torch.zeros_like(bt), bt, cfg)
        _, rel, it = gt.mg_pcg(h, bt, cfg)
        runs[dev] = (x1.cpu(), rel, it)
    x_c, rel_c, it_c = runs["cpu"]
    x_g, rel_g, it_g = runs["cuda"]
    d = float((x_g - x_c).norm() / x_c.norm())
    print(f"[4] fixture 24k: V-cycle card vs CPU rel diff {d:.2e}; mg_pcg "
          f"card {it_g} it rel {rel_g:.3e}, CPU {it_c} it rel {rel_c:.3e}")
    if not (rel_g <= 1e-8 and abs(it_g - it_c) <= 1 and d <= 1e-3):
        raise AssertionError("fixture parity failed")
    return {"vcycle_rel_diff": d, "pcg_card": [it_g, rel_g],
            "pcg_cpu": [it_c, rel_c]}


def _fmt(v, digits=3) -> str:
    return "not measured" if v is None else f"{v:.{digits}f}"


def _m_bytes_read(op):
    """Bytes of m one slab matvec of ``op`` reads: every block of every
    bucket through the block-window kernel; through the transposed-tile
    kernel the tiles its work table names (padding blocks have no item)."""
    from gravomg_tpu_torch.ops.mxu_cuda import plan_bytes
    if not op.mxu:
        return op.m_bytes
    return plan_bytes(op.buckets, op.plan)["tiles"]


def _cycle_account(torch, cfg, h, b, wrapper, tag, what):
    """One V-cycle with every slab matvec counted: the matvecs, the
    launches of ``wrapper``'s kernel, the bytes of m they read and the
    bound those bytes set on the cycle's kernel time."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.probes.timing import HBM_BYTES_PER_S
    from gravomg_tpu_torch.solve import vcycle
    seen = {"matvecs": 0, "m_bytes": 0}
    inner = vcycle.slab_matvec

    def counted(op, x):
        seen["matvecs"] += 1
        seen["m_bytes"] += _m_bytes_read(op)
        return inner(op, x)

    before = wrapper.launches
    vcycle.slab_matvec = counted
    try:
        gt.v_cycle(h, torch.zeros_like(b), b, cfg)
        torch.cuda.synchronize()
    finally:
        vcycle.slab_matvec = inner
    seen["launches"] = wrapper.launches - before
    seen["bound_ms"] = seen["m_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] one V-cycle: {seen['matvecs']} slab matvecs, "
          f"{seen['launches']} launches of the {what}, m bytes read "
          f"{seen['m_bytes']}, bound {seen['bound_ms']:.3f} ms (bytes of m "
          f"over {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    return seen


def phase_main(torch, cfg, h, h_greedy):
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matvec_cuda
    from gravomg_tpu_torch.probes.timing import cuda_ms
    b = torch.as_tensor(np.random.default_rng(0).normal(size=N)
                        .astype(np.float32), device="cuda")
    blockdense_matvec_cuda.launches = 0
    vc_ms = cuda_ms(lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
    out = {"vcycle_ms": vc_ms}
    for name, solver in (("mg_pcg", gt.mg_pcg), ("mg_solve", gt.mg_solve)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, rel, it = solver(h, b, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = (x.shape == b.shape and x.dtype == torch.float32
              and bool(torch.isfinite(x).all()))
        out[name] = {"iters": it, "rel": rel, "wall_s": wall}
        print(f"[5] {name}: {it} iterations, rel residual {rel:.3e}, "
              f"{wall:.3f} s")
        if not (ok and rel <= 1e-8):
            raise AssertionError(f"{name} failed: rel {rel}, finite/shape "
                                 f"ok {ok}")
    launches = blockdense_matvec_cuda.launches
    out["cycle"] = _cycle_account(torch, cfg, h, b, blockdense_matvec_cuda,
                                  "5", "block-window kernel")
    from gravomg_tpu_torch.solve.vcycle import slab_slots
    slots = slab_slots(h)
    missing = [s for s in slots if getattr(h.levels[s[0]], s[1]) is None]
    if missing:
        raise AssertionError(f"levels without their slab forms (the plain "
                             f"ELL gather would stand in for the kernel): "
                             f"{missing}")
    mb = [[None if s is None else s.m_bytes
           for s in (lvl.banded, lvl.uw, lvl.utw)] for lvl in h.levels]
    print(f"[5] V-cycle {vc_ms:.3f} ms (median of 10, CUDA events); "
          f"levels {[lvl.op.num_vertices for lvl in h.levels]}")
    print(f"[5] slab m bytes per level [A, U, U^T]: {mb}")
    print(f"[5] all {len(slots)} slab slots (A, U, U^T of levels >= 4096 "
          f"rows) hold slab forms; block-window kernel launches in this "
          f"phase: {launches}")
    if launches <= 0:
        raise AssertionError("the main path never launched the kernel")
    out.update(launches=launches, m_bytes=mb)
    hg = gt.attach_slab_operators(h_greedy)
    for name, solver in (("mg_pcg", gt.mg_pcg), ("mg_solve", gt.mg_solve)):
        _, rel, it = solver(hg, b, cfg)
        out[f"{name}_greedy"] = {"iters": it, "rel": rel}
        print(f"[5] {name} on the greedy hierarchy of the C++ coarsener: "
              f"{it} iterations, rel residual {rel:.3e} (random-priority "
              f"hierarchy: {out[name]['iters']})")
        if not (rel <= 1e-8 and abs(it - out[name]["iters"]) <= 2):
            raise AssertionError(f"{name}: {out[name]['iters']} iterations "
                                 f"on the random-priority hierarchy, {it} "
                                 f"(rel {rel}) on the greedy one")
    return out


def phase_timing(torch, h):
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain)
    from gravomg_tpu_torch.probes.timing import (bucket_loop, cuda_ms,
                                                 library_bmm, matvec_bound)
    a0 = h.levels[0].banded
    x = torch.randn(a0.n_cols, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        bs = [_bucket_on(b, dt) for b in a0.buckets]
        kern = bucket_loop(blockdense_matvec_cuda, bs, x)
        plain = bucket_loop(blockdense_matvec_plain, bs, x)
        # plain, kernel, kernel, plain: compare within one call.
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        name = _dtype_name(dt)
        mbytes = sum(b.m.numel() * b.m.element_size() for b in bs)
        k_ms = min(k1, k2)
        bound_ms, bound_by, io_bytes = matvec_bound(bs, x)
        # No library call for bf16 m: torch.bmm in bf16 rounds its output.
        lib_ms = (cuda_ms(library_bmm(bs, x))
                  if dt == torch.float32 else None)
        res[name] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                     "m_bytes": mbytes, "io_bytes": io_bytes,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "share_of_bound": bound_ms / k_ms,
                     "library_ms": lib_ms,
                     "kernel_GBps": mbytes / (k_ms * 1e-3) / 1e9}
        print(f"[6] level-0 A ({len(bs)} buckets, m {mbytes / 1e9:.3f} GB "
              f"{name}): kernel {k1:.3f}/{k2:.3f} ms, twin {p1:.3f}/"
              f"{p2:.3f} ms per matvec ({res[name]['kernel_GBps']:.0f} GB/s "
              f"of m through the kernel, escape and diag included); bound "
              f"{bound_ms:.3f} ms ({bound_by}, {io_bytes} bytes), share "
              f"{bound_ms / k_ms:.2f}; library (one torch.bmm per bucket, "
              f"windows already gathered) "
              + ("none" if lib_ms is None else f"{lib_ms:.3f} ms"))
    return res


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile_vcycle(torch, cfg, h, b, vcycle_ms, tag):
    """torch.profiler over one V-cycle: device time, busy share against
    ``vcycle_ms`` and the top device kernels."""
    import gravomg_tpu_torch as gt
    from torch.profiler import ProfilerActivity, profile
    gt.v_cycle(h, torch.zeros_like(b), b, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gt.v_cycle(h, torch.zeros_like(b), b, cfg)
        torch.cuda.synchronize()
    # Device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched.
    evts = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and _device_us(e) > 0]
    dev_ms = sum(_device_us(e) for e in evts) / 1e3
    top = sorted(evts, key=_device_us, reverse=True)[:8]
    rows = [{"name": e.key[:80], "calls": e.count,
             "device_ms": _device_us(e) / 1e3} for e in top]
    share = dev_ms / vcycle_ms if vcycle_ms else float("nan")
    print(f"[{tag}] V-cycle device time {dev_ms:.3f} ms of {vcycle_ms:.3f} "
          f"ms (busy share {share:.2f}, idle {1 - share:.2f}); "
          f"{sum(e.count for e in evts)} device ops")
    for r in rows:
        print(f"[{tag}]   {r['device_ms']:8.3f} ms {r['calls']:6d}x "
              f"{r['name']}")
    return {"vcycle_device_ms": dev_ms, "busy_share": share, "top": rows}


def phase_profile(torch, cfg, h, vcycle_ms):
    """Where a 1M V-cycle's device time goes, and the level-0 A matvec
    as slab (kernel) against the plain ELL gather."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.probes.timing import cuda_ms, kernel_events
    b = torch.randn(N, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    out = _profile_vcycle(torch, cfg, h, b, vcycle_ms, "7")
    lvl0 = h.levels[0]
    x = torch.randn(N, device="cuda")
    ell_ms = out["ell_spmv_ms"] = cuda_ms(lambda: gt.spmv(lvl0.op, x))
    hb = gt.cast_fast_operators(h, torch.bfloat16)
    for name, lvl in (("float32", lvl0), ("bfloat16", hb.levels[0])):
        slab_ms = cuda_ms(lambda: gt.level_matvec(lvl, x))
        # Each bucket's kernel alone, in launch (= bucket) order.
        kev = kernel_events(lambda: gt.level_matvec(lvl, x),
                            "blockdense_matvec_kernel")
        k1_ms = sum(us for _, us in kev) / 1e3
        print(f"[7] level-0 A matvec, {name} m: slab {slab_ms:.3f} ms (K1 "
              f"kernels alone {k1_ms:.3f} ms), plain ELL gather (f32) "
              f"{ell_ms:.3f} ms")
        per_bucket = []
        if len(kev) == len(lvl.banded.buckets):
            for b, (_, us) in zip(lvl.banded.buckets, kev):
                nbytes = b.m.numel() * b.m.element_size()
                per_bucket.append({"nw": b.nw, "nblk": b.m.shape[0],
                                   "m_bytes": nbytes, "us": us,
                                   "GBps": nbytes / max(us, 1e-3) / 1e3})
            print(f"[7] K1 per level-0 bucket, {name} (cap nblk: us, GB/s "
                  f"of m): " + "; ".join(
                      f"{r['nw']} {r['nblk']}: {r['us']:.1f}, "
                      f"{r['GBps']:.0f}" for r in per_bucket))
        else:
            print(f"[7] K1 per bucket: {len(kev)} kernel events for "
                  f"{len(lvl.banded.buckets)} buckets, not matched")
        out[name] = {"slab_matvec_ms": slab_ms, "k1_kernels_ms": k1_ms,
                     "k1_per_bucket": per_bucket}
    return out


def _window_counts(lvl, field):
    """Windows each 128-row block of a slot needs (up to 64), by the
    rule of the transposed-tile conversion."""
    from gravomg_tpu_torch.ops.slab import MXU_BLOCK, WINDOW, window_counts
    from gravomg_tpu_torch.solve.vcycle import slot_ell
    cols, vals, valid, _, _ = slot_ell(lvl, field)
    counts, _, _ = window_counts(cols, valid & (vals != 0), MXU_BLOCK,
                                 WINDOW, nw_max=64, align=WINDOW)
    return counts


def phase_window_finding(h):
    from gravomg_tpu_torch.ops.slab import NW_MAX
    counts = _window_counts(h.levels[0], "banded")
    over, mx = int((counts > NW_MAX).sum()), int(counts.max())
    print(f"[8] 1M level-0 A at 128-row blocks: {over} of {counts.numel()} "
          f"blocks need more than {NW_MAX} windows (max {mx}), so the "
          f"transposed-tile form cannot take the 1M fine level; the mxu "
          f"path runs at {N_MXU}")
    return {"blocks": counts.numel(), "over_24": over, "max": mx}


def _fast_kind(op):
    from gravomg_tpu_torch.ops.slab import SlabOperator
    if op is None:
        return "ELL"
    if isinstance(op, SlabOperator):
        return "MXU" if op.mxu else "slab"
    return "uniform"


def _m_bytes(op):
    from gravomg_tpu_torch.ops.slab import SlabOperator
    if op is None:
        return 0
    if isinstance(op, SlabOperator):
        return op.m_bytes
    return op.m.numel() * op.m.element_size()


def phase_mxu_setup(torch):
    """The 200k hierarchy with the mxu forms; each slot's form, window
    count and m bytes; fails if a slab slot of at most 24 windows lacks
    its MXU form."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.slab import NW_MAX, slab_from_operator
    from gravomg_tpu_torch.solve.vcycle import slab_slots
    cfg, h, info, graph, op = build_problem(torch, N_MXU, "9")
    t0 = time.perf_counter()
    hm = gt.attach_fast_operators(gt.attach_slab_operators(h, mxu=True))
    torch.cuda.synchronize()
    info["attach_s"] = time.perf_counter() - t0
    # Level-0 A in the 8-row slab form (block-window kernel), for timing.
    a0_vpu = slab_from_operator(hm.levels[0].op, escape_cap=65536)
    slots = set(slab_slots(hm))
    last = len(hm.levels) - 1
    rows, bad = [], []
    for li, lvl in enumerate(hm.levels):
        for field, label in FIELDS:
            if (li == last) if field == "banded" else lvl.u is None:
                continue
            form = getattr(lvl, field)
            mx = int(_window_counts(lvl, field).max())
            kind = _fast_kind(form)
            rows.append({"slot": f"L{li} {label}", "form": kind,
                         "max_windows": mx, "m_bytes": _m_bytes(form),
                         "slab_slot": (li, field) in slots})
            print(f"[9] L{li} {label:3s} form {kind:7s} max windows at "
                  f"128-row blocks {mx:2d}, m bytes {_m_bytes(form)}"
                  + ("" if (li, field) in slots else " (below 4096 rows)"))
            if (li, field) in slots and mx <= NW_MAX and kind != "MXU":
                bad.append(f"L{li} {label}")
    print(f"[9] attach {info['attach_s']:.1f} s; uniform forms run plain "
          f"torch, as the JAX package runs them through XLA")
    if bad:
        raise AssertionError(f"slab slots of at most {NW_MAX} windows "
                             f"without their MXU form: {bad}")
    info["slots"] = rows
    return cfg, hm, a0_vpu, info, graph, op


def _to_device(torch, obj, dev):
    """A copy of a hierarchy (nested named tuples and tuples of tensors)
    on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        items = [_to_device(torch, v, dev) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def phase_mxu_main(torch, cfg, hm, dev, out):
    """The mxu path on ``dev``: MG-PCG and bf16-preconditioned flexible
    CG to 1e-8, into ``out``.  On the card also the V-cycle's time, the
    kernel's launch count (set to 0 just before, read just after), the
    cycle's account and a profile of one V-cycle; on the CPU the solves
    run on a copy of the hierarchy."""
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.mxu_cuda import mxu_matvec_cuda
    from gravomg_tpu_torch.probes.timing import cuda_ms
    b_np = np.random.default_rng(0).normal(size=N_MXU).astype(np.float32)
    solves = {
        "mg_pcg": lambda h, h16, b: gt.mg_pcg(h, b, cfg),
        "mg_fcg_bf16": lambda h, h16, b: gt.mg_fcg(h16, b, cfg, h_outer=h),
    }
    h = hm if dev == "cuda" else _to_device(torch, hm, "cpu")
    h16 = gt.cast_fast_operators(h, torch.bfloat16)
    b = torch.as_tensor(b_np, device=dev)
    if dev == "cuda":
        mxu_matvec_cuda.launches = 0
        out["vcycle_ms"] = cuda_ms(
            lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
    for name, solve in solves.items():
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, rel, it = solve(h, h16, b)
        if dev == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok = (x.shape == b.shape and x.dtype == torch.float32
              and bool(torch.isfinite(x).all()))
        out[f"{name}_{dev}"] = {"iters": it, "rel": rel, "wall_s": wall}
        print(f"[9] {name} on {dev}: {it} iterations, rel residual "
              f"{rel:.3e}, {wall:.3f} s")
        if not (ok and rel <= 1e-8):
            raise AssertionError(f"{name} on {dev} failed: rel {rel}, "
                                 f"finite/shape ok {ok}")
    if dev == "cuda":
        out["launches"] = mxu_matvec_cuda.launches
        print(f"[9] V-cycle {out['vcycle_ms']:.3f} ms (median of 10, "
              f"CUDA events); transposed-tile kernel launches in the "
              f"card's run: {out['launches']}")
        if out["launches"] <= 0:
            raise AssertionError("the mxu path never launched the "
                                 "transposed-tile kernel")
        out["cycle"] = _cycle_account(torch, cfg, h, b, mxu_matvec_cuda,
                                      "9", "transposed-tile kernel")
        out["profile"] = _profile_vcycle(torch, cfg, h, b,
                                         out["vcycle_ms"], "9")
    return out


def phase_mxu_compare(out):
    """Iteration counts of the mxu path, card against CPU copy.  MG-PCG
    within 1.  The bf16 solve within 3: rounding x to bf16 makes its
    V-cycle discontinuous, so another summation order alone moves its
    count by up to 2 (tests/test_torch_fast_operators.py)."""
    for name, bound in (("mg_pcg", 1), ("mg_fcg_bf16", 3)):
        ic, ih = out[f"{name}_cuda"]["iters"], out[f"{name}_cpu"]["iters"]
        print(f"[9] {name}: {ic} iterations on the card, {ih} on the CPU "
              f"(bound {bound})")
        if abs(ic - ih) > bound:
            raise AssertionError(f"{name}: {ic} iterations on the card, "
                                 f"{ih} on the CPU")


def phase_mxu_slab_check(torch, hm):
    """The one-launch kernel on every whole MXU form against the
    per-bucket twins (concatenated and un-permuted, as the JAX package
    combines its buckets) and against the plain walk of the same work
    table, f32 and bf16 m, at ``TOL_KERNEL``; twice on one input, the
    two y bitwise equal."""
    from gravomg_tpu_torch.ops.blockdense import pad_x
    from gravomg_tpu_torch.ops.mxu_cuda import (mxu_matvec_plain,
                                                mxu_slab_matvec_cuda,
                                                mxu_slab_matvec_plain)
    gen = torch.Generator(device="cuda").manual_seed(4)
    rows, worst_rel, worst_abs = [], 0.0, 0.0
    slabs = _slabs(hm, mxu=True)
    for label, sop in slabs:
        x = torch.randn(sop.n_cols, generator=gen, device="cuda")
        xp = pad_x(sop.buckets[0], x)
        for dt in (torch.float32, torch.bfloat16):
            name = _dtype_name(dt)
            sd = _slab_on(sop, dt)
            y1 = mxu_slab_matvec_cuda(sd, x)
            y2 = mxu_slab_matvec_cuda(sd, x)
            ycat = torch.cat([mxu_matvec_plain(b, x, xp).reshape(-1, 128)
                              for b in sd.buckets])
            refs = {"per-bucket twins":
                    ycat[sd.inv_block_perm].reshape(-1)[:sd.n_rows],
                    "plain walk": mxu_slab_matvec_plain(sd, x)}
            torch.cuda.synchronize()
            if not torch.equal(y1, y2):
                raise AssertionError(f"{label} {name}: two runs of the "
                                     f"one-launch kernel on one input "
                                     f"differ")
            for what, yp in refs.items():
                err = float((y1 - yp).abs().max())
                rel = err / max(float(yp.abs().max()), 1e-30)
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
                rows.append({"slab": label, "dtype": name, "against": what,
                             "max_abs_err": err, "rel_err": rel})
                if not rel <= TOL_KERNEL:
                    raise AssertionError(
                        f"{label} {name}: one-launch kernel against the "
                        f"{what}: {rel:.3e} > {TOL_KERNEL}")
        p = sop.plan
        print(f"[9] one launch vs twins {label:6s} {sop.n_rows}x"
              f"{sop.n_cols}: {p.items.shape[0]} items "
              f"({p.splits.shape[0]} cut blocks, {p.n_slots} scratch rows) "
              f"over {len(sop.buckets)} buckets; bitwise repeatable; worst "
              f"so far {worst_rel:.3e}")
    if not slabs:
        raise AssertionError("no MXU form to check the one-launch kernel on")
    print(f"[9] one-launch kernel ok on {len(slabs)} MXU forms, f32 and "
          f"bf16 m, worst {worst_rel:.3e} <= {TOL_KERNEL}")
    return {"forms": rows, "worst_rel": worst_rel, "worst_abs": worst_abs}


def phase_fcg_order(torch, cfg, hm):
    """Why the bf16-preconditioned flexible CG's count on the card may
    differ from the CPU copy's: the same solve on the card with every
    transposed-tile matvec (the V-cycle's and CG's own) through the
    kernel, through the plain walk of the same work table (the same
    items and combination order; inside an item the library's order) and
    through the per-bucket twins (whole blocks, concatenated and
    un-permuted); for each the count to 1e-8 and the residual reached
    after 10 iterations.  Counts that differ between these show that the
    order of summation alone moves the count."""
    import dataclasses
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops import mxu_cuda, slab
    from gravomg_tpu_torch.ops.blockdense import pad_x

    def twins(op, x):
        xp = pad_x(op.buckets[0], x)
        ycat = torch.cat([mxu_cuda.mxu_matvec_plain(b, x, xp).reshape(-1, 128)
                          for b in op.buckets])
        return ycat[op.inv_block_perm].reshape(-1)[:op.n_rows]

    b = torch.as_tensor(np.random.default_rng(0).normal(size=N_MXU)
                        .astype(np.float32), device="cuda")
    h16 = gt.cast_fast_operators(hm, torch.bfloat16)
    cfg10 = dataclasses.replace(cfg, max_cycles=10)
    out = {}
    inner = slab.mxu_slab_matvec_fast
    try:
        for name, fn in (("kernel", inner),
                         ("plain walk", mxu_cuda.mxu_slab_matvec_plain),
                         ("per-bucket twins", twins)):
            slab.mxu_slab_matvec_fast = fn
            _, rel, it = gt.mg_fcg(h16, b, cfg, h_outer=hm)
            _, rel10, it10 = gt.mg_fcg(h16, b, cfg10, h_outer=hm)
            out[name] = {"iters": it, "rel": rel, "rel_after_10": rel10,
                         "iters_capped": it10}
            print(f"[9] bf16 FCG on the card, matvecs through the {name}: "
                  f"{it} iterations to {rel:.3e}; after {it10} iterations "
                  f"{rel10:.3e}")
    finally:
        slab.mxu_slab_matvec_fast = inner
    return out


def phase_mxu_timing(torch, hm, a0_vpu):
    """Per level and slot, the one-launch kernel per matvec (x's padding
    included) against its bound, the per-bucket twins and the library's
    bmm (``probes/mxu_levels.py::measure_form``); then level-0 A in the
    8-row slab form through the block-window kernel; f32 and bf16 m."""
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matvec_cuda
    from gravomg_tpu_torch.probes.mxu_levels import measure_form
    from gravomg_tpu_torch.probes.timing import bucket_loop, cuda_ms
    res = {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, sop in _slabs(hm, mxu=True):
        x = torch.randn(sop.n_cols, device="cuda", generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            name = _dtype_name(dt)
            r = res[f"{label} {name}"] = measure_form(sop, x, dt)
            by = r["bytes"]
            print(f"[9] {label:4s} {name:8s} {r['items']} items read "
                  f"{by['tiles']} B of m's {r['m_bytes']} (in and out "
                  f"{r['io_bytes']} B, scratch {by['scratch']} B): one "
                  f"launch {r['kernel_ms'][0]:.3f}/{r['kernel_ms'][1]:.3f} ms"
                  f" ({r['kernel_GBps']:.0f} GB/s of m read); kernels alone "
                  f"{_fmt(r['kernel_alone_ms'])} ms ("
                  f"{_fmt(r['alone_GBps'], 0)} GB/s); bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}), share "
                  f"{r['share_of_bound']:.2f} (alone "
                  f"{_fmt(r['alone_share_of_bound'], 2)}); twins "
                  f"{r['plain_ms'][0]:.3f}/{r['plain_ms'][1]:.3f} ms; library "
                  + ("none" if r["library_ms"] is None
                     else f"{r['library_ms']:.3f} ms"))
    x = torch.randn(a0_vpu.n_cols, device="cuda", generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        vs = [_bucket_on(b, dt) for b in a0_vpu.buckets]
        v1 = cuda_ms(bucket_loop(blockdense_matvec_cuda, vs, x))
        v2 = cuda_ms(bucket_loop(blockdense_matvec_cuda, vs, x))
        name = _dtype_name(dt)
        vb = sum(b.m.numel() * b.m.element_size() for b in vs)
        res[f"vpu {name}"] = {"vpu_ms": [v1, v2], "vpu_m_bytes": vb,
                              "vpu_GBps": vb / (min(v1, v2) * 1e-3) / 1e9}
        print(f"[9] level-0 A {name}: 8-row slab form ({len(vs)} buckets, m "
              f"{vb / 1e9:.3f} GB) block-window kernel {v1:.3f}/{v2:.3f} ms "
              f"({res[f'vpu {name}']['vpu_GBps']:.0f} GB/s)")
    return res


def phase_gather():
    from gravomg_tpu_torch.probes import gather
    out = {"launches": 0}
    for v in (200_000, 1_000_000):
        launches, res = gather.measure(v)
        print(f"[10] V={v}: gather kernel launches in the probe runs: "
              f"{launches}")
        if launches <= 0:
            raise AssertionError("the probes never launched the gather "
                                 "kernel")
        out["launches"] += launches
        for name, r in res.items():
            print(f"[10] {name} V={v}: kernel {r['ms']:.3f} ms "
                  f"({r['GBps']:.0f} GB/s of lidx+w; kernel alone "
                  f"{_fmt(r['kernel_alone_ms'])} ms), bound "
                  f"{r['bound_ms']:.3f} ms ({r['bound_by']}), share "
                  f"{r['share_of_bound']:.2f} (alone "
                  f"{_fmt(r['alone_share_of_bound'], 2)}); twin "
                  f"{r['plain_ms']:.3f} ms; library none; max|d|/max|y| {r['rel_err']:.3e}; bitwise "
                  f"repeatable")
            out[f"{name}_{v}"] = r
    return out


def phase_build_check(graph, op, cfg):
    """``build_hierarchy`` on the card against the C++ coarsener at
    200k, f64 and f32 (probes/build_check.py raises on a mismatch)."""
    from gravomg_tpu_torch.probes.build_check import check_build
    out = check_build(graph, op, cfg)
    for name, rec in out.items():
        host = (f", C++ coarsener {rec['host_build_s']:.3f} s, levels "
                f"{rec['host_levels']}" if "host_build_s" in rec else "")
        print(f"[11] {name}: build_hierarchy on the card "
              f"{rec['build_s']:.3f} s, levels {rec['levels']}{host}")
        for st, cmp_ in zip(rec["stats"], rec["compare"]):
            cases = (f"cases hit/edge/point {st['triangle_hits']}/"
                     f"{st['edge_fallbacks']}/{st['point_fallbacks']}")
            if cmp_["samples_differ"]:
                print(f"[11]   {st['n_fine']} -> {st['n_coarse']} (C++ "
                      f"{cmp_['host_n_coarse']}): {cmp_['samples_differ']} "
                      f"samples differ, the first with margin "
                      f"{cmp_['first_margin']:.3e} to the radius; {cases}")
                continue
            print(f"[11]   {st['n_fine']} -> {st['n_coarse']}: samples "
                  f"equal; parents differ {cmp_['parents_differ']} (not "
                  f"ties {cmp_['parents_not_ties']}); adjacency rows differ "
                  f"{cmp_['adjacency_rows_differ']}; coarse points moved "
                  f"{cmp_['coarse_points_moved']}; U rows max|dw| "
                  f"{cmp_['u_max_err']:.3e}, flipped "
                  f"{cmp_['u_rows_flipped']}, beyond tolerance "
                  f"{cmp_['u_rows_beyond']}; {cases}")
    return out


def phase_solve_loops(torch, cfg, hm):
    """``fmg``, ``solve_with_history`` and ``solve_refined`` once each
    on the 200k hierarchy."""
    import dataclasses
    import numpy as np
    from gravomg_tpu_torch.solve.vcycle import (fmg, level_matvec,
                                                solve_refined,
                                                solve_with_history)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=N_MXU)
                        .astype(np.float32), device="cuda")
    x = fmg(hm, b, cfg)
    rel_fmg = float((b - level_matvec(hm.levels[0], x)).norm() / b.norm())
    cfg30 = dataclasses.replace(cfg, max_cycles=30)
    _, rel_h, it_h, hist = solve_with_history(hm, b, cfg30)
    hist = hist.tolist()
    t0 = time.perf_counter()
    x64, rel_r, it_r = solve_refined(hm, b, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[12] fmg: rel residual {rel_fmg:.3e} after one pass; "
          f"solve_with_history: {it_h} cycles to {rel_h:.3e}, first five "
          f"{[f'{v:.2e}' for v in hist[:5]]}; solve_refined: {it_r} outer "
          f"iterations to {rel_r:.3e}, {wall:.3f} s")
    ok = (rel_fmg < 0.5 and abs(hist[it_h - 1] - rel_h) <= 1e-6 * rel_h
          and rel_h < hist[0]
          and rel_r <= 1e-8 and x64.dtype == torch.float64
          and bool(torch.isfinite(x64).all()))
    if not ok:
        raise AssertionError("a solve loop failed at 200k")
    return {"fmg_rel": rel_fmg, "history": hist[:it_h],
            "refined": {"iters": it_r, "rel": rel_r, "wall_s": wall}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import gravomg_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gravomg_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report = {"env": phase_environment(torch), "build": phase_build()}
    cfg, h, h_greedy, report["setup"] = phase_setup(torch)
    report["kernel_check"] = phase_kernel_check(torch, h)
    report["fixture"] = phase_fixture(torch)
    report["main"] = phase_main(torch, cfg, h, h_greedy)
    del h_greedy
    report["timing"] = phase_timing(torch, h)
    report["profile"] = phase_profile(torch, cfg, h,
                                      report["main"]["vcycle_ms"])
    report["windows_1m"] = phase_window_finding(h)
    del h
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    from gravomg_tpu_torch.ops.mxu_cuda import (bucket_plan, mxu_matvec_cuda,
                                                mxu_matvec_plain)
    cfg, hm, a0_vpu, report["mxu_setup"], graph, op = phase_mxu_setup(torch)
    report["mxu_check"] = _check_buckets(
        torch, _slabs(hm, mxu=True),
        lambda b, x, xp: mxu_matvec_cuda(b, x, xp, bucket_plan(b)),
        mxu_matvec_plain, "9", "transposed-tile kernel")
    report["mxu_slab_check"] = phase_mxu_slab_check(torch, hm)
    report["mxu_main"] = phase_mxu_main(torch, cfg, hm, "cuda", {})
    report["mxu_timing"] = phase_mxu_timing(torch, hm, a0_vpu)
    peak = torch.cuda.max_memory_allocated()
    report["mxu_peak_bytes"] = peak
    print(f"[9] peak device memory of the mxu phase: {peak} bytes "
          f"(torch.cuda.max_memory_allocated)")
    del a0_vpu
    report["fcg_order"] = phase_fcg_order(torch, cfg, hm)
    report["gather"] = phase_gather()
    report["build_check"] = phase_build_check(graph, op, cfg)
    del graph, op
    report["solve_loops"] = phase_solve_loops(torch, cfg, hm)
    # The CPU copy's solves come last: after half a minute of them
    # torch.profiler reports no device kernel any more in this process,
    # and the timing phases read the kernels' own times from it.
    phase_mxu_main(torch, cfg, hm, "cpu", report["mxu_main"])
    phase_mxu_compare(report["mxu_main"])
    del hm

    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    f32 = report["timing"]["float32"]
    m32 = report["mxu_timing"]["L0 A float32"]
    g1m = report["gather"]["P1_1000000"]
    kernels = {"kernels": [{
        "name": "blockdense_matvec",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/blockdense_matvec.cu",
        "replaces": "gravomg_tpu/ops/pallas_blockdense.py:64",
        "launches": report["main"]["launches"],
        "max_abs_err": report["kernel_check"]["worst_abs"],
        "ms": min(f32["kernel_ms"]),
        "plain_ms": min(f32["plain_ms"]),
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }, {
        "name": "mxu_matvec",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/mxu_matvec.cu",
        "replaces": "gravomg_tpu/ops/pallas_blockdense.py:188",
        "launches": report["mxu_main"]["launches"],
        "max_abs_err": max(report["mxu_check"]["worst_abs"],
                           report["mxu_slab_check"]["worst_abs"]),
        "ms": min(m32["kernel_ms"]),
        "plain_ms": min(m32["plain_ms"]),
        "bound_ms": m32["bound_ms"],
        "bound_by": m32["bound_by"],
        "library_ms": m32["library_ms"],
    }, {
        "name": "window_gather",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/window_gather.cu",
        "replaces": "scripts/profile_pltake.py:69; "
                    "scripts/profile_gather2.py:82",
        "launches": report["gather"]["launches"],
        "max_abs_err": max(r["max_abs_err"]
                           for k, r in report["gather"].items()
                           if k != "launches"),
        "ms": g1m["ms"],
        "plain_ms": g1m["plain_ms"],
        "bound_ms": g1m["bound_ms"],
        "bound_by": g1m["bound_by"],
        # No single PyTorch call computes it: the twin is a gather, a
        # product and a sum.
        "library_ms": None,
    }]}
    print(f"[done] {report['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
