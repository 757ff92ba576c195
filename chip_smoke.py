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
     csrc-coarsened hierarchy (coarse_threshold=1000, Chebyshev) and its
     slab forms; then the kernel against its plain twin on every bucket
     of every slab form (A, U and U^T of each level), f32 and bf16 m,
     at 1e-6 * max|y|;
  4. fixture parity: assets/halo_hierarchy.npz on the card against the
     same fixture on the CPU (one V-cycle, and MG-PCG iterations);
  5. the main path at 1M: V-cycle time (CUDA events, median), MG-PCG
     and mg_solve (bf16-preconditioned flexible CG at this size) to
     1e-8, with the kernel's launch count over this phase; fails if a
     level of at least 4096 rows lacks a slab form;
  6. timing: the kernel against its twin, per level-0 A matvec;
  7. profile: torch.profiler over one 1M V-cycle (device busy share, top
     device kernels), the level-0 A matvec as slab against the plain
     ELL gather, and the kernel's time per level-0 bucket;
  8. the 1M level-0 A's window counts at 128-row blocks: the blocks that
     need more than 24 windows keep the transposed-tile (mxu) form off
     the 1M fine level, so its path runs at 200k;
  9. the mxu path at n = 200,000 (the same recipe):
     ``attach_fast_operators(attach_slab_operators(h, mxu=True))``; each
     slot's form (MXU, uniform or ELL), its window count and m bytes,
     failing if a slab slot of at most 24 windows lacks its MXU form;
     the transposed-tile kernel against its twin on every bucket of
     every MXU form, f32 and bf16 m, at 1e-6 * max|y|; the V-cycle,
     MG-PCG and bf16-preconditioned flexible CG to 1e-8 on the card,
     the same solves on a CPU copy of the hierarchy (iteration counts
     within 1, the bf16 solve's within 3: see phase_mxu_main), the
     level-0 A matvec through the kernel, its twin and
     the 8-row slab form (block-window kernel), and peak device memory;
 10. the gather probes (``gravomg_tpu_torch/probes/gather.py``) at
     V = 200,000 and 1,000,000: their kernel against its twin at
     1e-6 * max|y|, times and GB/s.

The line before the last is a JSON object describing the three kernels;
the last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the package beside this script, it exits nonzero and prints
no result.  Longer results go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import statistics
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
    """The bench's recipe at ``n`` points on the card: Morton-ordered
    torus, grid kNN, screened Poisson, the csrc-coarsened hierarchy (no
    fast forms yet)."""
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.geometry.meshes import torus_points
    from gravomg_tpu_torch.geometry.order import morton_order

    t0 = time.perf_counter()
    pts = torus_points(n, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph = gt.grid_knn_graph_nosync(pts, 16, margin=2.4, device="cuda")
    op, _ = gt.screened_poisson_operator(graph, alpha="auto")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cfg = gt.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")
    h = gt.build_hierarchy_host(graph, op, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    sizes = [lvl.op.num_vertices for lvl in h.levels]
    print(f"[{tag}] setup n={n}: graph+operator {t1 - t0:.1f} s, hierarchy "
          f"{t2 - t1:.1f} s; levels {sizes}")
    return cfg, h, {"front_s": t1 - t0, "hierarchy_s": t2 - t1,
                    "levels": sizes}


def phase_setup(torch):
    import gravomg_tpu_torch as gt
    cfg, h, info = build_problem(torch, N, "3")
    t0 = time.perf_counter()
    h = gt.attach_slab_operators(h)
    torch.cuda.synchronize()
    info["slab_s"] = time.perf_counter() - t0
    print(f"[3] slab forms {info['slab_s']:.1f} s")
    return cfg, h, info


def _bucket_on(b, dtype):
    return b._replace(m=b.m.to(dtype).contiguous())


def _slabs(h, mxu=False):
    """(label, slab operator) for every slab form of the hierarchy (the
    transposed-tile ones if ``mxu``)."""
    from gravomg_tpu_torch.ops.slab import SlabOperator
    return [(f"L{li} {label}", getattr(lvl, field))
            for li, lvl in enumerate(h.levels) for field, label in FIELDS
            if isinstance(getattr(lvl, field), SlabOperator)
            and getattr(lvl, field).mxu == mxu]


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
            name = str(dt).split(".")[-1]
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


def _cuda_ms(torch, fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_main(torch, cfg, h):
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matvec_cuda
    b = torch.as_tensor(np.random.default_rng(0).normal(size=N)
                        .astype(np.float32), device="cuda")
    blockdense_matvec_cuda.launches = 0
    vc_ms = _cuda_ms(torch, lambda: gt.v_cycle(h, torch.zeros_like(b), b,
                                               cfg))
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
    return out


def _bucket_loop(fn, buckets, x):
    """One slab matvec's bucket calls of ``fn``, x padded once per
    matvec as slab_matvec pads it."""
    from gravomg_tpu_torch.ops.blockdense import pad_x

    def run():
        xp = pad_x(buckets[0], x)
        for b in buckets:
            fn(b, x, xp)
    return run


def phase_timing(torch, h):
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain)
    a0 = h.levels[0].banded
    x = torch.randn(a0.n_cols, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        bs = [_bucket_on(b, dt) for b in a0.buckets]
        kern = _bucket_loop(blockdense_matvec_cuda, bs, x)
        plain = _bucket_loop(blockdense_matvec_plain, bs, x)
        # plain, kernel, kernel, plain: compare within one call.
        p1 = _cuda_ms(torch, plain)
        k1 = _cuda_ms(torch, kern)
        k2 = _cuda_ms(torch, kern)
        p2 = _cuda_ms(torch, plain)
        name = str(dt).split(".")[-1]
        mbytes = sum(b.m.numel() * b.m.element_size() for b in bs)
        k_ms, p_ms = min(k1, k2), min(p1, p2)
        res[name] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                     "m_bytes": mbytes,
                     "kernel_GBps": mbytes / (k_ms * 1e-3) / 1e9}
        print(f"[6] level-0 A ({len(bs)} buckets, m {mbytes / 1e9:.3f} GB "
              f"{name}): kernel {k1:.3f}/{k2:.3f} ms, twin {p1:.3f}/"
              f"{p2:.3f} ms per matvec ({res[name]['kernel_GBps']:.0f} GB/s "
              f"of m through the kernel, escape and diag included)")
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
    from torch.profiler import ProfilerActivity, profile
    b = torch.randn(N, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    out = _profile_vcycle(torch, cfg, h, b, vcycle_ms, "7")
    lvl0 = h.levels[0]
    x = torch.randn(N, device="cuda")
    ell_ms = out["ell_spmv_ms"] = _cuda_ms(torch,
                                           lambda: gt.spmv(lvl0.op, x))
    hb = gt.cast_fast_operators(h, torch.bfloat16)
    for name, lvl in (("float32", lvl0), ("bfloat16", hb.levels[0])):
        slab_ms = _cuda_ms(torch, lambda: gt.level_matvec(lvl, x))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            gt.level_matvec(lvl, x)
            torch.cuda.synchronize()
        # Each bucket's kernel alone, in launch (= bucket) order.
        kev = sorted((e for e in prof.events()
                      if "blockdense_matvec_kernel" in e.name),
                     key=lambda e: e.time_range.start)
        k1_ms = sum(e.time_range.elapsed_us() for e in kev) / 1e3
        print(f"[7] level-0 A matvec, {name} m: slab {slab_ms:.3f} ms (K1 "
              f"kernels alone {k1_ms:.3f} ms), plain ELL gather (f32) "
              f"{ell_ms:.3f} ms")
        per_bucket = []
        if len(kev) == len(lvl.banded.buckets):
            for b, e in zip(lvl.banded.buckets, kev):
                us = e.time_range.elapsed_us()
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
    cfg, h, info = build_problem(torch, N_MXU, "9")
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
            op = getattr(lvl, field)
            mx = int(_window_counts(lvl, field).max())
            kind = _fast_kind(op)
            rows.append({"slot": f"L{li} {label}", "form": kind,
                         "max_windows": mx, "m_bytes": _m_bytes(op),
                         "slab_slot": (li, field) in slots})
            print(f"[9] L{li} {label:3s} form {kind:7s} max windows at "
                  f"128-row blocks {mx:2d}, m bytes {_m_bytes(op)}"
                  + ("" if (li, field) in slots else " (below 4096 rows)"))
            if (li, field) in slots and mx <= NW_MAX and kind != "MXU":
                bad.append(f"L{li} {label}")
    print(f"[9] attach {info['attach_s']:.1f} s; uniform forms run plain "
          f"torch, as the JAX package runs them through XLA")
    if bad:
        raise AssertionError(f"slab slots of at most {NW_MAX} windows "
                             f"without their MXU form: {bad}")
    info["slots"] = rows
    return cfg, hm, a0_vpu, info


def _to_device(torch, obj, dev):
    """A copy of a hierarchy (nested named tuples and tuples of tensors)
    on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        items = [_to_device(torch, v, dev) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


def phase_mxu_main(torch, cfg, hm):
    """The mxu path: V-cycle, MG-PCG and bf16-preconditioned flexible CG
    on the card (the kernel's launch count set to 0 just before, read
    just after), a profile of one V-cycle, then the same solves on a CPU
    copy."""
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.mxu_cuda import mxu_matvec_cuda
    b_np = np.random.default_rng(0).normal(size=N_MXU).astype(np.float32)
    solves = {
        "mg_pcg": lambda h, h16, b: gt.mg_pcg(h, b, cfg),
        "mg_fcg_bf16": lambda h, h16, b: gt.mg_fcg(h16, b, cfg, h_outer=h),
    }
    out = {}
    for dev in ("cuda", "cpu"):
        h = hm if dev == "cuda" else _to_device(torch, hm, "cpu")
        h16 = gt.cast_fast_operators(h, torch.bfloat16)
        b = torch.as_tensor(b_np, device=dev)
        if dev == "cuda":
            mxu_matvec_cuda.launches = 0
            out["vcycle_ms"] = _cuda_ms(
                torch, lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
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
            out["profile"] = _profile_vcycle(torch, cfg, h, b,
                                             out["vcycle_ms"], "9")
    # MG-PCG within 1.  The bf16 solve within 3: rounding x to bf16
    # makes its V-cycle discontinuous, so another summation order alone
    # moves its count by up to 2 (tests/test_torch_fast_operators.py).
    for name, bound in (("mg_pcg", 1), ("mg_fcg_bf16", 3)):
        ic, ih = out[f"{name}_cuda"]["iters"], out[f"{name}_cpu"]["iters"]
        print(f"[9] {name}: {ic} iterations on the card, {ih} on the CPU "
              f"(bound {bound})")
        if abs(ic - ih) > bound:
            raise AssertionError(f"{name}: {ic} iterations on the card, "
                                 f"{ih} on the CPU")
    return out


def phase_mxu_timing(torch, hm, a0_vpu):
    """Level-0 A per matvec: the transposed-tile kernel and its twin over
    the buckets (padding and escape included), and the 8-row slab form
    through the block-window kernel; f32 and bf16 m."""
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matvec_cuda
    from gravomg_tpu_torch.ops.mxu_cuda import (mxu_matvec_cuda,
                                                mxu_matvec_plain)
    a0 = hm.levels[0].banded
    x = torch.randn(a0.n_cols, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        bs = [_bucket_on(b, dt) for b in a0.buckets]
        vs = [_bucket_on(b, dt) for b in a0_vpu.buckets]
        # plain, kernel, kernel, plain, then the 8-row form twice.
        p1 = _cuda_ms(torch, _bucket_loop(mxu_matvec_plain, bs, x))
        k1 = _cuda_ms(torch, _bucket_loop(mxu_matvec_cuda, bs, x))
        k2 = _cuda_ms(torch, _bucket_loop(mxu_matvec_cuda, bs, x))
        p2 = _cuda_ms(torch, _bucket_loop(mxu_matvec_plain, bs, x))
        v1 = _cuda_ms(torch, _bucket_loop(blockdense_matvec_cuda, vs, x))
        v2 = _cuda_ms(torch, _bucket_loop(blockdense_matvec_cuda, vs, x))
        name = str(dt).split(".")[-1]
        mb = sum(b.m.numel() * b.m.element_size() for b in bs)
        vb = sum(b.m.numel() * b.m.element_size() for b in vs)
        res[name] = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
                     "vpu_ms": [v1, v2], "m_bytes": mb, "vpu_m_bytes": vb,
                     "kernel_GBps": mb / (min(k1, k2) * 1e-3) / 1e9,
                     "vpu_GBps": vb / (min(v1, v2) * 1e-3) / 1e9}
        print(f"[9] level-0 A {name}: transposed-tile form ({len(bs)} "
              f"buckets, m {mb / 1e9:.3f} GB) kernel {k1:.3f}/{k2:.3f} ms "
              f"({res[name]['kernel_GBps']:.0f} GB/s), twin {p1:.3f}/"
              f"{p2:.3f} ms; 8-row slab form ({len(vs)} buckets, m "
              f"{vb / 1e9:.3f} GB) block-window kernel {v1:.3f}/{v2:.3f} ms"
              f" ({res[name]['vpu_GBps']:.0f} GB/s)")
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
                  f"({r['GBps']:.0f} GB/s of lidx+w), twin "
                  f"{r['plain_ms']:.3f} ms, max|d|/max|y| {r['rel_err']:.3e}")
            out[f"{name}_{v}"] = r
    return out


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
    cfg, h, report["setup"] = phase_setup(torch)
    report["kernel_check"] = phase_kernel_check(torch, h)
    report["fixture"] = phase_fixture(torch)
    report["main"] = phase_main(torch, cfg, h)
    report["timing"] = phase_timing(torch, h)
    report["profile"] = phase_profile(torch, cfg, h,
                                      report["main"]["vcycle_ms"])
    report["windows_1m"] = phase_window_finding(h)
    del h
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    from gravomg_tpu_torch.ops.mxu_cuda import (mxu_matvec_cuda,
                                                mxu_matvec_plain)
    cfg, hm, a0_vpu, report["mxu_setup"] = phase_mxu_setup(torch)
    report["mxu_check"] = _check_buckets(
        torch, _slabs(hm, mxu=True), mxu_matvec_cuda, mxu_matvec_plain, "9",
        "transposed-tile kernel")
    report["mxu_main"] = phase_mxu_main(torch, cfg, hm)
    report["mxu_timing"] = phase_mxu_timing(torch, hm, a0_vpu)
    peak = torch.cuda.max_memory_allocated()
    report["mxu_peak_bytes"] = peak
    print(f"[9] peak device memory of the mxu phase: {peak} bytes "
          f"(torch.cuda.max_memory_allocated)")
    del hm, a0_vpu
    torch.cuda.empty_cache()
    report["gather"] = phase_gather()

    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    f32 = report["timing"]["float32"]
    m32 = report["mxu_timing"]["float32"]
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
    }, {
        "name": "mxu_matvec",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/mxu_matvec.cu",
        "replaces": "gravomg_tpu/ops/pallas_blockdense.py:188",
        "launches": report["mxu_main"]["launches"],
        "max_abs_err": report["mxu_check"]["worst_abs"],
        "ms": min(m32["kernel_ms"]),
        "plain_ms": min(m32["plain_ms"]),
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
    }]}
    print(f"[done] {report['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
