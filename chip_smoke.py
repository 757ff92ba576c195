#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and the
script exits nonzero:

  1. environment: torch, CUDA, the card's name and power limit, nvcc,
     g++ and triton versions;
  2. build: the block-window SpMV kernel (nvcc, sm_90a) and the C++
     coarsener (g++) from the sources in the checkout;
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
     ELL gather, and the kernel's time per level-0 bucket.

The line before the last is a JSON object describing the kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device, or
without the package beside this script, it exits nonzero and prints no
result.  Longer results go to chiprun_out/chip_smoke.json.
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
TOL_KERNEL = 1e-6          # max|kernel - twin| / max|twin|


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
    from gravomg_tpu_torch.ops.blockdense_cuda import _nvcc
    nvcc = _run([_nvcc(), "--version"]).splitlines()
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


def phase_build():
    from gravomg_tpu_torch.io import native
    from gravomg_tpu_torch.ops import blockdense_cuda
    t0 = time.perf_counter()
    blockdense_cuda.build_library(force=True)
    t1 = time.perf_counter()
    native.build_library(force=True)
    t2 = time.perf_counter()
    blockdense_cuda._load()
    print(f"[2] built kernel library in {t1 - t0:.2f} s (nvcc "
          f"{' '.join(blockdense_cuda.NVCC_FLAGS)}), coarsener in "
          f"{t2 - t1:.2f} s")
    return {"nvcc_s": t1 - t0, "gxx_s": t2 - t1}


def build_problem(torch, dev):
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.geometry.meshes import torus_points
    from gravomg_tpu_torch.geometry.order import morton_order

    t0 = time.perf_counter()
    pts = torus_points(N, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph = gt.grid_knn_graph_nosync(pts, 16, margin=2.4, device=dev)
    op, _ = gt.screened_poisson_operator(graph, alpha="auto")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cfg = gt.MultigridConfig(coarse_threshold=1000, smoother="chebyshev")
    h = gt.build_hierarchy_host(graph, op, cfg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    h = gt.attach_slab_operators(h)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    sizes = [lvl.op.num_vertices for lvl in h.levels]
    print(f"[3] setup n={N}: graph+operator {t1 - t0:.1f} s, hierarchy "
          f"{t2 - t1:.1f} s, slab forms {t3 - t2:.1f} s; levels {sizes}")
    return cfg, h, {"front_s": t1 - t0, "hierarchy_s": t2 - t1,
                    "slab_s": t3 - t2, "levels": sizes}


def _bucket_on(b, dtype):
    return b._replace(m=b.m.to(dtype).contiguous())


def _slabs(h):
    """(label, slab operator) for every slab form of the hierarchy."""
    names = (("banded", "A"), ("uw", "U"), ("utw", "U^T"))
    return [(f"L{li} {label}", getattr(lvl, field))
            for li, lvl in enumerate(h.levels) for field, label in names
            if getattr(lvl, field) is not None]


def phase_kernel_check(torch, h):
    """The kernel against its twin on every bucket of every slab form of
    the 1M hierarchy (A, U and U^T of each level), f32 and bf16 m."""
    from gravomg_tpu_torch.ops.blockdense import pad_x
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, shapes, worst_rel, worst_abs = [], set(), 0.0, 0.0
    slabs = _slabs(h)
    for label, sop in slabs:
        x = torch.randn(sop.n_cols, generator=gen, device="cuda")
        xp = pad_x(sop.buckets[0], x)
        worst, bad = {}, []
        for dt in (torch.float32, torch.bfloat16):
            name = str(dt).split(".")[-1]
            worst[name] = 0.0
            for b in sop.buckets:
                bb = _bucket_on(b, dt)
                yk = blockdense_matvec_cuda(bb, x, xp)
                yp = blockdense_matvec_plain(bb, x, xp)
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
        print(f"[3] kernel vs twin {label:6s} {sop.n_rows}x{sop.n_cols}, "
              f"caps {[b.nw for b in sop.buckets]}: max|d|/max|y| f32 "
              f"{worst['float32']:.3e}, bf16 {worst['bfloat16']:.3e}")
        if bad:
            raise AssertionError(f"kernel disagrees with its twin on "
                                 f"{label} beyond {TOL_KERNEL}: {bad}")
    print(f"[3] kernel vs twin ok on {len(slabs)} slab forms, "
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


def phase_timing(torch, h):
    from gravomg_tpu_torch.ops.blockdense import pad_x
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain)
    a0 = h.levels[0].banded
    x = torch.randn(a0.n_cols, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        bs = [_bucket_on(b, dt) for b in a0.buckets]

        # x is padded once per matvec, as slab_matvec does.
        def kern():
            xp = pad_x(bs[0], x)
            for b in bs:
                blockdense_matvec_cuda(b, x, xp)

        def plain():
            xp = pad_x(bs[0], x)
            for b in bs:
                blockdense_matvec_plain(b, x, xp)

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


def phase_profile(torch, cfg, h, vcycle_ms):
    """Where a 1M V-cycle's device time goes, and the level-0 A matvec
    as slab (kernel) against the plain ELL gather."""
    import gravomg_tpu_torch as gt
    from torch.profiler import ProfilerActivity, profile
    b = torch.randn(N, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
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
    print(f"[7] V-cycle device time {dev_ms:.3f} ms of {vcycle_ms:.3f} ms "
          f"(busy share {share:.2f}, idle {1 - share:.2f}); "
          f"{sum(e.count for e in evts)} device ops")
    for r in rows:
        print(f"[7]   {r['device_ms']:8.3f} ms {r['calls']:6d}x {r['name']}")
    lvl0 = h.levels[0]
    x = torch.randn(N, device="cuda")
    ell_ms = _cuda_ms(torch, lambda: gt.spmv(lvl0.op, x))
    out = {"vcycle_device_ms": dev_ms, "busy_share": share, "top": rows,
           "ell_spmv_ms": ell_ms}
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
    cfg, h, report["setup"] = build_problem(torch, "cuda")
    report["kernel_check"] = phase_kernel_check(torch, h)
    report["fixture"] = phase_fixture(torch)
    report["main"] = phase_main(torch, cfg, h)
    report["timing"] = phase_timing(torch, h)
    report["profile"] = phase_profile(torch, cfg, h,
                                      report["main"]["vcycle_ms"])
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    f32 = report["timing"]["float32"]
    kernels = {"kernels": [{
        "name": "blockdense_matvec",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/blockdense_matvec.cu",
        "replaces": "gravomg_tpu/ops/pallas_blockdense.py:64",
        "launches": report["main"]["launches"],
        "max_abs_err": report["kernel_check"]["worst_abs"],
        "ms": min(f32["kernel_ms"]),
        "plain_ms": min(f32["plain_ms"]),
    }]}
    print(f"[done] {report['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
