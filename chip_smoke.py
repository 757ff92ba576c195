#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 is the target).

    python3 chip_smoke.py

Phases, one printed line (or a few) each; any failure raises and the
script exits nonzero:

  1. environment: torch, CUDA, the card's name and power limit, nvcc,
     g++ and triton versions;
  2. build: the five kernel sources (nvcc, sm_90a, one process each) and
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
     (the C++ coarsener) for their seconds; the slab forms; then K1
     (the block-window kernel) in one launch on every whole 8-row slab
     form (A, U and U^T of each level) against its one-launch twin and
     against the per-bucket twin route, f32 and bf16 m, at 1e-6 * max|y|,
     twice on one input (bitwise equal);
  4. fixture parity: assets/halo_hierarchy.npz on the card against the
     same fixture on the CPU (one V-cycle, and MG-PCG iterations);
  5. the main path at 1M: V-cycle time (CUDA events, median), MG-PCG
     and mg_solve (bf16-preconditioned flexible CG at this size) to
     1e-8, with K1's launch count over this phase and over one counted
     V-cycle, where it must equal the cycle's slab matvecs; fails if a
     level of at least 4096 rows lacks a slab form; then the same two
     solves on the greedy hierarchy of the C++ coarsener (iteration
     counts within 2 of the main path's);
  6. timing of K1 on the level-0 A matvec, f32 and bf16 m: per call and
     alone, the one-launch twin, the per-bucket route, bound and share,
     the library's torch.bmm, and B1 on x as a (V, 1) matrix (a
     reference row);
  7. profile: torch.profiler over one 1M V-cycle (device busy share,
     device operations, top device kernels), the level-0 A matvec as
     slab (K1 alone) against the plain ELL gather;
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
     ``solve_with_history`` (30 cycles) and ``solve_refined`` (to 1e-8);
 13. the apps at 1M on phase 3's hierarchy and graph (run after phase
     8): ``heat_geodesics`` from vertex 0 (seconds of each refit,
     iterations, residual and seconds of both MG-PCG solves, each to
     1e-8, and K1's launches over the phase, which the refit's kept U
     and U^T forms make, equal to heat_geodesics' slab matvecs; phi
     finite, phi[0] = 0, the
     mean of phi over bins of distance from the source rising over the
     first half of the distance range), then one ``implicit_smooth`` step
     (a (V, 3) stationary solve: A on the ELL gather, U and U^T through
     the batched kernel B1, at most ``SMOOTH_MAX_CYCLES`` cycles; cycles,
     residual, seconds, B1's launches; finite);
 14. MG-preconditioned LOBPCG at 100k, the c6 recipe of
     scripts/bench_configs.py (torus seed 6, grid kNN k=12,
     coarse_threshold=800, Chebyshev, alpha = ``spectral_alpha``, the
     hierarchy built on the card) with the forms ``attach_operators``
     gives it, as the benchmark's torus100k.eigs cell sets it up:
     ``laplace_eigs`` k=12, 40 iterations, tol 1e-5, with iterations,
     seconds in all and per iteration (device block; Rayleigh-Ritz solve
     in f64 on the host, transfers included), lam_0, lam_1, lam_11,
     max_resnorm against the c6 target 1e-2, max|X^T M X - I| and the
     peak device memory of the eigensolve above what the process held
     before it; the values finite and ascending, max|X^T M X - I| <=
     1e-4, |lam_0| <= 1e-3 * lam_11; B1's launches in the call, counted
     from 0, equal to the cycle's (V, 12) slab matvecs; B1 against its
     twin on every slab form of that hierarchy at D=12 (per bucket and
     in one launch, f32 and bf16 m, bitwise repeatable), and B1 on its
     level-0 A at D=12, f32, timed as in phase 15 (b);
 15. many right-hand sides on one hierarchy, B1 (the batched
     block-window kernel, one launch a slab matvec): (b), run right
     after phase 13 on phase 3's 1M hierarchy, the share of nonzero
     (block, position) pairs of every 8-row slab form, one (V, 64)
     V-cycle against one 1-D cycle (times, B1's launches beside the
     number of slab matvecs, which must be equal, a profile), the (V, 64)
     and (V, 3) cycles against the same cycles on the ELL forms alone, B1
     against its twin on every slab form at D 3 and 64, f32 and bf16 m,
     per bucket and in one launch a form, at 1e-6 * max|Y| and bitwise
     repeatable, B1 on level-0 A in one launch (per call, alone, twin,
     the per-bucket route, library, bytes, multiply-adds on nonzero
     positions, bound and share, D 3 and 64); (a),
     after phase 14, the c5 recipe of scripts/bench_configs.py uncut
     (20,000 points, 64 right-hand sides): one (V, 64) V-cycle against
     the 64 1-D cycles of its columns, each column within 1e-5 of its
     largest entry, times, ms a right-hand side, B1's launches;
 16. a stacked mesh collection, the c5b recipe uncut: 64 tori of 5,000
     points, each hierarchy built on the card, ``attach_collection``,
     ``stack_solvers`` and ``batched_v_cycle`` (each mesh's real rows
     against its own cycle within 1e-5, its padded rows exactly 0; time
     against the per-mesh loop; padded and real row counts; peak device
     memory), ``batched_solve``'s shared count and largest residual.

 17. multi-device at 1M on phase 3's hierarchy (its ELL forms saved by
     ``save_solver`` for the ranks to load): (a) 4 gloo ranks on the one
     card (``parallel/launch.py::run_ranks``): each pads and shards the
     hierarchy and runs ``halo_solve`` and ``sharded_solve`` (MG-PCG,
     f32) on phase 3's b, one ``vertex_sharded_cg_step`` from x = 0, and
     ``batched_vcycle`` on 64 right-hand sides (a card generator seeded
     0, 16 a rank) on the unpadded hierarchy with slab forms (B1's
     launches counted per rank); the main process holds their rows
     against the unsharded solves: iterations within 1 of the unsharded
     ELL MG-PCG, each residual re-measured in f64 with the unsharded
     operator (at most twice the unsharded solution's: the f32 rounding
     floor, far above 1e-8, bounds both), the step against the same step
     unsharded, the 64 columns within 1e-6 of max|X| of the 1-D cycles;
     seconds of each solve and of the plans, peak device memory per
     rank.  Gloo moves every exchange through host memory: no number
     here measures a link between cards.  (b) One NCCL rank runs the
     same two solves (the unsharded iteration count).  (c) The halo
     plan at nd = 8 on the greedy hierarchy (the C++ coarsener's, whose
     levels are those of HALO_1M.json): S and halo_frac of every level's
     A, U and U^T beside the recorded ones, host seconds.
 18. the port's driver surfaces (``gravomg_tpu_torch/entry.py`` and
     ``bench.py``): (a) one ``entry()`` cycle on the card against
     ``entry(device="cpu")``'s at 1e-5 * max|x|, its time (CUDA
     events); (b) ``dryrun_multichip`` on one NCCL rank (device=None)
     and on 4 gloo ranks sharing the card: the batched cycle, the
     sharded ELL solve, the sharded uniform forms (each rank holding
     its row blocks of m) and the halo solve on the 24k fixture, each
     solve's iterations within 1 of the unsharded MG-PCG on its fixture,
     rel and seconds per rank, fine halo_frac below 0.25; then
     ``dryrun_multichip(2)`` with device=None on the one card, which must
     raise the RuntimeError before any rank starts; (c) ``python -m
     gravomg_tpu_torch.bench`` at 1M in a process of its own: its one
     stdout line and its stderr account printed, MG-PCG and mg_solve
     (bf16 FCG) within 1 iteration of phase 5's, K1's launches in one
     cycle equal to its slab matvecs (its record in
     chiprun_out/bench_1000000.json).
 19. the config sweep (``gravomg_tpu_torch/bench_configs.py``, the
     counterpart of scripts/bench_configs.py) for c1, c2 and c3 at the
     script's sizes: c1 (5,000 icosphere vertices, Jacobi, 2 levels)
     MG-PCG, c2 (35,000-point torus) 8 chained V-cycles and MG-PCG, c3
     (170,000-point torus) heat_geodesics; each row (build seconds,
     medians of 5 host-clock calls with CUDA-event times, busy share and
     launches per call, residuals, iterations, levels, peak memory)
     printed, K1's launches over the phase; c1's and c2's solves to 1e-8
     with K1 launched in them, c3's phi finite.  Phases 14, 15 (a) and
     16 take their recipes (points, seeds, config, right-hand sides) and
     pipeline from the same module, so no config runs twice.
 20. the uniform kernel U1 (``csrc/uniform_matvec.cu``), run right after
     phase 7 on phase 3's hierarchy with the uniform forms of
     ``attach_fast_operators`` (A, U and U^T of level 4 at 1M, as the
     bench and the benchmark run them): on each form, f32 and bf16 m, U1
     against the plain path ``blockdense_matvec`` (each row within 1e-5
     of its sum of absolute terms) and twice on one x (bitwise equal),
     its bytes, bound, times alone (L2 warm and flushed), per call and on
     the host, the plain path's and the library's (``torch.bmm`` on
     gathered windows, f32); then ``mg_solve`` with U1's launches counted
     from 0, equal to the cycle's 1-D uniform matvecs, and the same solve
     through the plain path (iterations within 1).

Phases 3 (K1's check), 5, 6, 13-17, 18 (a) and (b) and 19 are functions
of (torch, device, n, ...) that also run on the CPU at a small n
(tests/test_torch_smoke_k1.py, tests/test_torch_smoke_phases.py,
tests/test_torch_smoke_multidevice.py, tests/test_torch_smoke_entry.py,
tests/test_torch_smoke_configs.py), but for 15 (b), which needs phase
3's hierarchy on the card.

A kernel's bound is the least time the card could take: the bytes of its
inputs and outputs that it must move, each once, over the H100's
published 3.35 TB/s, or its multiply-adds (two operations each) over the
published 67 TFLOP/s of f32 outside the tensor cores, whichever is
larger (bytes for all five: B1's multiply-adds are counted on the
positions it multiplies, those where a block's 8 rows hold a nonzero;
K1's bytes are those of the blocks inv_block_perm names);
gravomg_tpu_torch/probes/timing.py computes it.  A share of the bound
above 1.05 means a count is wrong, and fails the run.

The line before the last is a JSON object describing the five kernels,
B1 in two rows (``case``: D=64 on the 1M level-0 A of phase 15 (b), and
D=12 on the 100k level-0 A of phase 14, where laplace_eigs runs it);
the last line is {"ok": true, "device": {...}}.  Without a CUDA device,
or without the package beside this script, it exits nonzero and prints
no result.  Longer results go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 1_000_000
N_MXU = 200_000            # the mxu path's size (phase 8 says why)
TOL_KERNEL = 1e-6          # max|kernel - twin| / max|twin|
N_LOBPCG = 100_000         # phase 14, the c6 recipe's size
# Phase 13's implicit_smooth: f32 stationary cycles end near the f32
# floor of M + tL's residual, eps |tL| |x| / |b|, which grows like 1/h
# and lies far above 1e-8 at 1M; the default 200 cycles would all run.
SMOOTH_MAX_CYCLES = 20
FIELDS = (("banded", "A"), ("uw", "U"), ("utw", "U^T"))
C5_N, C5_D = 20_000, 64          # phase 15 (a), the c5 recipe
C5B_MESHES, C5B_N = 64, 5_000    # phase 16, the c5b recipe
MD_RANKS = 4                     # phase 17: gloo ranks on the one card
TOL_COLUMNS = 1e-5               # a batched cycle against its own cycles
MAX_SHARE = 1.05                 # above it a bound's count is wrong
# Phase 17: a sharded f32 solve's residual re-measured in f64 with the
# unsharded operator, at most this times the unsharded solve's.
TRUE_RES_FACTOR = 2.0


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
    from gravomg_tpu_torch.ops import (blockdense_cuda, mxu_cuda,
                                       uniform_cuda, window_gather)
    return {"blockdense_matvec": blockdense_cuda.LIBRARY,
            "blockdense_matmat": blockdense_cuda.MATMAT_LIBRARY,
            "mxu_matvec": mxu_cuda.LIBRARY,
            "uniform_matvec": uniform_cuda.LIBRARY,
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
    return cfg, h, h_greedy, info, graph


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


def slab_min_rows(n: int) -> int:
    """Rows a level needs for its slab forms: the JAX package's 4096 at
    the card's sizes, a quarter of ``n`` below 16,384 points (so that a
    small run on the CPU still has one)."""
    return min(4096, n // 4)


def k1_problem(torch, device, n):
    """The bench recipe at ``n`` points on ``device`` for phases 3, 5 and
    6 when phase 3's set-up did not run (the CPU test): the hierarchy of
    ``build_hierarchy_device`` with its 8-row slab forms, and the greedy
    one of ``build_hierarchy_host``.  Returns (config, hierarchy, greedy
    hierarchy)."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
    cfg, h, _, graph, op = bench_hierarchy(n, device)
    h_greedy = gt.build_hierarchy_host(graph, op, cfg)
    return (cfg, gt.attach_slab_operators(h, min_rows=slab_min_rows(n)),
            h_greedy)


def _per_bucket_route(torch, sop, x, bucket_fn):
    """The route a 1-D x took before one launch: ``bucket_fn`` (K1 over
    one bucket, or its twin) per bucket, x padded once, the buckets laid
    end to end, un-permuted by inv_block_perm, plus the diagonal."""
    from gravomg_tpu_torch.ops.blockdense import pad_x
    xp = pad_x(sop.buckets[0], x)
    y = torch.cat([bucket_fn(b, x, xp).reshape(-1, 8) for b in sop.buckets])
    y = y[sop.inv_block_perm.long()].reshape(-1)[:sop.n_rows]
    return y if sop.diag is None else y + sop.diag * x


def phase_kernel_check(torch, device, n, h=None):
    """Phase 3's check: K1 in one launch on every whole 8-row slab form
    of ``h`` (A, U and U^T of each slab slot; built here at ``n`` points
    when None) against the one-launch twin and the per-bucket twin route,
    f32 and bf16 m, at ``TOL_KERNEL``, twice on one input (on the card
    the two y bitwise equal, one launch each).  On the CPU the dispatch
    takes the twin, which then meets the per-bucket route."""
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain, slab_matvec_1d_fast,
        slab_matvec_plain)
    from gravomg_tpu_torch.utils.profiling import synchronize
    if h is None:
        h = k1_problem(torch, device, n)[1]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    slabs = _slabs(h)
    if not slabs:
        raise AssertionError("no 8-row slab form to check K1 on")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst_rel, worst_abs = [], 0.0, 0.0
    for label, sop in slabs:
        x = torch.randn(sop.n_cols, generator=gen, device=dev)
        worst = {}
        for dt in (torch.float32, torch.bfloat16):
            name = _dtype_name(dt)
            sd = _slab_on(sop, dt)
            before = blockdense_matvec_cuda.launches
            y1 = slab_matvec_1d_fast(sd, x)
            y2 = slab_matvec_1d_fast(sd, x)
            synchronize(dev)
            if on_card and blockdense_matvec_cuda.launches != before + 2:
                raise AssertionError(f"K1 on {label}: not one launch a "
                                     f"matvec")
            if not torch.equal(y1, y2):
                raise AssertionError(f"K1 on {label} {name}: two runs on "
                                     f"one input differ")
            refs = {"one-launch twin": slab_matvec_plain(sd, x),
                    "per-bucket twins": _per_bucket_route(
                        torch, sd, x, blockdense_matvec_plain)}
            worst[name] = 0.0
            for what, yp in refs.items():
                err = float((y1 - yp).abs().max())
                rel = err / max(float(yp.abs().max()), 1e-30)
                worst[name] = max(worst[name], rel)
                worst_rel, worst_abs = max(worst_rel, rel), max(worst_abs, err)
                rows.append({"slab": label, "dtype": name, "against": what,
                             "max_abs_err": err, "rel_err": rel})
                if not rel <= TOL_KERNEL:
                    raise AssertionError(
                        f"K1 on {label} {name} against the {what}: "
                        f"{rel:.3e} > {TOL_KERNEL}")
        print(f"[3] K1 one launch vs twins {label:6s} {sop.n_rows}x"
              f"{sop.n_cols}, caps {[b.nw for b in sop.buckets]}: "
              f"max|d|/max|y| f32 {worst['float32']:.3e}, bf16 "
              f"{worst['bfloat16']:.3e}"
              + ("; bitwise repeatable" if on_card else ""))
    print(f"[3] K1 ok on {len(slabs)} slab forms in one launch each, f32 "
          f"and bf16 m, against the one-launch twin and the per-bucket "
          f"twins, worst {worst_rel:.3e} <= {TOL_KERNEL}")
    return {"forms": rows, "worst_rel": worst_rel, "worst_abs": worst_abs}


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
    """Bytes of m one slab matvec of ``op`` reads: through K1 the blocks
    inv_block_perm names; through the transposed-tile kernel the tiles
    its work table names (padding blocks are read by neither)."""
    from gravomg_tpu_torch.ops.mxu_cuda import plan_bytes
    from gravomg_tpu_torch.probes.timing import slab_m_read
    if not op.mxu:
        return slab_m_read(op)
    return plan_bytes(op.buckets, op.plan)["tiles"]


def _cycle_account(torch, cfg, h, b, wrapper, tag, what):
    """One V-cycle with every slab matvec counted: the matvecs, the
    launches of ``wrapper``'s kernel, the bytes of m they read and the
    bound those bytes set on the cycle's kernel time."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.probes.timing import HBM_BYTES_PER_S
    from gravomg_tpu_torch.solve import vcycle
    from gravomg_tpu_torch.utils.profiling import synchronize
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
        synchronize(b.device)
    finally:
        vcycle.slab_matvec = inner
    seen["launches"] = wrapper.launches - before
    seen["bound_ms"] = seen["m_bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"[{tag}] one V-cycle: {seen['matvecs']} slab matvecs, "
          f"{seen['launches']} launches of {what}, m bytes read "
          f"{seen['m_bytes']}, bound {seen['bound_ms']:.3f} ms (bytes of m "
          f"over {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    return seen


def phase_main(torch, device, n, problem=None):
    """Phase 5: the main path at ``n`` points on ``device``; ``problem``
    is (config, hierarchy with its slab forms, greedy hierarchy) of phase
    3, else :func:`k1_problem` builds it.  MG-PCG and ``mg_solve`` to
    1e-8, fails if a slab slot lacks its slab form, the same two solves
    on the greedy hierarchy (within 2 iterations).  On the card also the
    V-cycle's time; K1's launches over the cycle timing and the solves
    (set to 0 just before, read just after), which must be above 0; and
    over one counted V-cycle, which must equal its slab matvecs."""
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matvec_cuda
    from gravomg_tpu_torch.probes.timing import cuda_ms
    from gravomg_tpu_torch.solve.vcycle import slab_slots
    from gravomg_tpu_torch.utils.profiling import synchronize
    cfg, h, h_greedy = (k1_problem(torch, device, n) if problem is None
                        else problem)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    min_rows = slab_min_rows(n)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=n)
                        .astype(np.float32), device=dev)
    blockdense_matvec_cuda.launches = 0
    vc_ms = (cuda_ms(lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
             if on_card else None)
    out = {"n": n, "vcycle_ms": vc_ms}
    for name, solver in (("mg_pcg", gt.mg_pcg), ("mg_solve", gt.mg_solve)):
        synchronize(dev)
        t0 = time.perf_counter()
        x, rel, it = solver(h, b, cfg)
        synchronize(dev)
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
    out["cycle"] = cyc = _cycle_account(torch, cfg, h, b,
                                        blockdense_matvec_cuda, "5", "K1")
    slots = slab_slots(h, min_rows)
    missing = [s for s in slots if getattr(h.levels[s[0]], s[1]) is None]
    if missing:
        raise AssertionError(f"levels without their slab forms (the plain "
                             f"ELL gather would stand in for the kernel): "
                             f"{missing}")
    if not slots:
        raise AssertionError(f"no slab slot at {n} points")
    mb = [[None if s is None else s.m_bytes
           for s in (lvl.banded, lvl.uw, lvl.utw)] for lvl in h.levels]
    print(f"[5] V-cycle " + ("not measured" if vc_ms is None else
                             f"{vc_ms:.3f} ms (median of 10, CUDA events)")
          + f"; levels {[lvl.op.num_vertices for lvl in h.levels]}")
    print(f"[5] slab m bytes per level [A, U, U^T]: {mb}")
    print(f"[5] all {len(slots)} slab slots (A, U, U^T of levels >= "
          f"{min_rows} rows) hold slab forms; K1 launches in this phase's "
          f"cycle timing and solves: {launches}; in one V-cycle "
          f"{cyc['launches']} for {cyc['matvecs']} slab matvecs")
    if on_card and launches <= 0:
        raise AssertionError("the main path never launched K1")
    if on_card and cyc["launches"] != cyc["matvecs"]:
        raise AssertionError(f"K1 launched {cyc['launches']} times for "
                             f"{cyc['matvecs']} slab matvecs, not once each")
    out.update(launches=launches, m_bytes=mb)
    hg = gt.attach_slab_operators(h_greedy, min_rows=min_rows)
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


def phase_timing(torch, device, n, h=None):
    """Phase 6: K1 on level-0 A of ``h`` (built here at ``n`` points when
    None), f32 and bf16 m: its bound (``probes/timing.py::
    slab_matvec_bound``) and, on the card, one launch per call and alone,
    the one-launch twin, the per-bucket route (K1 over each bucket, the
    buckets laid end to end, un-permuted, plus the diagonal: the route
    before one launch), the library's ``torch.bmm`` per bucket (f32), and
    B1 on x as a (V, 1) matrix, per call and alone (a reference row).  On
    the CPU the bound and the twin against the per-bucket twins."""
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matvec_cuda, blockdense_matvec_plain, slab_matmat_cuda,
        slab_matvec_1d_fast, slab_matvec_cuda, slab_matvec_plain)
    from gravomg_tpu_torch.probes.timing import (cuda_ms, kernel_ms,
                                                 library_bmm, slab_m_read,
                                                 slab_matvec_bound)
    if h is None:
        h = k1_problem(torch, device, n)[1]
    dev = torch.device(device)
    a0 = h.levels[0].banded
    x = torch.randn(a0.n_cols, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        name = _dtype_name(dt)
        sd = _slab_on(a0, dt)
        bound_ms, bound_by, io_bytes = slab_matvec_bound(sd, x)
        mbytes = slab_m_read(sd)
        row = res[name] = {"m_bytes": mbytes, "io_bytes": io_bytes,
                           "bound_ms": bound_ms, "bound_by": bound_by}
        if dev.type != "cuda":
            y = slab_matvec_1d_fast(sd, x)
            yp = _per_bucket_route(torch, sd, x, blockdense_matvec_plain)
            row["twin_rel_err"] = float((y - yp).abs().max()
                                        / yp.abs().max())
            print(f"[6] level-0 A {name}: bound {bound_ms:.6f} ms "
                  f"({bound_by}, {io_bytes} bytes); twin vs per-bucket "
                  f"twins {row['twin_rel_err']:.3e}")
            continue
        kern = lambda: slab_matvec_cuda(sd, x)
        plain = lambda: slab_matvec_plain(sd, x)
        # plain, kernel, kernel, plain: compare within one call.
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kern)
        k2 = cuda_ms(kern)
        p2 = cuda_ms(plain)
        alone = kernel_ms(kern, "blockdense_matvec_kernel")
        per_bucket = cuda_ms(lambda: _per_bucket_route(
            torch, sd, x, blockdense_matvec_cuda))
        # No library call for bf16 m: torch.bmm in bf16 rounds its output.
        lib_ms = (cuda_ms(library_bmm(list(sd.buckets), x))
                  if dt == torch.float32 else None)
        x1 = x[:, None]
        b1_ms = cuda_ms(lambda: slab_matmat_cuda(sd, x1))
        b1_alone = kernel_ms(lambda: slab_matmat_cuda(sd, x1),
                             "blockdense_matmat_kernel")
        k_ms = min(k1, k2)
        row.update(kernel_ms=[k1, k2], plain_ms=[p1, p2], alone_ms=alone,
                   per_bucket_ms=per_bucket, library_ms=lib_ms,
                   b1_v1_ms=b1_ms, b1_v1_alone_ms=b1_alone,
                   share_of_bound=bound_ms / k_ms,
                   alone_share_of_bound=(None if alone is None
                                         else bound_ms / alone),
                   kernel_GBps=mbytes / (k_ms * 1e-3) / 1e9)
        print(f"[6] level-0 A ({len(sd.buckets)} buckets, m read "
              f"{mbytes / 1e9:.3f} GB {name}): K1 one launch per call "
              f"{k1:.3f}/{k2:.3f} ms, alone {_fmt(alone)} ms; twin "
              f"{p1:.3f}/{p2:.3f} ms; per-bucket route {per_bucket:.3f} "
              f"ms; bound {bound_ms:.3f} ms ({bound_by}, {io_bytes} bytes), "
              f"share {bound_ms / k_ms:.2f} (alone "
              f"{_fmt(row['alone_share_of_bound'], 2)}); library (one "
              f"torch.bmm per bucket, windows already gathered) "
              + ("none" if lib_ms is None else f"{lib_ms:.3f} ms")
              + f"; B1 on x as (V, 1): per call {b1_ms:.3f} ms, alone "
              f"{_fmt(b1_alone)} ms")
    return res


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile_vcycle(torch, cfg, h, b, vcycle_ms, tag):
    """torch.profiler over one V-cycle: device time, busy share against
    ``vcycle_ms``, device operations (kernels and copies) and the top
    device kernels."""
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
    ops = sum(e.count for e in evts)
    print(f"[{tag}] V-cycle device time {dev_ms:.3f} ms of {vcycle_ms:.3f} "
          f"ms (busy share {share:.2f}, idle {1 - share:.2f}); {ops} device "
          f"operations (kernels and copies) in the cycle")
    for r in rows:
        print(f"[{tag}]   {r['device_ms']:8.3f} ms {r['calls']:6d}x "
              f"{r['name']}")
    return {"vcycle_device_ms": dev_ms, "busy_share": share,
            "device_ops": ops, "top": rows}


def phase_profile(torch, cfg, h, vcycle_ms):
    """Phase 7: where a 1M V-cycle's device time goes (busy share, device
    operations, top kernels), and the level-0 A matvec as slab (K1) per
    call and K1 alone against the plain ELL gather."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.probes.timing import cuda_ms, kernel_ms
    b = torch.randn(N, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    out = _profile_vcycle(torch, cfg, h, b, vcycle_ms, "7")
    lvl0 = h.levels[0]
    x = torch.randn(N, device="cuda")
    ell_ms = out["ell_spmv_ms"] = cuda_ms(lambda: gt.spmv(lvl0.op, x))
    hb = gt.cast_fast_operators(h, torch.bfloat16)
    for name, lvl in (("float32", lvl0), ("bfloat16", hb.levels[0])):
        slab_ms = cuda_ms(lambda: gt.level_matvec(lvl, x))
        k1_ms = kernel_ms(lambda: gt.level_matvec(lvl, x),
                          "blockdense_matvec_kernel")
        print(f"[7] level-0 A matvec, {name} m: slab {slab_ms:.3f} ms (K1 "
              f"alone {_fmt(k1_ms)} ms), plain ELL gather (f32) "
              f"{ell_ms:.3f} ms")
        out[name] = {"slab_matvec_ms": slab_ms, "k1_kernel_ms": k1_ms}
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
    print(f"[9] attach {info['attach_s']:.1f} s; uniform forms run U1 "
          f"(csrc/uniform_matvec.cu) on a 1-D x, plain torch on a 2-D x")
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
                                      "9", "the transposed-tile kernel")
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
    8-row slab form through K1; f32 and bf16 m."""
    from gravomg_tpu_torch.ops.blockdense_cuda import slab_matvec_cuda
    from gravomg_tpu_torch.probes.mxu_levels import measure_form
    from gravomg_tpu_torch.probes.timing import cuda_ms, slab_m_read
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
        vs = _slab_on(a0_vpu, dt)
        v1 = cuda_ms(lambda: slab_matvec_cuda(vs, x))
        v2 = cuda_ms(lambda: slab_matvec_cuda(vs, x))
        name = _dtype_name(dt)
        vb = slab_m_read(vs)
        res[f"vpu {name}"] = {"vpu_ms": [v1, v2], "vpu_m_bytes": vb,
                              "vpu_GBps": vb / (min(v1, v2) * 1e-3) / 1e9}
        print(f"[9] level-0 A {name}: 8-row slab form ({len(vs.buckets)} "
              f"buckets, m read {vb / 1e9:.3f} GB) K1 in one launch "
              f"{v1:.3f}/{v2:.3f} ms "
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


def _rising_bins(phi, dist, bins: int = 16):
    """Mean of ``phi`` over each of the first half of ``bins`` bins of
    ``dist`` over [0, max] (numpy arrays; empty bins left out), and
    whether those means rise strictly."""
    import numpy as np
    idx = np.minimum((dist / dist.max() * bins).astype(np.int64), bins - 1)
    counts = np.bincount(idx, minlength=bins)[:bins // 2]
    sums = np.bincount(idx, weights=phi, minlength=bins)[:bins // 2]
    means = [float(v) for v in sums[counts > 0] / counts[counts > 0]]
    return means, all(b > a for a, b in zip(means, means[1:]))


def phase_apps(torch, device, n, problem=None):
    """Phase 13: ``heat_geodesics`` from vertex 0 and one
    ``implicit_smooth`` step on the bench recipe's hierarchy with slab
    forms at ``n`` points on ``device``; ``problem`` is (config, solver
    hierarchy, graph) of phase 3, else the recipe is built here.  On the
    card K1's launches over the phase, and B1's in the (V, 3) smoothing
    solve, must be above 0, and K1's over ``heat_geodesics`` must equal
    its slab matvecs."""
    import dataclasses
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matmat_cuda,
                                                       blockdense_matvec_cuda)
    from gravomg_tpu_torch.utils.profiling import synchronize
    dev = torch.device(device)
    if problem is None:
        from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
        cfg, h, _, graph, _ = bench_hierarchy(n, device)
        h = gt.attach_slab_operators(h)
    else:
        cfg, h, graph = problem
    out = {"n": graph.num_vertices}
    blockdense_matvec_cuda.launches = 0
    heat = out["heat"] = {}
    synchronize(dev)
    t0 = time.perf_counter()
    phi, heat["slab_matvecs"] = _count_slab_matvecs(
        torch, lambda: gt.heat_geodesics(graph, h, 0, cfg=cfg, record=heat),
        ndim=1)
    synchronize(dev)
    heat["total_s"] = time.perf_counter() - t0
    heat["k1_launches"] = blockdense_matvec_cuda.launches
    for name in ("heat", "poisson"):
        print(f"[13] heat_geodesics {name} step: refit "
              f"{heat[f'refit_{name}_s']:.3f} s, MG-PCG "
              f"{heat[f'{name}_iters']} iterations to "
              f"{heat[f'{name}_rel']:.3e} in {heat[f'{name}_s']:.3f} s")
    pts = graph.points.double()
    dist = torch.linalg.norm(pts - pts[0], dim=1).cpu().numpy()
    phi_np = phi.double().cpu().numpy()
    means, rising = _rising_bins(phi_np, dist)
    finite = bool(torch.isfinite(phi).all())
    heat.update(bin_means=means, rising=rising, finite=finite,
                phi0=float(phi_np[0]), phi_max=float(phi_np.max()))
    print(f"[13] heat_geodesics {heat['total_s']:.3f} s in all; K1 "
          f"launches {heat['k1_launches']} for {heat['slab_matvecs']} slab "
          f"matvecs; phi finite {finite}, "
          f"phi[0] {heat['phi0']}, max {heat['phi_max']:.4g}; mean phi over "
          f"the first 8 of 16 bins of distance from the source "
          f"{[round(m, 4) for m in means]}")
    if not (finite and heat["phi0"] == 0.0 and rising
            and heat["heat_rel"] <= 1e-8 and heat["poisson_rel"] <= 1e-8):
        raise AssertionError(f"heat_geodesics failed its checks: {heat}")

    smooth = out["smooth"] = {}
    scfg = dataclasses.replace(cfg, max_cycles=SMOOTH_MAX_CYCLES)
    blockdense_matmat_cuda.launches = 0
    t0 = time.perf_counter()
    new = gt.implicit_smooth(graph, h, steps=1, cfg=scfg, record=smooth)
    synchronize(dev)
    smooth["total_s"] = time.perf_counter() - t0
    smooth["b1_launches"] = blockdense_matmat_cuda.launches
    step = smooth["steps"][0]
    finite = bool(torch.isfinite(new).all()) and new.shape == pts.shape
    moved = float((new.double() - pts).norm(dim=1).mean())
    smooth.update(finite=finite, mean_move=moved)
    out["k1_launches"] = blockdense_matvec_cuda.launches
    print(f"[13] implicit_smooth, one step (a (V, 3) solve, at most "
          f"{SMOOTH_MAX_CYCLES} cycles): refit {smooth['refit_s']:.3f} s, "
          f"{step['cycles']} cycles to {step['rel']:.3e} in "
          f"{step['solve_s']:.3f} s; {smooth['total_s']:.3f} s in all; "
          f"finite {finite}, mean move {moved:.3e}; B1 launches (its U and "
          f"U^T transfers) {smooth['b1_launches']}")
    print(f"[13] K1 launches over the phase: {out['k1_launches']}")
    if not finite:
        raise AssertionError("implicit_smooth returned non-finite points")
    if dev.type == "cuda" and out["k1_launches"] <= 0:
        raise AssertionError("the apps never launched K1")
    if dev.type == "cuda" and heat["k1_launches"] != heat["slab_matvecs"]:
        raise AssertionError(f"heat_geodesics: K1 launched "
                             f"{heat['k1_launches']} times for "
                             f"{heat['slab_matvecs']} slab matvecs")
    if dev.type == "cuda" and smooth["b1_launches"] <= 0:
        raise AssertionError("implicit_smooth never launched B1")
    return out


def phase_lobpcg(torch, device, n):
    """Phase 14: ``laplace_eigs`` (k=12, 40 iterations, tol 1e-5) at
    ``n`` points on ``device``, the c6 recipe of
    scripts/bench_configs.py (``gravomg_tpu_torch/bench_configs.py``'s
    inputs and pipeline) on the hierarchy with ``attach_operators``'
    forms (slab forms from ``slab_min_rows(n)`` rows: the benchmark's
    4096 at 100k).  B1's launches in the call are counted from 0 and
    must equal the cycle's (V, k) slab matvecs on the card (0 off it),
    both counted where the Python wrapper runs (a step that replays the
    cycle as a CUDA graph passes through neither);
    on the card B1 is also held to its twin on every slab form at D=k
    and timed on level-0 A."""
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch import bench_configs as bc
    from gravomg_tpu_torch.apps.spectral import spectral_alpha
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matmat_cuda
    from gravomg_tpu_torch.solve.vcycle import attach_operators
    from gravomg_tpu_torch.utils.profiling import synchronize
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    k = bc.C6_K
    t0 = time.perf_counter()
    c6 = bc.c6_inputs(n)
    cfg = c6.cfg
    p = bc.pipeline(c6.points, c6.k, cfg, attach=False, alpha="spectral",
                    device=device)
    graph = p.graph
    h = attach_operators(p.h, slab_min_rows=slab_min_rows(n))
    lap, mass = gt.graph_laplacian(graph, "invdist")
    alpha = spectral_alpha(graph, lap_mass=(lap, mass))
    synchronize(dev)
    out = {"n": n, "k": k, "alpha": float(alpha),
           "setup_s": time.perf_counter() - t0,
           "levels": [lvl.op.num_vertices for lvl in h.levels]}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    rec = {}
    blockdense_matmat_cuda.launches = 0
    t0 = time.perf_counter()
    (lams, vecs, res), matvecs = _count_slab_matvecs(
        torch, lambda: gt.laplace_eigs(graph, k=k, cfg=cfg, h=h, iters=40,
                                       tol=1e-5, record=rec))
    synchronize(dev)
    total = time.perf_counter() - t0
    launches = blockdense_matmat_cuda.launches
    v64 = vecs.double()
    orth = float((v64.T @ (mass.double()[:, None] * v64)
                  - torch.eye(k, dtype=torch.float64, device=vecs.device))
                 .abs().max())
    lam = lams.double().cpu().numpy()
    steps = rec["steps"]
    block = [st["block_s"] for st in steps]
    rr = [st["rr_s"] for st in steps]
    out.update(iters=rec["iters"], total_s=total, block_s=block, rr_s=rr,
               lams=lam.tolist(), max_resnorm=float(res.max()),
               orth_err=orth, b1_launches=launches, slab_matvecs=matvecs,
               # Above what the process held before (the 200k hierarchy).
               peak_bytes=torch.cuda.max_memory_allocated() - held
               if on_card else None)
    print(f"[14] c6 at n={n}: set-up {out['setup_s']:.2f} s (levels "
          f"{out['levels']}, alpha {out['alpha']:.4g}); laplace_eigs k={k}: "
          f"{rec['iters']} iterations, {total:.3f} s in all; per iteration "
          f"device block {np.mean(block) * 1e3:.2f} ms (min "
          f"{min(block) * 1e3:.2f}), Rayleigh-Ritz on the host "
          f"{np.mean(rr) * 1e3:.2f} ms (min {min(rr) * 1e3:.2f})")
    print(f"[14] lam_0 {lam[0]:.4e}, lam_1 {lam[1]:.6g}, lam_11 "
          f"{lam[-1]:.6g}; max_resnorm {out['max_resnorm']:.3e} (c6 target "
          f"1e-2); max|X^T M X - I| {orth:.3e}; peak device memory of "
          f"laplace_eigs {out['peak_bytes']} bytes (above what the process "
          f"held before it); B1 launched {launches} times for {matvecs} "
          f"({n}, {k}) slab matvecs")
    finite = all(bool(torch.isfinite(t).all()) for t in (lams, vecs, res))
    ascending = bool(np.all(np.diff(lam) >= 0))
    if not (finite and ascending and orth <= 1e-4
            and abs(lam[0]) <= 1e-3 * lam[-1]):
        raise AssertionError(f"laplace_eigs failed its checks: finite "
                             f"{finite}, ascending {ascending}, orth {orth}, "
                             f"lams {lam}")
    if launches != (matvecs if on_card else 0) or not matvecs:
        raise AssertionError(f"B1 launched {launches} times for {matvecs} "
                             f"slab matvecs of laplace_eigs on {dev.type}")
    if on_card:
        out["check"] = _check_matmat(torch, _slabs(h), (k,), "14")
        gen = torch.Generator(device="cuda").manual_seed(0)
        xx = torch.randn((n, k), generator=gen, device="cuda")
        out[f"D{k} float32"] = _b1_row(torch, h.levels[0].banded, xx,
                                       torch.float32, "14")
    return out


def _timed(torch, dev, fn, reps=10):
    """Median ms of ``fn`` on the card (CUDA events); None off the card
    (a CPU run gives no device time)."""
    if dev.type != "cuda":
        fn()
        return None
    from gravomg_tpu_torch.probes.timing import cuda_ms
    return cuda_ms(fn, reps=reps)


def phase_rhs_batch(torch, device, n, d):
    """Phase 15 (a): the c5 recipe at ``n`` points with ``d``
    right-hand sides (N(0,1) from ``default_rng(2)``, drawn (d, n) as
    the JAX recipe draws them, laid out (n, d)): one (n, d) V-cycle from
    zero against the d 1-D cycles of its columns (each column within
    ``TOL_COLUMNS`` of its largest entry), their times on the card and
    B1's launches in the (n, d) cycle (above 0 on the card); inputs and
    pipeline of ``gravomg_tpu_torch/bench_configs.py``."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch import bench_configs as bc
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matmat_cuda
    from gravomg_tpu_torch.utils.profiling import synchronize
    dev = torch.device(device)
    c5 = bc.c5_inputs(n, d)
    cfg, h = c5.cfg, bc.pipeline(c5.points, c5.k, c5.cfg, device=device).h
    b = torch.as_tensor(c5.rhs, device=dev)
    bcols = [b[:, j].contiguous() for j in range(d)]
    blockdense_matmat_cuda.launches = 0
    x = gt.v_cycle(h, torch.zeros_like(b), b, cfg)
    synchronize(dev)
    launches = blockdense_matmat_cuda.launches
    worst = bc.worst_column(x, [gt.v_cycle(h, torch.zeros_like(c), c, cfg)
                                for c in bcols])
    batch_ms = _timed(torch, dev,
                      lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
    seq_ms = _timed(torch, dev, lambda: [
        gt.v_cycle(h, torch.zeros_like(c), c, cfg) for c in bcols])
    forms = [[_fast_kind(getattr(lvl, f)) for f, _ in FIELDS]
             for lvl in h.levels[:-1]]
    out = {"n": n, "d": d, "levels": [lvl.op.num_vertices
                                      for lvl in h.levels],
           "forms": forms, "worst_column_rel": worst, "b1_launches": launches,
           "batch_ms": batch_ms, "sequential_ms": seq_ms,
           "batch_ms_per_rhs": None if batch_ms is None else batch_ms / d,
           "sequential_ms_per_rhs": None if seq_ms is None else seq_ms / d}
    print(f"[15] c5 at n={n}, {d} right-hand sides: levels {out['levels']}, "
          f"forms [A, U, U^T] per level {forms}; one ({n}, {d}) V-cycle "
          f"{_fmt(batch_ms)} ms ({_fmt(out['batch_ms_per_rhs'])} ms a "
          f"right-hand side) against {d} 1-D cycles {_fmt(seq_ms)} ms "
          f"({_fmt(out['sequential_ms_per_rhs'])} ms each; CUDA events, "
          f"median of 10); columns vs 1-D cycles max|d|/max|x| {worst:.3e}; "
          f"B1 launches in the ({n}, {d}) cycle {launches}")
    finite = bool(torch.isfinite(x).all()) and x.shape == b.shape
    if not (finite and worst <= TOL_COLUMNS):
        raise AssertionError(f"c5: finite/shape {finite}, columns against "
                             f"1-D cycles {worst:.3e} > {TOL_COLUMNS}")
    if dev.type == "cuda" and launches <= 0:
        raise AssertionError("the (n, d) cycle never launched B1")
    return out


def _check_matmat(torch, slabs, ds, tag):
    """B1 against its twin on every slab form in ``slabs`` at each D of
    ``ds``, f32 and bf16 m, at ``TOL_KERNEL``, each call twice on one
    input and the two Y bitwise equal: over each bucket alone
    (``blockdense_matmat_cuda`` against ``blockdense_matmat_plain``), and
    in one launch over all buckets of the form (``slab_matmat_cuda``
    against ``slab_matmat_plain``)."""
    from gravomg_tpu_torch.ops.blockdense import pad_x
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matmat_cuda, blockdense_matmat_plain, slab_matmat_cuda,
        slab_matmat_plain)
    gen = torch.Generator(device="cuda").manual_seed(5)
    worst_rel, worst_abs, n, n_forms = 0.0, 0.0, 0, 0
    for label, sop in slabs:
        for d in ds:
            x = torch.randn((sop.n_cols, d), generator=gen, device="cuda")
            xp = pad_x(sop.buckets[0], x)
            for dt in (torch.float32, torch.bfloat16):
                sd = _slab_on(sop, dt)
                cases = [(f"cap {b.nw}",
                          lambda b=b: blockdense_matmat_cuda(b, x, xp),
                          lambda b=b: blockdense_matmat_plain(b, x, xp))
                         for b in sd.buckets]
                cases.append(("one launch",
                              lambda: slab_matmat_cuda(sd, x),
                              lambda: slab_matmat_plain(sd, x)))
                for what, kern, plain in cases:
                    y1, y2, yp = kern(), kern(), plain()
                    torch.cuda.synchronize()
                    if not torch.equal(y1, y2):
                        raise AssertionError(f"B1 on {label} {what} D={d}: "
                                             f"two runs differ")
                    err = float((y1 - yp).abs().max())
                    rel = err / max(float(yp.abs().max()), 1e-30)
                    worst_rel = max(worst_rel, rel)
                    worst_abs = max(worst_abs, err)
                    n += 1
                    if not rel <= TOL_KERNEL:
                        raise AssertionError(
                            f"B1 vs twin on {label} {what} D={d} "
                            f"{_dtype_name(dt)}: {rel:.3e} > {TOL_KERNEL}")
                n_forms += 1
    if not n:
        raise AssertionError("no slab form to check B1 on")
    print(f"[{tag}] B1 vs twin ok on {n} cases of {len(slabs)} slab forms "
          f"({n - n_forms} per bucket, {n_forms} in one launch a form), D "
          f"{list(ds)}, f32 and bf16 m, bitwise repeatable, worst "
          f"{worst_rel:.3e} <= {TOL_KERNEL}")
    return {"cases": n, "one_launch_cases": n_forms, "worst_rel": worst_rel,
            "worst_abs": worst_abs}


def _nonzero_positions(slabs, tag):
    """Per 8-row slab form: the share of its (block, position) pairs
    where one of the block's 8 rows holds a nonzero (what B1 multiplies),
    and the share of m's entries that are nonzero."""
    from gravomg_tpu_torch.probes.timing import nonzero_pairs
    out = {}
    for label, sop in slabs:
        pairs = nonzero_pairs(sop.buckets)
        total = sum(b.m.shape[0] * b.m.shape[2] for b in sop.buckets)
        nnz = sum(int((b.m != 0).sum()) for b in sop.buckets)
        out[label] = {"pairs": pairs, "positions": total,
                      "pair_share": pairs / total,
                      "entry_share": nnz / (8 * total)}
    print(f"[{tag}] nonzero (block, position) pairs / all, and nonzero "
          f"entries of m / all, per 8-row slab form: " + "; ".join(
              f"{k} {v['pair_share']:.4f} / {v['entry_share']:.4f}"
              for k, v in out.items()))
    return out


def _count_slab_matvecs(torch, fn, ndim=2):
    """(result of fn(), number of ``ndim``-D x the 8-row slab forms took
    in it), counted at the cycle's call of ``slab_matvec``."""
    from gravomg_tpu_torch.solve import vcycle as vc
    inner, count = vc.slab_matvec, [0]

    def counted(op, x):
        if x.ndim == ndim and not op.mxu:
            count[0] += 1
        return inner(op, x)
    vc.slab_matvec = counted
    try:
        res = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        vc.slab_matvec = inner
    return res, count[0]


def phase_rhs_1m(torch, cfg, h):
    """Phase 15 (b), on the card: phase 3's 1M hierarchy (slab forms)
    with D=64 right-hand sides (a generator seeded 0): the share of
    nonzero positions of every 8-row slab form; one (V, 64) V-cycle
    against one 1-D cycle, with B1's launches beside the number of slab
    matvecs and a profile; the (V, 64) and (V, 3) cycles through B1
    against the same cycles on the ELL forms alone (the route a 2-D x
    took before B1); B1 against its twin on every slab form at D 3 and
    64, per bucket and in one launch; and B1 on level-0 A, f32 and bf16
    m, D 3 and 64, in one launch: per call, alone, plain twin, the
    per-bucket route, library (f32), bytes, multiply-adds, bound and
    share."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch import bench_configs as bc
    from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matmat_cuda
    from gravomg_tpu_torch.parallel.sharding import drop_fast_forms
    from gravomg_tpu_torch.probes.timing import cuda_ms
    d = 64
    out = {"nonzero": _nonzero_positions(_slabs(h), "15")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = torch.randn((N, d), generator=gen, device="cuda")
    b1 = b[:, 0].contiguous()
    blockdense_matmat_cuda.launches = 0
    x, matvecs = _count_slab_matvecs(
        torch, lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
    out.update(launches=blockdense_matmat_cuda.launches,
               slab_matvecs=matvecs)
    cols = [gt.v_cycle(h, torch.zeros_like(b1), b1, cfg)]
    out["worst_column_rel"] = bc.worst_column(x[:, :1], cols)
    finite = bool(torch.isfinite(x).all())
    out["vcycle64_ms"] = cuda_ms(
        lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg))
    out["vcycle1_ms"] = cuda_ms(
        lambda: gt.v_cycle(h, torch.zeros_like(b1), b1, cfg))
    print(f"[15] 1M, {d} right-hand sides: one (V, {d}) V-cycle "
          f"{out['vcycle64_ms']:.3f} ms ({out['vcycle64_ms'] / d:.3f} ms a "
          f"right-hand side) against one 1-D cycle {out['vcycle1_ms']:.3f} "
          f"ms (CUDA events, median of 10); B1 launches in one (V, {d}) "
          f"cycle {out['launches']} for {matvecs} slab matvecs; column 0 "
          f"vs its 1-D cycle {out['worst_column_rel']:.3e}; finite {finite}")
    h_ell = drop_fast_forms(h)
    b3 = b[:, :3].contiguous()
    # The ELL (V, 64) cycle takes about 300 ms: three timed runs.
    out["vcycle64_ell_ms"] = cuda_ms(
        lambda: gt.v_cycle(h_ell, torch.zeros_like(b), b, cfg), reps=3,
        warmup=1)
    out["vcycle3_ms"] = cuda_ms(
        lambda: gt.v_cycle(h, torch.zeros_like(b3), b3, cfg))
    out["vcycle3_ell_ms"] = cuda_ms(
        lambda: gt.v_cycle(h_ell, torch.zeros_like(b3), b3, cfg))
    print(f"[15] the same cycles on the ELL forms alone: (V, {d}) "
          f"{out['vcycle64_ell_ms']:.3f} ms (median of 3); (V, 3) through "
          f"B1 {out['vcycle3_ms']:.3f} ms against ELL "
          f"{out['vcycle3_ell_ms']:.3f} ms (median of 10)")
    del h_ell, b3
    if not (finite and out["worst_column_rel"] <= TOL_COLUMNS):
        raise AssertionError("the 1M (V, 64) cycle failed its checks")
    if out["launches"] <= 0:
        raise AssertionError("the 1M (V, 64) cycle never launched B1")
    if out["launches"] != matvecs:
        raise AssertionError(f"B1 launched {out['launches']} times for "
                             f"{matvecs} slab matvecs, not once each")
    out["profile"] = _profile_vcycle(torch, cfg, h, b, out["vcycle64_ms"],
                                     "15")
    del x, cols
    out["check"] = _check_matmat(torch, _slabs(h), (3, d), "15")
    a0 = h.levels[0].banded
    for dd in (3, d):
        xx = torch.randn((N, dd), generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            out[f"D{dd} {_dtype_name(dt)}"] = _b1_row(torch, a0, xx, dt,
                                                      "15")
        del xx
    del b, b1
    return out


def _b1_row(torch, sop, xx, dt, tag):
    """B1 in one launch on the slab form ``sop`` (m in ``dt``) and the
    (n, D) block ``xx``: per call, alone, plain twin, the per-bucket
    route, library (f32), bytes, multiply-adds, bound and share."""
    from gravomg_tpu_torch.ops.blockdense_cuda import (
        blockdense_matmat_cuda, slab_matmat_cuda, slab_matmat_plain)
    from gravomg_tpu_torch.probes.timing import (bucket_loop, cuda_ms,
                                                 kernel_ms, library_bmm,
                                                 matvec_bound, nonzero_pairs)
    dd = xx.shape[1]
    sd = _slab_on(sop, dt)
    bs = list(sd.buckets)
    kern = lambda: slab_matmat_cuda(sd, xx)
    plain = lambda: slab_matmat_plain(sd, xx)
    p1 = cuda_ms(plain)
    k1 = cuda_ms(kern)
    k2 = cuda_ms(kern)
    p2 = cuda_ms(plain)
    per_bucket = cuda_ms(bucket_loop(blockdense_matmat_cuda, bs, xx))
    alone = kernel_ms(kern, "blockdense_matmat_kernel")
    bound_ms, bound_by, io_bytes = matvec_bound(bs, xx)
    madds = 8 * dd * nonzero_pairs(bs)
    # No library call for bf16 m: torch.bmm in bf16 rounds X.
    lib = cuda_ms(library_bmm(bs, xx)) if dt == torch.float32 else None
    name = f"D{dd} {_dtype_name(dt)}"
    k_ms = min(k1, k2)
    row = {"kernel_ms": [k1, k2], "plain_ms": [p1, p2],
           "per_bucket_ms": per_bucket, "alone_ms": alone,
           "io_bytes": io_bytes, "multiply_adds": madds,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / k_ms,
           "alone_share_of_bound": (None if alone is None
                                    else bound_ms / alone),
           "library_ms": lib}
    print(f"[{tag}] B1 level-0 A ({len(bs)} buckets, one launch) {name}: "
          f"per call {k1:.3f}/{k2:.3f} ms, kernel alone {_fmt(alone)} ms; "
          f"twin {p1:.3f}/{p2:.3f} ms; per-bucket route {per_bucket:.3f} "
          f"ms; {io_bytes} bytes, {madds} multiply-adds (nonzero "
          f"positions), bound {bound_ms:.3f} ms ({bound_by}), share "
          f"{bound_ms / k_ms:.2f} (alone "
          f"{_fmt(row['alone_share_of_bound'], 2)}); library (one "
          f"torch.bmm per bucket, windows gathered) "
          + ("none" if lib is None else f"{lib:.3f} ms"))
    return row


def phase_meshes(torch, device, n_meshes, n):
    """Phase 16: the c5b recipe of scripts/bench_configs.py with
    ``n_meshes`` tori of ``n`` points (seed 200 + i, each scaled by
    1 + 0.25 * default_rng(5).random(3), Morton order, grid kNN k=12
    margin 2.4, alpha="auto", coarse_threshold=400, max_levels=3,
    Chebyshev), each hierarchy built by ``build_hierarchy_device``
    (generator seeded i); ``attach_collection``, ``stack_solvers`` and
    one ``batched_v_cycle`` on N(0,1) right-hand sides from
    ``default_rng(3)`` (zero on padded rows): each mesh's real rows
    against its own ELL ``v_cycle`` within ``TOL_COLUMNS`` of its
    largest entry, its padded rows exactly 0; the batched cycle's time
    against the per-mesh loop (card only), the padded row counts against
    the real ones, peak device memory above what the process held, and
    ``batched_solve``'s shared count and largest residual (reported:
    the f32 stationary solve stalls above 1e-8).  Inputs, pipeline and
    check are ``gravomg_tpu_torch/bench_configs.py``'s."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch import bench_configs as bc
    from gravomg_tpu_torch.utils.profiling import synchronize
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    c5b = bc.c5b_inputs(n, n_meshes)
    cfg = c5b.cfg
    hs, build_s = [], 0.0
    for i, pts in enumerate(c5b.points):
        p = bc.pipeline(pts, c5b.k, cfg, attach=False, device=device,
                        generator=torch.Generator(device=device).manual_seed(i))
        build_s += p.t_build_s
        hs.append(p.h)
    real = [[lvl.op.num_vertices for lvl in h.levels] for h in hs]
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    fast = gt.attach_collection(hs)
    hb = gt.stack_solvers(fast)
    synchronize(dev)
    attach_s = time.perf_counter() - t0
    rows = [lvl.op.num_vertices for lvl in hb.levels]
    bs = torch.as_tensor(bc.c5b_rhs([r[0] for r in real], rows[0]),
                         device=dev)
    xs = gt.batched_v_cycle(hb, torch.zeros_like(bs), bs, cfg)
    worst, padded_zero = bc.collection_check(hs, xs, bs, cfg)
    batch_ms = _timed(torch, dev, lambda: gt.batched_v_cycle(
        hb, torch.zeros_like(bs), bs, cfg))
    loop_ms = _timed(torch, dev, lambda: [
        gt.v_cycle(f, torch.zeros_like(bs[i]), bs[i], cfg)
        for i, f in enumerate(fast)])
    _, rels, iters = gt.batched_solve(hb, bs, cfg)
    peak = (torch.cuda.max_memory_allocated() - held) if on_card else None
    out = {"meshes": n_meshes, "n": n, "build_all_s": build_s,
           "attach_stack_s": attach_s, "padded_rows": rows,
           "real_rows_min": [min(c) for c in zip(*real)],
           "real_rows_max": [max(c) for c in zip(*real)],
           "worst_mesh_rel": worst, "padded_rows_zero": padded_zero,
           "batch_ms": batch_ms, "loop_ms": loop_ms,
           "batch_ms_per_mesh": None if batch_ms is None
           else batch_ms / n_meshes,
           "solve_iters": iters, "solve_max_rel": float(rels.max()),
           "peak_bytes": peak, "phase_s": time.perf_counter() - t_phase}
    print(f"[16] c5b: {n_meshes} tori of {n} points, all {n_meshes} "
          f"hierarchies built on {dev.type} in {build_s:.3f} s; "
          f"attach_collection + stack_solvers {attach_s:.3f} s; rows per "
          f"level padded to {rows} (real {out['real_rows_min']} to "
          f"{out['real_rows_max']})")
    print(f"[16] batched V-cycle {_fmt(batch_ms)} ms "
          f"({_fmt(out['batch_ms_per_mesh'])} ms a mesh) against the "
          f"per-mesh loop {_fmt(loop_ms)} ms (CUDA events, median of 10); "
          f"each mesh's real rows vs its own cycle max|d|/max|x| "
          f"{worst:.3e}, padded rows exactly 0: {padded_zero}; "
          f"batched_solve {iters} shared cycles, largest residual "
          f"{out['solve_max_rel']:.3e}; peak device memory {peak} bytes "
          f"above what the process held; phase {out['phase_s']:.1f} s")
    finite = bool(torch.isfinite(xs).all())
    if not (finite and padded_zero and worst <= TOL_COLUMNS):
        raise AssertionError(f"c5b: finite {finite}, padded rows zero "
                             f"{padded_zero}, meshes vs own cycles "
                             f"{worst:.3e}")
    return out


def multidevice_problem(torch, device, n, workdir):
    """The bench recipe at ``n`` points on ``device`` for phase 17 when
    no phase 3 ran (the CPU test): the hierarchy built by
    ``build_hierarchy_device`` saved as ELL forms to ``workdir``, and the
    greedy hierarchy of ``build_hierarchy_host`` on the CPU.  Returns
    (config, npz path, greedy hierarchy)."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
    cfg, h, _, graph, op = bench_hierarchy(n, device)
    path = os.path.join(workdir, "hierarchy.npz")
    gt.save_solver(path, h)
    h_greedy = _to_device(torch, gt.build_hierarchy_host(graph, op, cfg),
                          "cpu")
    return cfg, path, h_greedy


def _halo_plan_table(torch, h_greedy, nd, n):
    """Phase 17 (c): ``seg_max`` (S) and ``halo_frac`` of every level's
    A, U and U^T plan at ``nd`` ranks on the greedy hierarchy padded for
    the halo path (host seconds), beside HALO_1M.json's at 1M."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.parallel.halo import level_plans
    hp = gt.pad_solver_levels(gt.attach_restrictions(h_greedy), nd,
                              pad_coarse=True)
    recorded = None
    if n == N:
        with open(os.path.join(ROOT, "HALO_1M.json")) as f:
            recorded = json.load(f)["levels"]
    t0 = time.perf_counter()
    rows = []
    for li, lvl in enumerate(hp.levels[:-1]):
        plans = level_plans(lvl, nd, device="cpu")
        row = {"level": li, "rows": lvl.op.num_vertices}
        for key, plan in zip(("A", "U", "Ut"), plans):
            row[key] = {"seg_max": plan.s,
                        "halo_frac": round(plan.halo_frac, 4)}
            if recorded is not None and li < len(recorded):
                rec = recorded[li][key]
                row[key]["recorded"] = {"seg_max": rec["seg_max"],
                                        "halo_frac": rec["halo_frac"]}
        rows.append(row)
    plan_s = time.perf_counter() - t0
    same = None
    if recorded is not None:
        same = len(rows) == len(recorded) and all(
            r[k]["seg_max"] == r[k]["recorded"]["seg_max"]
            and r[k]["halo_frac"] == r[k]["recorded"]["halo_frac"]
            for r in rows for k in ("A", "U", "Ut"))
    for r in rows:
        print(f"[17] (c) halo plan at nd={nd}, level {r['level']} "
              f"({r['rows']} rows): " + "; ".join(
                  f"{k} S {r[k]['seg_max']} halo_frac {r[k]['halo_frac']}"
                  + (f" (HALO_1M.json: {r[k]['recorded']['seg_max']}, "
                     f"{r[k]['recorded']['halo_frac']})"
                     if "recorded" in r[k] else "")
                  for k in ("A", "U", "Ut")))
    print(f"[17] (c) plans of {len(rows)} levels built on the host in "
          f"{plan_s:.2f} s; equal to HALO_1M.json (structure counts, no "
          f"times): {same}")
    return {"levels": rows, "plan_s": plan_s, "equal_to_record": same}


def _true_residual(torch, op, b, x):
    """||b - A x|| / ||b|| with the unsharded operator, in x's dtype and
    in f64."""
    import gravomg_tpu_torch as gt
    r32 = float(torch.linalg.norm(b - gt.spmv(op, x))
                / torch.linalg.norm(b))
    op64 = op._replace(offdiag=op.offdiag.double(), diag=op.diag.double())
    b64 = b.double()
    r64 = float(torch.linalg.norm(b64 - gt.spmv(op64, x.double()))
                / torch.linalg.norm(b64))
    return r32, r64


def phase_multidevice(torch, device, n, world_size, problem=None,
                      n_rhs=64):
    """Phase 17, multi-device at ``n`` points: (a) ``world_size`` gloo
    ranks on ``device`` (on the card: all on the one card) load the ELL
    hierarchy the main process saved, pad and shard it, and run
    ``halo_solve`` and ``sharded_solve`` (MG-PCG) on phase 3's b, one
    ``vertex_sharded_cg_step`` and ``batched_vcycle`` on ``n_rhs``
    right-hand sides (a generator seeded 0 on the device, n_rhs /
    world_size a rank) on the unpadded hierarchy with slab forms, B1's
    launches counted in each rank; the main process holds their rows
    against the unsharded solves on the same ELL hierarchy: each
    solution's residual re-measured with the unsharded operator,
    iterations within 1 of the unsharded ELL MG-PCG, the step's r
    against b - A x, the batched columns against 1-D cycles of the same
    columns within 1e-6 of max|X|.  (b) On the card, one NCCL rank runs
    the same two solves: the unsharded iteration count.  (c) The halo
    plan at nd = 8 on the greedy hierarchy, beside HALO_1M.json at 1M.
    ``problem`` is (config, npz path of the ELL hierarchy, greedy
    hierarchy on the CPU) from phase 3, else built here."""
    import tempfile
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.parallel import run_ranks
    from gravomg_tpu_torch.probes.multidevice import solve_rank
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_md_") as workdir:
        if problem is None:
            problem = multidevice_problem(torch, device, n, workdir)
        cfg, path, h_greedy = problem
        b_np = np.random.default_rng(0).normal(size=n).astype(np.float32)
        h = gt.load_solver(path, device=dev)
        b = torch.as_tensor(b_np, device=dev)
        op0 = h.levels[0].op
        x_ref, rel_ref, it_ref = gt.mg_pcg(h, b, cfg)
        out = {"n": n, "world_size": world_size,
               "unsharded": {"iters": it_ref, "rel": rel_ref,
                             "true_rel": _true_residual(torch, op0, b,
                                                        x_ref)}}
        ref_true = out["unsharded"]["true_rel"][1]
        print(f"[17] multi-device at n={n}: unsharded ELL MG-PCG {it_ref} "
              f"iterations, rel {rel_ref:.3e} (re-measured f32/f64 "
              f"{out['unsharded']['true_rel'][0]:.3e}/"
              f"{out['unsharded']['true_rel'][1]:.3e})")

        t0 = time.perf_counter()
        res = run_ranks(solve_rank, world_size, "gloo", dev,
                        (path, b_np, cfg, n_rhs), timeout_s=900)
        out["gloo_wall_s"] = time.perf_counter() - t0
        tag = (f"{world_size} gloo ranks on {dev.type}"
               + (" (all on the one card; gloo moves every exchange "
                  "through host memory, so no time here measures a link "
                  "between cards)" if on_card else ""))
        for name in ("halo", "sharded"):
            x = torch.cat([r[name]["x"] for r in res]).to(dev)
            iters = {r[name]["iters"] for r in res}
            rels = {r[name]["rel"] for r in res}
            true = _true_residual(torch, op0, b, x)
            secs = [r[name]["s"] for r in res]
            out[name] = {"iters": sorted(iters), "rel": sorted(rels),
                         "true_rel": true, "s": secs,
                         "x_rel_to_unsharded": float(
                             (x - x_ref).norm() / x_ref.norm())}
            if name == "halo":
                out[name]["plan_s"] = [r[name]["plan_s"] for r in res]
                out[name]["halo_frac"] = res[0][name]["halo_frac"]
            print(f"[17] (a) {name}_solve on {tag}: iterations {sorted(iters)}"
                  f", rel {max(rels):.3e} (re-measured with the unsharded "
                  f"operator f32/f64 {true[0]:.3e}/{true[1]:.3e}), x vs "
                  f"unsharded {out[name]['x_rel_to_unsharded']:.3e}; s per "
                  f"rank {[round(v, 3) for v in secs]}"
                  + (f"; plan s per rank "
                     f"{[round(v, 3) for v in out[name]['plan_s']]}, "
                     f"halo_frac per level {out[name]['halo_frac']}"
                     if name == "halo" else ""))
            # An f32 CG stopped at a 1e-8 recurrence residual has a true
            # residual at its rounding floor far above 1e-8 (ROADMAP §3),
            # the unsharded solve's too: the sharded one is held to that.
            if not (len(iters) == 1 and len(rels) == 1
                    and max(rels) <= 1e-8
                    and true[1] <= TRUE_RES_FACTOR * ref_true
                    and abs(iters.pop() - it_ref) <= 1
                    and bool(torch.isfinite(x).all())
                    and x.shape == b.shape):
                raise AssertionError(f"{name}_solve: {out[name]} against "
                                     f"{out['unsharded']}")
        # The same step unsharded: x = 0, r = b, p = z = M b.
        hp = gt.pad_solver_levels(h, world_size)
        a0 = hp.levels[0].op
        r0 = torch.zeros((a0.num_vertices,), dtype=b.dtype, device=dev)
        r0[:n] = b
        z0 = gt.v_cycle(hp, torch.zeros_like(r0), r0, cfg, x0_zero=True)
        rz0 = torch.dot(r0, z0)
        ap = gt.spmv(a0, z0)
        alpha = rz0 / torch.dot(z0, ap)
        want = {"x": alpha * z0, "r": r0 - alpha * ap}
        gaps = {}
        for key, w in want.items():
            got = torch.cat([r["step"][key] for r in res]).to(dev)
            gaps[key] = float((got - w).abs().max() / w.abs().max())
        rzs = {r["step"]["rz"] for r in res}
        out["step"] = {"rel_to_unsharded": gaps, "rz": sorted(rzs)}
        print(f"[17] (a) vertex_sharded_cg_step from x = 0 against the same "
              f"step unsharded: max|d|/max|v| x {gaps['x']:.3e}, r "
              f"{gaps['r']:.3e}; r.z {sorted(rzs)} on every rank")
        if not (len(rzs) == 1 and max(gaps.values()) <= TOL_COLUMNS):
            raise AssertionError(f"vertex_sharded_cg_step: {out['step']}")
        del hp, a0, r0, z0, ap, want

        hslab = gt.attach_slab_operators(h)
        gen = torch.Generator(device=dev).manual_seed(0)
        bs = torch.randn((n_rhs, n), generator=gen, device=dev)
        xb = torch.cat([r["batched"]["x"] for r in res]).to(dev)
        worst = 0.0
        for j in range(n_rhs):
            col = gt.v_cycle(hslab, torch.zeros_like(bs[j]), bs[j], cfg)
            worst = max(worst, float((xb[j] - col).abs().max()))
        worst /= float(xb.abs().max())
        launches = [r["batched"]["b1_launches"] for r in res]
        peaks = [r["peak_bytes"] for r in res]
        out["batched"] = {"worst_rel_to_max": worst, "b1_launches": launches,
                          "s": [r["batched"]["s"] for r in res],
                          "slab_s": [r["batched"]["slab_s"] for r in res]}
        out["peak_bytes"] = peaks
        out["load_s"] = [r["load_s"] for r in res]
        print(f"[17] (a) batched_vcycle, {n_rhs} right-hand sides, "
              f"{n_rhs // world_size} a rank, slab forms: columns vs 1-D "
              f"cycles max|d|/max|X| {worst:.3e}; B1 launches per rank "
              f"{launches}; s per rank "
              f"{[round(v, 3) for v in out['batched']['s']]}; peak device "
              f"memory per rank {peaks} bytes; load s per rank "
              f"{[round(v, 3) for v in out['load_s']]}; all ranks "
              f"{out['gloo_wall_s']:.1f} s wall, spawn included")
        if not (bool(torch.isfinite(xb).all()) and xb.shape == bs.shape
                and worst <= 1e-6):
            raise AssertionError(f"batched_vcycle: {out['batched']}")
        if on_card and min(launches) <= 0:
            raise AssertionError("batched_vcycle never launched B1")
        del hslab, bs, xb

        if on_card:
            t0 = time.perf_counter()
            nccl = run_ranks(solve_rank, 1, "nccl", dev,
                             (path, b_np, cfg, 0), timeout_s=600)[0]
            out["nccl"] = {name: {"iters": nccl[name]["iters"],
                                  "rel": nccl[name]["rel"],
                                  "s": nccl[name]["s"]}
                           for name in ("halo", "sharded")}
            out["nccl"]["wall_s"] = time.perf_counter() - t0
            print(f"[17] (b) one NCCL rank on the card: halo_solve "
                  f"{nccl['halo']['iters']} iterations, rel "
                  f"{nccl['halo']['rel']:.3e}, {nccl['halo']['s']:.3f} s; "
                  f"sharded_solve {nccl['sharded']['iters']} iterations, "
                  f"rel {nccl['sharded']['rel']:.3e}, "
                  f"{nccl['sharded']['s']:.3f} s (unsharded: {it_ref})")
            if not all(nccl[k]["iters"] == it_ref
                       and nccl[k]["rel"] <= 1e-8
                       for k in ("halo", "sharded")):
                raise AssertionError(f"NCCL rank: {out['nccl']}")
        del h, b, x_ref
    out["plan"] = _halo_plan_table(torch, h_greedy, 8, n)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[17] phase {out['phase_s']:.1f} s")
    return out


def _unsharded_iters(torch, dev):
    """MG-PCG iterations of the default config on the entry fixture (b
    from seed 0) and the halo fixture (b from seed 1), unsharded on
    ``dev``: what each dryrun path is held to."""
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch import entry as ge
    cfg = gt.MultigridConfig()
    out = {}
    for key, path, seed in (("entry", ge.ENTRY_FIXTURE, 0),
                            ("halo", ge.HALO_FIXTURE, 1)):
        h = gt.load_solver(path, device=dev)
        b = ge.normal_rhs(h.levels[0].op.num_vertices, seed, dev)
        out[key] = gt.mg_pcg(h, b, cfg)[2]
    return out


def _check_dryrun(res, want, tag):
    """Each dryrun solve to the tolerance within 1 iteration of the
    unsharded MG-PCG on its fixture, the fine halo_frac below 0.25, the
    batched output of 2n right-hand sides."""
    for name, key in (("sharded", "entry"), ("fast", "entry"),
                      ("halo", "halo")):
        r = res[name]
        if not (r["rel"] < 1e-8 and abs(r["iters"] - want[key]) <= 1):
            raise AssertionError(f"{tag} {name}: {r} against {want[key]} "
                                 f"unsharded iterations")
    if not (res["halo"]["halo_frac"] < 0.25
            and res["batched"]["shape"][0] == 2 * res["n_devices"]):
        raise AssertionError(f"{tag}: {res}")
    print(f"[18] (b) {tag}: " + "; ".join(
        f"{name} {res[name]['iters']} iterations, rel "
        f"{res[name]['rel']:.3e}, s per rank "
        f"{[round(s, 3) for s in res['s_per_rank'][name]]}"
        for name in ("sharded", "fast", "halo"))
          + f"; batched {res['batched']['shape']} s per rank "
          f"{[round(s, 3) for s in res['s_per_rank']['batched']]}; "
          f"halo_frac {res['halo']['halo_frac']:.4f}; {res['wall_s']:.1f} s "
          f"wall, spawn included (unsharded MG-PCG: {want})")


def _bench_subprocess(torch, n, main):
    """Phase 18 (c): ``python -m gravomg_tpu_torch.bench --n n`` in a
    process of its own; its one stdout line and stderr account, held to
    phase 5's iteration counts (``main``) and its own K1 count."""
    path = os.path.join(ROOT, "chiprun_out", f"bench_{n}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "gravomg_tpu_torch.bench", "--n", str(n),
         "--out", path], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the bench exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()
    line = json.loads(lines[0]) if len(lines) == 1 else None
    account = [ln for ln in proc.stderr.splitlines() if ln.startswith("#")]
    print(f"[18] (c) bench stdout: {proc.stdout.strip()}")
    for ln in account:
        print(f"[18] (c) bench stderr: {ln}")
    if line is None or set(line) != {"metric", "value", "unit",
                                     "vs_baseline"}:
        raise AssertionError(f"the bench printed {len(lines)} lines on "
                             f"stdout: {proc.stdout[:2000]}")
    with open(path) as f:
        rec = json.load(f)
    cyc = rec["cycle"]
    print(f"[18] (c) bench at n={n}: {wall:.1f} s in all; V-cycle "
          f"{rec['vcycle_ms']:.4f} ms (slope, r2 {rec['slope_r2']:.6f}), "
          f"median single cycle {rec['single_cycle_ms']:.4f} ms, SciPy "
          f"cycle {rec['cpu_vcycle_ms']:.1f} ms; mg_pcg "
          f"{rec['mg_pcg']['iters']} it, {rec['mg_pcg']['s']:.4f} s; "
          f"mg_solve ({rec['mg_solve']['path']}) {rec['mg_solve']['iters']} "
          f"it, {rec['mg_solve']['s']:.4f} s (phase 5: "
          f"{main['mg_pcg']['iters']} and {main['mg_solve']['iters']}); K1 "
          f"{cyc['k1_launches']} launches for {cyc['slab_matvecs']} slab "
          f"matvecs in one cycle")
    if not (line["metric"] == f"vcycle_ms_{n}v" and line["value"] > 0
            and line["vs_baseline"] > 0
            and abs(rec["mg_pcg"]["iters"] - main["mg_pcg"]["iters"]) <= 1
            and abs(rec["mg_solve"]["iters"] - main["mg_solve"]["iters"])
            <= 1 and cyc["k1_launches"] == cyc["slab_matvecs"] > 0):
        raise AssertionError(f"bench: {line}, record {path}")
    return {"line": line, "account": account, "wall_s": wall,
            "record": os.path.relpath(path, ROOT)}


def phase_entry(torch, device):
    """Phase 18 (a): one cycle of ``entry(device)`` against
    ``entry(device="cpu")``'s at 1e-5 of its largest entry, timed on the
    card (CUDA events, median of 10)."""
    from gravomg_tpu_torch.entry import entry, entry_residual
    dev = torch.device(device)
    fn, args = entry(device=dev)
    y = fn(*args).cpu()
    fn_c, args_c = entry(device="cpu")
    y_c = fn_c(*args_c)
    err = float((y - y_c).abs().max() / y_c.abs().max())
    out = {"rel_to_cpu": err, "ms": _timed(torch, dev, lambda: fn(*args)),
           "residual": entry_residual(fn, args)}
    print(f"[18] (a) entry(): one V-cycle on {y.shape[0]} rows on {dev}, "
          f"relative residual {out['residual']:.3e}, against the CPU cycle "
          f"max|d|/max|x| {err:.3e}; {_fmt(out['ms'], 4)} ms (median of "
          f"10, CUDA events)")
    if not (err <= 1e-5 and bool(torch.isfinite(y).all())):
        raise AssertionError(f"entry cycle: {out}")
    return out


def phase_dryrun(torch, device):
    """Phase 18 (b): ``dryrun_multichip`` on the card as one NCCL rank
    (``device=None``) and as 4 gloo ranks sharing the card, on the CPU as
    2 gloo ranks, each path within 1 iteration of the unsharded MG-PCG on
    its fixture; then, with ``device=None`` and one rank more than there
    are cards, the RuntimeError, raised before any rank starts."""
    from gravomg_tpu_torch.entry import dryrun_multichip
    dev = torch.device(device)
    want = _unsharded_iters(torch, dev)
    runs = ((("one NCCL rank on the card", 1, {}),
             ("4 gloo ranks sharing the card", 4,
              {"device": "cuda", "backend": "gloo"}))
            if dev.type == "cuda" else
            (("2 gloo ranks on the CPU", 2, {"device": "cpu"}),))
    out = {"unsharded_iters": want, "runs": {}}
    for tag, nd, kw in runs:
        res = dryrun_multichip(nd, **kw)
        _check_dryrun(res, want, tag)
        out["runs"][tag] = res
    n_over = torch.cuda.device_count() + 1
    t0 = time.perf_counter()
    try:
        dryrun_multichip(n_over)
    except RuntimeError as e:
        msg = str(e)
    else:
        raise AssertionError(f"dryrun_multichip({n_over}) ran on "
                             f"{n_over - 1} cards")
    refused_s = time.perf_counter() - t0
    print(f"[18] (b) dryrun_multichip({n_over}) with device=None raised in "
          f"{refused_s:.4f} s: {msg}")
    if not ('device="cpu"' in msg and 'backend="gloo"' in msg
            and refused_s < 1.0):
        raise AssertionError(f"the refusal: {msg} after {refused_s} s")
    out["refused"] = {"n": n_over, "message": msg, "s": refused_s}
    return out


def phase_drivers(torch, device, n, main):
    """Phase 18 on ``device``: (a) :func:`phase_entry`, (b)
    :func:`phase_dryrun`, (c) the bench at ``n`` points in a process of
    its own, held to phase 5's iteration counts ``main``."""
    t0 = time.perf_counter()
    out = {"entry": phase_entry(torch, device),
           "dryrun": phase_dryrun(torch, device),
           "bench": _bench_subprocess(torch, n, main)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[18] phase {out['phase_s']:.1f} s")
    return out


def phase_configs(torch, device, n=None):
    """Phase 19: c1, c2 and c3 of the config sweep
    (``gravomg_tpu_torch/bench_configs.py``, the counterpart of
    scripts/bench_configs.py) on ``device``, at the script's sizes
    (``n`` None) or at ``n`` points each; each row printed, with K1's and
    B1's launches over the phase (counts set to 0 just before it).  The
    module checks each result: c1's and c2's MG-PCG to 1e-8 with K1
    launched in the solve on the card, c3's phi finite."""
    from gravomg_tpu_torch import bench_configs as bc
    from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matmat_cuda,
                                                       blockdense_matvec_cuda)
    dev = torch.device(device)
    t0 = time.perf_counter()
    blockdense_matvec_cuda.launches = 0
    blockdense_matmat_cuda.launches = 0
    rows = {}
    for name in ("c1", "c2", "c3"):
        rows[name] = bc.ALL[name](dev, n)
        print(f"[19] {json.dumps(rows[name])}")
    out = {"rows": rows, "k1_launches": blockdense_matvec_cuda.launches,
           "b1_launches": blockdense_matmat_cuda.launches,
           "phase_s": time.perf_counter() - t0}
    c1, c2, c3 = rows["c1"], rows["c2"], rows["c3"]
    print(f"[19] K1 launches over the phase {out['k1_launches']} (one call: "
          f"c1 MG-PCG {c1['solve_k1_launches']}, c2 8 cycles "
          f"{c2['vcycle8_k1_launches']}, c2 MG-PCG "
          f"{c2['pcg_solve_k1_launches']}, c3 heat "
          f"{c3['two_solve_heat_k1_launches']}); B1 {out['b1_launches']}")
    print(f"[19] c1 n={c1['n']} levels {c1['levels']}: MG-PCG {c1['iters']} "
          f"it to {c1['rel_residual']:.3e}, {c1['solve_s']:.4f} s; c2 "
          f"n={c2['n']} levels {c2['levels']}: 8 cycles "
          f"{c2['vcycle8_s']:.4f} s, MG-PCG {c2['iters']} it to "
          f"{c2['rel_residual']:.3e}, {c2['pcg_solve_s']:.4f} s; c3 "
          f"n={c3['n']} levels {c3['levels']}: heat_geodesics "
          f"{c3['two_solve_heat_s']:.4f} s, finite {c3['finite']} (medians "
          f"of {bc.REPS}, host clock); phase {out['phase_s']:.1f} s")
    return out


def phase_uniform(torch, cfg, h):
    """Phase 20: the uniform kernel U1 on the main path, phase 3's
    hierarchy with the uniform forms ``attach_fast_operators`` gives the
    levels below the slab forms, as ``attach_operators`` gives them to
    the bench and the benchmark.  Each uniform form, f32 and bf16 m: U1
    against the plain path (``probes/uniform.py::check``), twice on one
    x (bitwise equal), and ``measure_form``'s bytes, bound and times.
    Then ``mg_solve`` with U1's count set to 0 just before and read just
    after, which must equal the cycle's 1-D matvecs on uniform forms, and
    the same solve through the plain path (iterations within 1)."""
    import numpy as np
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                                  blockdense_matvec)
    from gravomg_tpu_torch.ops.uniform_cuda import uniform_matvec_cuda
    from gravomg_tpu_torch.probes import uniform
    from gravomg_tpu_torch.solve import vcycle
    hf = gt.attach_fast_operators(h)
    forms = [(f"L{li} {label}", getattr(lvl, field))
             for li, lvl in enumerate(hf.levels) for field, label in FIELDS
             if isinstance(getattr(lvl, field), BlockDenseOperator)]
    if not forms:
        raise AssertionError("the 1M hierarchy has no uniform form")
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {"forms": {}, "worst_abs": 0.0}
    for label, op in forms:
        x = torch.randn(op.n_cols, generator=gen, device="cuda")
        for dt in (torch.float32, torch.bfloat16):
            form = op._replace(m=op.m.to(dt))
            y1 = uniform_matvec_cuda(form, x)
            y2 = uniform_matvec_cuda(form, x)
            chk = uniform.check(form, x, y1)
            if not (chk["within_tol"] and torch.equal(y1, y2)):
                raise AssertionError(f"U1 on {label} {_dtype_name(dt)}: "
                                     f"{chk}, bitwise repeatable "
                                     f"{torch.equal(y1, y2)}")
            row = uniform.measure_form(form, x)
            row.update(chk)
            out["forms"][f"{label} {_dtype_name(dt)}"] = row
            out["worst_abs"] = max(out["worst_abs"], chk["max_abs_err"])
            print(f"[20] {label} {row['dtype']} m {row['m_shape']}: U1 per "
                  f"call {row['per_call_ms']:.4f} ms (host "
                  f"{row['host_us']:.1f} us), alone "
                  f"{_fmt(row['alone_ms'], 4)} ms, L2 flushed "
                  f"{_fmt(row['alone_cold_ms'], 4)} ms; bound "
                  f"{row['bound_ms']:.5f} ms ({row['bound_by']}, "
                  f"{row['io_bytes']} bytes); plain path "
                  f"{row['plain_ms']:.4f} ms (host "
                  f"{row['plain_host_us']:.1f} us, "
                  f"{row['plain_launches_a_call']} launches); library "
                  + ("none" if row["library_ms"] is None
                     else f"{row['library_ms']:.4f} ms")
                  + f"; max|d| {chk['max_abs_err']:.3e} within "
                  f"{uniform.TOL} of |terms|; bitwise repeatable")
    out["timed"] = f"{forms[0][0]} float32"

    b = torch.as_tensor(np.random.default_rng(0).normal(size=N)
                        .astype(np.float32), device="cuda")
    inner = vcycle.uniform_matvec
    matvecs = [0]

    def counted(op, x):
        if x.ndim == 1 and not op.stacked:
            matvecs[0] += 1
        return inner(op, x)

    uniform_matvec_cuda.launches = 0
    vcycle.uniform_matvec = counted
    try:
        _, rel, it = gt.mg_solve(hf, b, cfg)
        torch.cuda.synchronize()
    finally:
        vcycle.uniform_matvec = inner
    out["launches"] = launches = uniform_matvec_cuda.launches
    vcycle.uniform_matvec = blockdense_matvec
    try:
        _, rel_plain, it_plain = gt.mg_solve(hf, b, cfg)
    finally:
        vcycle.uniform_matvec = inner
    out.update(matvecs=matvecs[0], iters=it, rel=rel, plain_iters=it_plain,
               plain_rel=rel_plain)
    print(f"[20] mg_solve with the uniform forms: {it} iterations to "
          f"{rel:.3e}, U1 launched {launches} times for {matvecs[0]} 1-D "
          f"uniform matvecs; through the plain path {it_plain} iterations "
          f"to {rel_plain:.3e}")
    if not (0 < launches == matvecs[0]):
        raise AssertionError(f"U1 launched {launches} times for "
                             f"{matvecs[0]} uniform matvecs, not once each")
    if not (rel <= 1e-8 and rel_plain <= 1e-8 and abs(it - it_plain) <= 1):
        raise AssertionError(f"mg_solve through U1: {it} iterations to "
                             f"{rel}; the plain path {it_plain} to "
                             f"{rel_plain}")
    return out


def _share_rows(obj, path=""):
    """(path, row) for every timed row of the report: a dict with a
    share of its bound and the bytes that bound counts."""
    if isinstance(obj, dict):
        if "share_of_bound" in obj and "io_bytes" in obj:
            yield path, obj
        for k, v in obj.items():
            yield from _share_rows(v, f"{path}/{k}")
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            yield from _share_rows(v, f"{path}/{i}")


def _check_shares(kernels, report):
    """Raise if a kernel reads faster than its bound allows (a share of
    the bound above ``MAX_SHARE``): its count of bytes or operations is
    wrong.  Every kernel of the kernels line, and every timed row of the
    report, per call and alone (the rows whose working set fits in L2
    are timed with L2 flushed before each run, so a bound by device
    memory holds for them too)."""
    shares = {" ".join(filter(None, (k["name"], k.get("case")))):
              k["bound_ms"] / k["ms"] for k in kernels}
    for path, row in _share_rows(report):
        shares[path] = row["share_of_bound"]
        if row.get("alone_share_of_bound") is not None:
            shares[f"{path} alone"] = row["alone_share_of_bound"]
    over = {k: v for k, v in shares.items() if v > MAX_SHARE}
    if over:
        raise AssertionError(f"share of the bound above {MAX_SHARE}: {over}")
    print(f"[done] {len(shares)} shares of a bound checked, largest "
          f"{max(shares.values()):.2f} <= {MAX_SHARE}")


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
        import gravomg_tpu_torch as gt
    except ImportError as e:
        print(f"chip_smoke: the gravomg_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    report = {"env": phase_environment(torch), "build": phase_build()}
    cfg, h, h_greedy, report["setup"], graph = phase_setup(torch)
    report["kernel_check"] = phase_kernel_check(torch, "cuda", N, h)
    report["fixture"] = phase_fixture(torch)
    report["main"] = phase_main(torch, "cuda", N, (cfg, h, h_greedy))
    # Phase 17 plans the halo exchange of the greedy hierarchy on the host.
    h_greedy = _to_device(torch, h_greedy, "cpu")
    report["timing"] = phase_timing(torch, "cuda", N, h)
    report["profile"] = phase_profile(torch, cfg, h,
                                      report["main"]["vcycle_ms"])
    report["uniform"] = phase_uniform(torch, cfg, h)
    report["windows_1m"] = phase_window_finding(h)
    report["apps"] = phase_apps(torch, "cuda", N, (cfg, h, graph))
    report["rhs_1m"] = phase_rhs_1m(torch, cfg, h)
    # Phase 17's ranks load phase 3's hierarchy (its ELL forms) from here.
    md_dir = tempfile.mkdtemp(prefix="chip_smoke_md_")
    md_problem = (cfg, os.path.join(md_dir, "hierarchy.npz"), h_greedy)
    t0 = time.perf_counter()
    gt.save_solver(md_problem[1], h)
    print(f"[17] phase 3's hierarchy saved for the ranks in "
          f"{time.perf_counter() - t0:.1f} s")
    del h, graph, h_greedy
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    from gravomg_tpu_torch.ops.mxu_cuda import (bucket_plan, mxu_matvec_cuda,
                                                mxu_matvec_plain)
    cfg, hm, a0_vpu, report["mxu_setup"], graph, op = phase_mxu_setup(torch)
    report["mxu_check"] = _check_buckets(
        torch, _slabs(hm, mxu=True),
        lambda b, x, xp: mxu_matvec_cuda(b, x, xp, bucket_plan(b)),
        mxu_matvec_plain, "9", "the transposed-tile kernel")
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
    report["lobpcg"] = phase_lobpcg(torch, "cuda", N_LOBPCG)
    report["rhs_c5"] = phase_rhs_batch(torch, "cuda", C5_N, C5_D)
    torch.cuda.empty_cache()
    report["meshes"] = phase_meshes(torch, "cuda", C5B_MESHES, C5B_N)
    torch.cuda.empty_cache()
    try:
        report["multidevice"] = phase_multidevice(torch, "cuda", N, MD_RANKS,
                                                  md_problem)
    finally:
        shutil.rmtree(md_dir, ignore_errors=True)
    del md_problem
    torch.cuda.empty_cache()
    report["drivers"] = phase_drivers(torch, "cuda", N, report["main"])
    report["configs"] = phase_configs(torch, "cuda")
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
    b32 = report["rhs_1m"]["D64 float32"]
    lob = report["lobpcg"]
    e32 = lob[f"D{lob['k']} float32"]
    g1m = report["gather"]["P1_1000000"]
    u32 = report["uniform"]["forms"][report["uniform"]["timed"]]
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
    }, {
        "name": "blockdense_matmat",
        "case": "D=64, 1M level-0 A (phase 15 b)",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/blockdense_matmat.cu",
        "replaces": "gravomg_tpu/ops/pallas_blockdense.py:64 under jax.vmap "
                    "(scripts/bench_configs.py:261-264)",
        "launches": report["rhs_1m"]["launches"],
        "max_abs_err": report["rhs_1m"]["check"]["worst_abs"],
        "ms": min(b32["kernel_ms"]),
        "plain_ms": min(b32["plain_ms"]),
        "bound_ms": b32["bound_ms"],
        "bound_by": b32["bound_by"],
        "library_ms": b32["library_ms"],
    }, {
        "name": "blockdense_matmat",
        "case": f"D={lob['k']}, 100k level-0 A, laplace_eigs (phase 14)",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/blockdense_matmat.cu",
        "replaces": "gravomg_tpu/ops/pallas_blockdense.py:64 under jax.vmap "
                    "(scripts/bench_configs.py:261-264)",
        "launches": lob["b1_launches"],
        "max_abs_err": lob["check"]["worst_abs"],
        "ms": min(e32["kernel_ms"]),
        "plain_ms": min(e32["plain_ms"]),
        "bound_ms": e32["bound_ms"],
        "bound_by": e32["bound_by"],
        "library_ms": e32["library_ms"],
    }, {
        "name": "uniform_matvec",
        "route": "cuda",
        "source": "gravomg_tpu_torch/csrc/uniform_matvec.cu",
        # No TPU kernel: the JAX package runs uniform forms through XLA.
        "replaces": "none (XLA: gravomg_tpu/ops/blockdense.py:285)",
        "launches": report["uniform"]["launches"],
        "max_abs_err": report["uniform"]["worst_abs"],
        "ms": u32["per_call_ms"],
        "plain_ms": u32["plain_ms"],
        "bound_ms": u32["bound_ms"],
        "bound_by": u32["bound_by"],
        "library_ms": u32["library_ms"],
    }]}
    _check_shares(kernels["kernels"], report)
    print(f"[done] {report['total_s']:.1f} s")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
