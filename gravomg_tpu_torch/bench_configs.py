"""The config sweep (counterpart of ``scripts/bench_configs.py``): the six
deployments the package was built for, run through the port's entry
points on the card at the script's sizes.

    python -m gravomg_tpu_torch.bench_configs [c1 ...] [--out PATH]
                                              [--smoke] [--device DEV]

  c1   c1_sphere5k   5,000 of icosphere(5)'s 10,242 vertices, k=12,
                     2 levels, Jacobi: MG-PCG to 1e-8
                     (scripts/bench_configs.py:193-205)
  c2   c2_mesh35k    35,000-point torus, k=14, 3 levels, Chebyshev:
                     8 chained V-cycles from zero, then MG-PCG (:208-228)
  c3   c3_heat170k   170,000-point torus, k=16: heat_geodesics from
                     vertex 0, two MG-PCG solves on the reused hierarchy
                     (:231-247)
  c5   c5_batch64    20,000-point torus, k=12: one (V, 64) V-cycle (B1 on
                     the slab forms) against 64 1-D cycles (K1) (:250-283)
  c5b  c5b_meshes64  64 scaled tori of 5,000 points, k=12, 3 levels:
                     one stacked V-cycle against the per-mesh loop
                     (:286-356)
  c6   c6_spectral   100,000-point torus, k=12, alpha = spectral_alpha:
                     laplace_eigs, 12 eigenpairs, 40 iterations, tol 1e-5
                     (:359-387)

Each recipe (``c1_inputs`` ... ``c6_inputs``) draws the script's inputs
in the script's order; :func:`pipeline` is the script's (``:126-190``):
Morton order, grid kNN (margin 2.4), the screened-Poisson operator,
``build_hierarchy_device`` (random priorities from a generator seeded
``BUILD_SEED``), and slab plus uniform forms where the script attaches
them.  It leaves out the script's TPU scaffolding: the warm rebuild, the
cap escalation, the overflow check and ``compact_solver`` (the port's
levels hold real rows only).  ``levels`` lists the row counts below the
finest level, as the script's rows do; the random-priority build makes
them differ from the TPU's rows and from run to run of another device.

Times: one warm-up call, then the median of ``REPS`` calls on the
synchronised host clock under the script's key (``solve_s`` ...); beside
it on the card the median between CUDA events (``<key>_device_s``), the
device's busy share (the time of the device operations torch.profiler
saw in one more call, over the host median: ``<key>_busy_share``), and
the launches of K1 and B1 in one call (``<key>_k1_launches``,
``<key>_b1_launches``: the warm-up call, the same work as each timed
one).  ``peak_bytes`` is the config's peak device memory above what the
process held before it.  None where a number was not measured (the
device numbers on the CPU).

stdout: a header line (the card's name and power limit as nvidia-smi
gives them), one JSON line per config, a footer; ``--out PATH`` writes
the same lines to PATH.  ``--smoke`` is the script's GRAVOMG_SMOKE rule:
every size max(2,000, n / 20), 8 meshes for c5b.  Nothing falls back:
without a card and without ``--device`` the run raises; a config that
fails one of its checks (below) or raises ends the run with a nonzero
exit code.  Checks on each config's own result: c1, c2 relative residual
<= 1e-8 and, on the card, K1 launched in the solve; c3 phi finite; c5
each column of the (V, 64) cycle within ``TOL_COLUMNS`` of its 1-D cycle
and, on the card, B1 launched in it; c5b each mesh's real rows within
``TOL_COLUMNS`` of its own cycle, its padded rows 0; c6 max_resnorm <=
``C6_TARGET`` (``VERDICT.md:203``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional, Sequence, TextIO

import numpy as np
import torch

from gravomg_tpu_torch.apps.heat import heat_geodesics
from gravomg_tpu_torch.apps.poisson import screened_poisson_operator
from gravomg_tpu_torch.apps.spectral import laplace_eigs
from gravomg_tpu_torch.bench import card_name
from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu_torch.geometry.meshes import icosphere, torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.hierarchy import build_hierarchy_device
from gravomg_tpu_torch.ops.blockdense_cuda import (LIBRARY, MATMAT_LIBRARY,
                                                   blockdense_matmat_cuda,
                                                   blockdense_matvec_cuda)
from gravomg_tpu_torch.ops.uniform_cuda import LIBRARY as UNIFORM_LIBRARY
from gravomg_tpu_torch.parallel.batch import (attach_collection,
                                              batched_v_cycle, stack_solvers)
from gravomg_tpu_torch.solve.cg import mg_pcg
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy,
                                            attach_fast_operators,
                                            attach_slab_operators, v_cycle)
from gravomg_tpu_torch.types import EllOperator, Graph
from gravomg_tpu_torch.utils.device import resolve_device
from gravomg_tpu_torch.utils.profiling import synchronize

BUILD_SEED = 0              # the generator of build_hierarchy_device
KNN_MARGIN = 2.4            # grid kNN cell margin, as the script's
REPS = 5                    # timed calls after the warm-up, median of
TOL_COLUMNS = 1e-5          # a batched cycle against its own cycles
C6_TARGET = 1e-2            # c6's max_resnorm target (VERDICT.md:203)
C5_RHS = 64                 # right-hand sides of c5
C5B_MESHES = 64             # meshes of c5b (8 with --smoke)
C6_K = 12                   # eigenpairs of c6


def smoke_size(n: int) -> int:
    """The script's GRAVOMG_SMOKE size for a config of ``n`` points."""
    return max(2000, n // 20)


# ---------------------------------------------------------------------------
# The recipes' inputs
# ---------------------------------------------------------------------------


class Recipe(NamedTuple):
    """A config's inputs as the script draws them: ``points`` before the
    pipeline's Morton order (for c5b a list, one array a mesh), the kNN
    ``k``, the config, and the right-hand sides (f32, in the port's
    layout: (V,) or (V, D); None where the script draws none or, for
    c5b, draws them over the stacked rows: :func:`c5b_rhs`)."""
    points: object
    k: int
    cfg: MultigridConfig
    rhs: Optional[np.ndarray]


def c1_inputs(n: Optional[int] = None) -> Recipe:
    """``:193-205``: ``n`` (5,000) vertices of ``icosphere(5)`` chosen by
    ``default_rng(0)``, then b = N(0, 1) from the same generator, drawn
    after the choice."""
    sv, _ = icosphere(5)
    rng = np.random.default_rng(0)
    pts = sv[rng.choice(len(sv), n or 5000, replace=False)]
    cfg = MultigridConfig(coarse_threshold=800, smoother="jacobi",
                          max_levels=2)
    b = rng.normal(size=pts.shape[0]).astype(np.float32)
    return Recipe(pts, 12, cfg, b)


def c2_inputs(n: Optional[int] = None) -> Recipe:
    """``:208-228``: torus seed 2, b = N(0, 1) from ``default_rng(1)``."""
    pts = torus_points(n or 35_000, seed=2)
    cfg = MultigridConfig(coarse_threshold=600, smoother="chebyshev",
                          max_levels=3)
    b = np.random.default_rng(1).normal(size=pts.shape[0])
    return Recipe(pts, 14, cfg, b.astype(np.float32))


def c3_inputs(n: Optional[int] = None) -> Recipe:
    """``:231-247``: torus seed 3."""
    return Recipe(torus_points(n or 170_000, seed=3), 16,
                  MultigridConfig(coarse_threshold=1000,
                                  smoother="chebyshev"), None)


def c5_inputs(n: Optional[int] = None, d: int = C5_RHS) -> Recipe:
    """``:250-283``: torus seed 4; ``d`` right-hand sides N(0, 1) from
    ``default_rng(2)``, drawn (d, V) as the script draws them and laid
    out (V, d)."""
    pts = torus_points(n or 20_000, seed=4)
    cfg = MultigridConfig(coarse_threshold=600, smoother="chebyshev")
    rhs = np.random.default_rng(2).normal(size=(d, pts.shape[0]))
    return Recipe(pts, 12, cfg, np.ascontiguousarray(
        rhs.astype(np.float32).T))


def c5b_inputs(n: Optional[int] = None,
               meshes: int = C5B_MESHES) -> Recipe:
    """``:286-356``: ``meshes`` tori of ``n`` (5,000) points, seed 200 + i,
    each scaled by 1 + 0.25 * ``default_rng(5).random(3)`` in loop
    order."""
    rng = np.random.default_rng(5)
    pts = [torus_points(n or 5000, seed=200 + i) * (1.0 + 0.25 * rng.random(3))
           for i in range(meshes)]
    return Recipe(pts, 12, MultigridConfig(coarse_threshold=400,
                                           smoother="chebyshev",
                                           max_levels=3), None)


def c5b_rhs(real_rows: Sequence[int], padded_rows: int) -> np.ndarray:
    """c5b's right-hand sides, (meshes, padded_rows) f32: N(0, 1) from
    ``default_rng(3)`` drawn over the stacked level-0 rows (the script
    draws over its own padded count, which the port's padding to the
    largest mesh does not share), zero on each mesh's padded rows."""
    draws = np.random.default_rng(3).normal(size=(len(real_rows),
                                                  padded_rows))
    out = np.zeros(draws.shape, np.float32)
    for i, r in enumerate(real_rows):
        out[i, :r] = draws[i, :r]
    return out


def c6_inputs(n: Optional[int] = None) -> Recipe:
    """``:359-387``: torus seed 6 (alpha = ``spectral_alpha``)."""
    return Recipe(torus_points(n or 100_000, seed=6), 12,
                  MultigridConfig(coarse_threshold=800,
                                  smoother="chebyshev"), None)


# ---------------------------------------------------------------------------
# The pipeline
# ---------------------------------------------------------------------------


class Built(NamedTuple):
    """What :func:`pipeline` returns."""
    graph: Graph
    op: EllOperator
    h: SolverHierarchy
    t_build_s: float
    levels: List[int]


def front_end(pts: np.ndarray, k: int, alpha="auto", device=None):
    """(graph, operator): ``pts`` in Morton order as f32, grid kNN
    (``KNN_MARGIN``; raises on a shortfall), the screened-Poisson
    operator with ``alpha`` ("auto", "spectral" as c6's, or a number)."""
    dev = resolve_device(device)
    pts = pts[morton_order(pts)].astype(np.float32)
    graph = grid_knn_graph_nosync(pts, k, margin=KNN_MARGIN, device=dev)
    op, _ = screened_poisson_operator(graph, alpha=alpha)
    return graph, op


def pipeline(pts: np.ndarray, k: int, cfg: MultigridConfig,
             attach: bool = True, alpha="auto", device=None,
             generator: Optional[torch.Generator] = None) -> Built:
    """The script's pipeline on ``device`` (the card unless the caller
    names another): :func:`front_end`, then one ``build_hierarchy_device``
    (random priorities from ``generator``, by default one on the device
    seeded ``BUILD_SEED``), timed on the synchronised host clock, then
    with ``attach`` the slab forms and uniform forms on the rest."""
    dev = resolve_device(device)
    graph, op = front_end(pts, k, alpha, dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(BUILD_SEED)
    synchronize(dev)
    t0 = time.perf_counter()
    h, _ = build_hierarchy_device(graph, op, cfg, generator=generator)
    synchronize(dev)
    t_build = time.perf_counter() - t0
    solver = h.solver
    if attach:
        solver = attach_fast_operators(attach_slab_operators(solver))
    return Built(graph, op, solver, t_build,
                 [lvl.op.num_vertices for lvl in solver.levels[1:]])


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def device_seconds(fn: Callable) -> Optional[float]:
    """Seconds of the device operations (kernels, copies, sets) of one
    call of ``fn``, as torch.profiler saw them; None if it saw none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(us) / 1e6 if us else None


def timed(key: str, fn: Callable, dev: torch.device):
    """(row fields, result of the last call) of ``fn`` timed under
    ``key`` (a key of the script's rows, ending in ``_s``): see the
    module's docstring."""
    base = key[:-2]
    k1, b1 = blockdense_matvec_cuda.launches, blockdense_matmat_cuda.launches
    out = fn()
    synchronize(dev)
    fields = {f"{base}_k1_launches": blockdense_matvec_cuda.launches - k1,
              f"{base}_b1_launches": blockdense_matmat_cuda.launches - b1}
    on_card = dev.type == "cuda"
    host, device = [], []
    for _ in range(REPS):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        host.append(time.perf_counter() - t0)
        if on_card:
            end.record()
            end.synchronize()
            device.append(start.elapsed_time(end) / 1e3)
    med = statistics.median(host)
    busy = device_seconds(fn) if on_card else None
    fields.update({key: med, f"{base}_runs_s": host,
                   f"{base}_device_s": (statistics.median(device)
                                        if on_card else None),
                   f"{base}_busy_share": (None if busy is None
                                          else busy / med)})
    return fields, out


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _row(name: str, dev: torch.device, **fields) -> dict:
    return {"config": name, "device": str(dev), **fields}


class _Peak:
    """Peak device memory of a config above what the process held when
    it began; None off the card."""

    def __init__(self, dev: torch.device):
        self.on_card = dev.type == "cuda"
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
            self.held = torch.cuda.memory_allocated()

    def bytes(self) -> Optional[int]:
        if not self.on_card:
            return None
        return torch.cuda.max_memory_allocated() - self.held


def worst_column(x: torch.Tensor, cols: Sequence[torch.Tensor]) -> float:
    """Largest max|x[:, j] - cols[j]| / max|cols[j]| over the columns."""
    return max(float((x[:, j] - c).abs().max())
               / max(float(c.abs().max()), 1e-30)
               for j, c in enumerate(cols))


def collection_check(hs: Sequence[SolverHierarchy], xs: torch.Tensor,
                     bs: torch.Tensor, cfg: MultigridConfig):
    """(largest max|xs[i, :r_i] - x_i| / max|x_i| over the meshes, where
    x_i is the V-cycle of mesh i's own hierarchy ``hs[i]`` (r_i rows) on
    bs[i, :r_i]; whether every padded row of ``xs`` is exactly 0)."""
    worst, padded_zero = 0.0, True
    for i, h in enumerate(hs):
        r = h.levels[0].op.num_vertices
        b = bs[i, :r]
        x1 = v_cycle(h, torch.zeros_like(b), b, cfg)
        worst = max(worst, float((xs[i, :r] - x1).abs().max())
                    / max(float(x1.abs().max()), 1e-30))
        padded_zero = padded_zero and not bool(xs[i, r:].any())
    return worst, padded_zero


# ---------------------------------------------------------------------------
# The six configs
# ---------------------------------------------------------------------------


def c1_sphere5k(device=None, n: Optional[int] = None) -> dict:
    """c1: MG-PCG to 1e-8 on the 2-level Jacobi hierarchy."""
    dev = resolve_device(device)
    peak = _Peak(dev)
    rec = c1_inputs(n)
    p = pipeline(rec.points, rec.k, rec.cfg, device=dev)
    b = torch.as_tensor(rec.rhs, device=dev)
    t, (x, rel, it) = timed("solve_s", lambda: mg_pcg(p.h, b, rec.cfg), dev)
    row = _row("c1_sphere5k", dev, n=len(b), levels=p.levels,
               t_build_s=p.t_build_s, **t, rel_residual=rel, iters=it,
               peak_bytes=peak.bytes())
    _check(rel <= rec.cfg.tolerance and bool(torch.isfinite(x).all()),
           f"c1 relative residual {rel} after {it} iterations")
    _check(dev.type != "cuda" or t["solve_k1_launches"] > 0,
           "c1's solve never launched K1")
    return row


def c2_mesh35k(device=None, n: Optional[int] = None) -> dict:
    """c2: 8 chained V-cycles from zero, then MG-PCG to 1e-8."""
    dev = resolve_device(device)
    peak = _Peak(dev)
    rec = c2_inputs(n)
    p = pipeline(rec.points, rec.k, rec.cfg, device=dev)
    b = torch.as_tensor(rec.rhs, device=dev)

    def cycles8():
        x = torch.zeros_like(b)
        for _ in range(8):
            x = v_cycle(p.h, x, b, rec.cfg)
        return x

    t8, _ = timed("vcycle8_s", cycles8, dev)
    tp, (x, rel, it) = timed("pcg_solve_s",
                             lambda: mg_pcg(p.h, b, rec.cfg), dev)
    row = _row("c2_mesh35k", dev, n=len(b), levels=p.levels,
               t_build_s=p.t_build_s, **t8, **tp, rel_residual=rel,
               iters=it, peak_bytes=peak.bytes())
    _check(rel <= rec.cfg.tolerance and bool(torch.isfinite(x).all()),
           f"c2 relative residual {rel} after {it} iterations")
    _check(dev.type != "cuda" or tp["pcg_solve_k1_launches"] > 0,
           "c2's solve never launched K1")
    return row


def c3_heat170k(device=None, n: Optional[int] = None) -> dict:
    """c3: ``heat_geodesics`` from vertex 0 on the hierarchy without fast
    forms (its refit drops slab forms, as the script's does)."""
    dev = resolve_device(device)
    peak = _Peak(dev)
    rec = c3_inputs(n)
    p = pipeline(rec.points, rec.k, rec.cfg, attach=False, device=dev)
    heat = {}
    t, phi = timed("two_solve_heat_s", lambda: heat_geodesics(
        p.graph, p.h, source=0, cfg=rec.cfg, record=heat), dev)
    finite = bool(torch.isfinite(phi).all())
    row = _row("c3_heat170k", dev, n=p.graph.num_vertices, levels=p.levels,
               t_build_s=p.t_build_s, **t, finite=finite,
               heat_iters=heat["heat_iters"], heat_rel=heat["heat_rel"],
               poisson_iters=heat["poisson_iters"],
               poisson_rel=heat["poisson_rel"], peak_bytes=peak.bytes())
    _check(finite, "c3's phi is not finite")
    return row


def c5_batch64(device=None, n: Optional[int] = None) -> dict:
    """c5: one (V, 64) V-cycle from zero against the 64 1-D cycles of its
    columns, on one hierarchy with slab forms."""
    dev = resolve_device(device)
    peak = _Peak(dev)
    rec = c5_inputs(n)
    p = pipeline(rec.points, rec.k, rec.cfg, device=dev)
    bs = torch.as_tensor(rec.rhs, device=dev)
    cols = [bs[:, j].contiguous() for j in range(bs.shape[1])]
    tb, x = timed("batch64_vcycle_s", lambda: v_cycle(
        p.h, torch.zeros_like(bs), bs, rec.cfg), dev)
    ts, xs = timed("sequential64_vcycle_s", lambda: [
        v_cycle(p.h, torch.zeros_like(c), c, rec.cfg) for c in cols], dev)
    worst = worst_column(x, xs)
    t_b, t_s = tb["batch64_vcycle_s"], ts["sequential64_vcycle_s"]
    row = _row("c5_batch64", dev, n=bs.shape[0], batch=bs.shape[1],
               levels=p.levels, t_build_s=p.t_build_s, **tb, **ts,
               batch_speedup=t_s / t_b, per_rhs_ms=t_b / bs.shape[1] * 1e3,
               worst_column_rel=worst, peak_bytes=peak.bytes())
    _check(bool(torch.isfinite(x).all()) and worst <= TOL_COLUMNS,
           f"c5's columns against their 1-D cycles: {worst:.3e} > "
           f"{TOL_COLUMNS}")
    _check(dev.type != "cuda" or tb["batch64_vcycle_b1_launches"] > 0,
           "c5's (V, 64) cycle never launched B1")
    return row


def c5b_meshes64(device=None, n: Optional[int] = None,
                 meshes: int = C5B_MESHES) -> dict:
    """c5b: every mesh's hierarchy built (generator seeded i for mesh i),
    ``attach_collection``, ``stack_solvers``, one ``batched_v_cycle``
    against the per-mesh loop of 1-D cycles on the same padded
    hierarchies."""
    dev = resolve_device(device)
    peak = _Peak(dev)
    rec = c5b_inputs(n, meshes)
    hs, t_build = [], 0.0
    for i, pts in enumerate(rec.points):
        p = pipeline(pts, rec.k, rec.cfg, attach=False, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(i))
        t_build += p.t_build_s
        hs.append(p.h)
    real = [[lvl.op.num_vertices for lvl in h.levels] for h in hs]
    fast = attach_collection(hs)
    hb = stack_solvers(fast)
    rows = [lvl.op.num_vertices for lvl in hb.levels]
    bs = torch.as_tensor(c5b_rhs([r[0] for r in real], rows[0]), device=dev)
    tb, xs = timed("batched_vcycle_s", lambda: batched_v_cycle(
        hb, torch.zeros_like(bs), bs, rec.cfg), dev)
    tl, _ = timed("permesh_loop_s", lambda: [
        v_cycle(f, torch.zeros_like(bs[i]), bs[i], rec.cfg)
        for i, f in enumerate(fast)], dev)
    worst, padded_zero = collection_check(hs, xs, bs, rec.cfg)
    t_b, t_l = tb["batched_vcycle_s"], tl["permesh_loop_s"]
    row = _row("c5b_meshes64", dev, n=len(rec.points[0]), meshes=meshes,
               stacked=len(fast), padded_rows=rows,
               real_rows_min=[min(c) for c in zip(*real)],
               real_rows_max=[max(c) for c in zip(*real)],
               t_build_all_s=t_build, **tb, **tl,
               batch_speedup=t_l / t_b, per_mesh_ms=t_b / meshes * 1e3,
               worst_mesh_rel=worst, padded_rows_zero=padded_zero,
               peak_bytes=peak.bytes())
    _check(bool(torch.isfinite(xs).all()) and padded_zero
           and worst <= TOL_COLUMNS,
           f"c5b: padded rows zero {padded_zero}, meshes against their "
           f"own cycles {worst:.3e} > {TOL_COLUMNS}")
    return row


def c6_spectral(device=None, n: Optional[int] = None) -> dict:
    """c6: ``laplace_eigs`` (k=12, 40 iterations, tol 1e-5) on the
    hierarchy of L + spectral_alpha M, without fast forms."""
    dev = resolve_device(device)
    peak = _Peak(dev)
    rec = c6_inputs(n)
    p = pipeline(rec.points, rec.k, rec.cfg, attach=False,
                 alpha="spectral", device=dev)
    eig = {}
    t, (lams, vecs, res) = timed("eigs_total_s", lambda: laplace_eigs(
        p.graph, k=C6_K, cfg=rec.cfg, h=p.h, iters=40, tol=1e-5,
        record=eig), dev)
    lam = lams.double().cpu().numpy()
    max_res = float(res.max())
    row = _row("c6_spectral", dev, n=p.graph.num_vertices, k=C6_K,
               levels=p.levels, t_build_s=p.t_build_s, **t,
               iters=eig["iters"], max_resnorm=max_res, lam_1=float(lam[1]),
               lam_k=float(lam[-1]), nullspace_lam=float(lam[0]),
               peak_bytes=peak.bytes())
    _check(bool(np.isfinite(lam).all()) and max_res <= C6_TARGET,
           f"c6 max_resnorm {max_res} > {C6_TARGET}")
    return row


ALL = {"c1": c1_sphere5k, "c2": c2_mesh35k, "c3": c3_heat170k,
       "c5": c5_batch64, "c5b": c5b_meshes64, "c6": c6_spectral}
SIZES = {"c1": 5000, "c2": 35_000, "c3": 170_000, "c5": 20_000,
         "c5b": 5000, "c6": 100_000}


def warm_up(dev: torch.device) -> None:
    """On the card, K1, B1 and the uniform kernel built (nvcc, all
    started together) and loaded; then one small pipeline and cycle on
    ``dev``, so that no config's build time holds the set-up of the
    context or a library."""
    if dev.type == "cuda":
        libs = (LIBRARY, MATMAT_LIBRARY, UNIFORM_LIBRARY)
        with ThreadPoolExecutor(len(libs)) as pool:
            for f in [pool.submit(lib.load) for lib in libs]:
                f.result()
    rec = c2_inputs(2000)
    p = pipeline(rec.points, rec.k, rec.cfg, device=dev)
    b = torch.as_tensor(rec.rhs, device=dev)
    mg_pcg(p.h, b, rec.cfg)
    synchronize(dev)


def run(names: Sequence[str], device=None, smoke: bool = False,
        out: Optional[TextIO] = None) -> List[dict]:
    """The configs ``names`` on ``device`` (the card unless the caller
    names another) between a header and a footer row, each printed as a
    JSON line as it is made (and written to ``out``); raises on the first
    failure."""
    dev = resolve_device(device)
    t0 = time.monotonic()
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    emit({"config": "header", "device": str(dev),
          "card": card_name() if dev.type == "cuda" else None,
          "when": time.strftime("%Y-%m-%d %H:%M:%S"), "smoke": smoke,
          "build_seed": BUILD_SEED, "reps": REPS})
    warm_up(dev)
    for name in names:
        kw = {"n": smoke_size(SIZES[name]) if smoke else None}
        if name == "c5b" and smoke:
            kw["meshes"] = 8
        emit(ALL[name](dev, **kw))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit({"config": "footer", "wall_s": time.monotonic() - t0})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*",
                    help=f"configs to run, of {' '.join(ALL)} (default all)")
    ap.add_argument("--out", help="write the JSON lines here too")
    ap.add_argument("--smoke", action="store_true",
                    help="sizes max(2000, n/20), 8 meshes for c5b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    unknown = [c for c in args.configs if c not in ALL]
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {list(ALL)}")
    names = args.configs or list(ALL)
    if args.out:
        with open(args.out, "w") as out:
            run(names, args.device, args.smoke, out)
    else:
        run(names, args.device, args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
