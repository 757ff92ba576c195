"""The port's benchmark (counterpart of ``bench.py``): the V-cycle time
of the screened-Poisson main path at N points on the card, against a
SciPy CPU V-cycle on the same hierarchy.

    python -m gravomg_tpu_torch.bench [--n N] [--out PATH] [--device DEV]

N is 1,000,000 by default.  The pipeline is bench.py's, through
``probes/mxu_levels.py::bench_hierarchy``: a Morton-ordered torus (seed
1), grid kNN (k=16, margin 2.4), the screened-Poisson operator with
alpha="auto", ``MultigridConfig(coarse_threshold=1000,
smoother="chebyshev")``, the hierarchy built on the device by
``build_hierarchy_device`` (sampling priorities from a generator seeded
``BUILD_SEED``), then ``attach_slab_operators`` and
``attach_fast_operators``.  b = N(0, 1) from seed 0 in f32.

Measured (CUDA events on the card, the synchronised host clock on the
CPU; every timing after a warm-up run): chains of 2, 12 and 32 cycles
from x = 0, best of 5 each; the per-cycle slope of a line through them
and its r^2 (the headline ``value``); the median of 10 single cycles;
the relative residual after 12 cycles; ``mg_pcg`` and ``mg_solve`` to
1e-8 (iterations, residual, best seconds of two runs; ``mg_solve`` takes
bf16-preconditioned flexible CG at or above ``cfg.bf16_threshold``
rows); K1's launches in one cycle against that cycle's slab matvecs
(equal on the card); the level sizes and (rows, max degree) per level.

The CPU baseline is bench.py's: the same hierarchy copied to SciPy CSR
in f64 (:func:`scipy_hierarchy`), a V-cycle with the same Chebyshev
smoother on each level's own bounds and a Cholesky factor of the
symmetrised coarsest operator (:func:`scipy_vcycle`), one warm-up cycle
and 20 timed: ``cpu_vcycle_ms``, and ``vs_baseline = cpu_vcycle_ms /
value``.  ``cpu_build_s`` times the C++ coarsener's build
(``io/native.py::build_hierarchy``) on the same graph.

stdout is exactly one JSON line, ``{"metric": "vcycle_ms_<N>v",
"value": ms, "unit": "ms", "vs_baseline": x}``; stderr holds one ``#``
account line with the card's name and power limit; ``--out PATH``
writes the whole record as JSON.  A solve that misses 1e-8, a launch
count that differs from the slab matvecs, or any other failure raises
and the process exits nonzero with no line on stdout.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from typing import List, NamedTuple, Tuple

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.io import native
from gravomg_tpu_torch.ops.blockdense_cuda import blockdense_matvec_cuda
from gravomg_tpu_torch.probes.mxu_levels import BUILD_SEED, bench_hierarchy
from gravomg_tpu_torch.solve import vcycle as vc
from gravomg_tpu_torch.solve.cg import mg_pcg, mg_solve
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.types import INVALID_INDEX
from gravomg_tpu_torch.utils.device import resolve_device
from gravomg_tpu_torch.utils.stage import synchronize

DEFAULT_N = 1_000_000
CHAINS = (2, 12, 32)        # cycles per timed chain (bench.py's N1, N2, N3)
CHAIN_REPS = 5              # best of, per chain
SINGLE_REPS = 10            # median of, single cycles
BASELINE_CYCLES = 20
COARSE_SHIFTS = (1e-10, 1e-6, 1e-4)   # of max|diag|, tried in turn


# ---------------------------------------------------------------------------
# The SciPy CPU baseline
# ---------------------------------------------------------------------------


class ScipyHierarchy(NamedTuple):
    """A solver hierarchy in SciPy CSR, f64: A and 1/diag(A) per level,
    U and the Chebyshev interval per level but the coarsest, and the
    coarsest level's Cholesky factor (``scipy.linalg.cho_factor``)."""
    a: List[sp.csr_matrix]
    dinv: List[np.ndarray]
    u: List[sp.csr_matrix]
    cheb: List[Tuple[float, float]]
    chol: tuple
    shift: float


def _ell_to_csr(nbr: np.ndarray, off: np.ndarray,
                diag: np.ndarray) -> sp.csr_matrix:
    v, k = nbr.shape
    mask = (nbr != INVALID_INDEX).ravel()
    rows = np.repeat(np.arange(v), k)[mask]
    m = sp.csr_matrix((off.ravel()[mask].astype(np.float64),
                       (rows, nbr.ravel()[mask])), shape=(v, v))
    return (m + sp.diags(diag.astype(np.float64))).tocsr()


def _u_to_csr(cols: np.ndarray, w: np.ndarray,
              n_coarse: int) -> sp.csr_matrix:
    vf, k = cols.shape
    rows = np.repeat(np.arange(vf), k)
    return sp.csr_matrix((w.ravel().astype(np.float64),
                          (rows, cols.ravel())), shape=(vf, n_coarse))


def _coarse_factor(a: sp.csr_matrix):
    """(cho_factor of the symmetrised coarsest operator plus the first
    shift of ``COARSE_SHIFTS`` x max|diag| that makes it positive
    definite, that shift).  Deep f32 Galerkin chains leave the coarsest
    operator asymmetric and indefinite in its last digits."""
    ac = a.toarray()
    ac = 0.5 * (ac + ac.T)
    base = np.abs(np.diag(ac)).max()
    for s in COARSE_SHIFTS:
        try:
            return sla.cho_factor(ac + s * base * np.eye(ac.shape[0])), s
        except np.linalg.LinAlgError:
            continue
    raise RuntimeError(f"no shift in {COARSE_SHIFTS} makes the "
                       f"{ac.shape[0]}-row coarsest operator factorisable")


def scipy_hierarchy(h: vc.SolverHierarchy) -> ScipyHierarchy:
    """``h``'s ELL operators, prolongations and Chebyshev intervals,
    copied to the host as SciPy CSR in f64."""
    a, u, cheb = [], [], []
    for lvl in h.levels:
        op = lvl.op
        a.append(_ell_to_csr(op.neighbors.cpu().numpy(),
                             op.offdiag.cpu().numpy(), op.diag.cpu().numpy()))
        if lvl.u is not None:
            u.append(_u_to_csr(lvl.u.cols.cpu().numpy(),
                               lvl.u.weights.cpu().numpy(), lvl.u.n_coarse))
            cheb.append((float(lvl.cheb.lam_min), float(lvl.cheb.lam_max)))
    chol, shift = _coarse_factor(a[-1])
    return ScipyHierarchy(a=a, dinv=[1.0 / m.diagonal() for m in a], u=u,
                          cheb=cheb, chol=chol, shift=shift)


def _smooth(sh: ScipyHierarchy, li: int, x, b, degree: int):
    """Chebyshev of ``degree`` on D^{-1} A over level li's interval."""
    a, dinv = sh.a[li], sh.dinv[li]
    lo, hi = sh.cheb[li]
    theta, delta = 0.5 * (hi + lo), 0.5 * (hi - lo)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = dinv * (b - a @ x) / theta
    x = x + d
    for _ in range(degree - 1):
        r = dinv * (b - a @ x)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        x = x + d
        rho = rho_new
    return x


def scipy_vcycle(sh: ScipyHierarchy, cfg: MultigridConfig, x: np.ndarray,
                 b: np.ndarray, li: int = 0) -> np.ndarray:
    """One V-cycle from level ``li`` (Chebyshev smoothing only)."""
    if li == len(sh.a) - 1:
        return sla.cho_solve(sh.chol, b)
    u = sh.u[li]
    x = _smooth(sh, li, x, b, cfg.chebyshev_degree)
    r = b - sh.a[li] @ x
    e = scipy_vcycle(sh, cfg, np.zeros(u.shape[1]), u.T @ r, li + 1)
    return _smooth(sh, li, x + u @ e, b, cfg.chebyshev_degree)


def cpu_baseline(sh: ScipyHierarchy, cfg: MultigridConfig) -> dict:
    """Milliseconds per SciPy V-cycle: one warm-up cycle, then
    ``BASELINE_CYCLES`` chained ones on b = N(0, 1) from seed 0 (f64)."""
    n = sh.a[0].shape[0]
    b = np.random.default_rng(0).standard_normal(n)
    x = scipy_vcycle(sh, cfg, np.zeros(n), b)
    t0 = time.perf_counter()
    for _ in range(BASELINE_CYCLES):
        x = scipy_vcycle(sh, cfg, x, b)
    ms = (time.perf_counter() - t0) / BASELINE_CYCLES * 1e3
    rel = float(np.linalg.norm(b - sh.a[0] @ x) / np.linalg.norm(b))
    return {"cpu_vcycle_ms": ms, "baseline_n": n,
            "baseline_cycles": BASELINE_CYCLES,
            "baseline_residual": rel, "coarse_shift": sh.shift}


# ---------------------------------------------------------------------------
# The device measurement
# ---------------------------------------------------------------------------


def _times_ms(fn, dev: torch.device, reps: int) -> List[float]:
    """Milliseconds of ``reps`` runs of ``fn`` after one warm-up run:
    CUDA events on the card, the synchronised host clock elsewhere."""
    fn()
    synchronize(dev)
    out = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def cycle_account(h: vc.SolverHierarchy, b: torch.Tensor,
                  cfg: MultigridConfig) -> dict:
    """One V-cycle with its slab matvecs counted at the cycle's call of
    ``slab_matvec``, and K1's launches in it."""
    inner, seen = vc.slab_matvec, [0]

    def counted(op, x):
        seen[0] += 1
        return inner(op, x)

    before = blockdense_matvec_cuda.launches
    vc.slab_matvec = counted
    try:
        vc.v_cycle(h, torch.zeros_like(b), b, cfg)
        synchronize(b.device)
    finally:
        vc.slab_matvec = inner
    return {"slab_matvecs": seen[0],
            "k1_launches": blockdense_matvec_cuda.launches - before}


def _solve(solver, h, b, cfg) -> dict:
    """Two runs of ``solver`` to ``cfg.tolerance``: iterations, residual
    and the best seconds (synchronised host clock)."""
    secs = []
    for _ in range(2):
        synchronize(b.device)
        t0 = time.perf_counter()
        x, rel, it = solver(h, b, cfg)
        synchronize(b.device)
        secs.append(time.perf_counter() - t0)
    if not (rel <= cfg.tolerance and bool(torch.isfinite(x).all())):
        raise RuntimeError(f"{solver.__name__}: relative residual {rel} "
                           f"after {it} iterations, not <= {cfg.tolerance}")
    return {"iters": it, "rel": rel, "s": min(secs), "s_runs": secs}


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return out.splitlines()[0] if out else "nvidia-smi: no output"


def run(n: int, device=None) -> dict:
    """The whole measurement at ``n`` points on ``device`` (the card
    unless the caller names another); the record ``--out`` writes."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg, h, info, graph, op = bench_hierarchy(n, dev)
    t0 = time.perf_counter()
    h = vc.attach_slab_operators(h)
    synchronize(dev)
    slab_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = vc.attach_fast_operators(h)
    synchronize(dev)
    rec = {"n": n, "device": str(dev), "build_seed": BUILD_SEED,
           "timer": "cuda_events" if on_card else "host_clock",
           "front_s": info["front_s"], "build_s": info["hierarchy_s"],
           "slab_s": slab_s, "fast_s": time.perf_counter() - t0,
           "build_peak_bytes": info["build_peak_bytes"]}
    # The C++ coarsener builds from the same graph on the host.
    nbr, dst = graph.neighbors.cpu().numpy(), graph.distances.cpu().numpy()
    pts = graph.points.cpu().numpy().astype(np.float64)
    del graph, op, info
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    b = torch.as_tensor(np.random.default_rng(0).normal(size=n)
                        .astype(np.float32), device=dev)

    def chain(c):
        x = torch.zeros_like(b)
        for _ in range(c):
            x = vc.v_cycle(h, x, b, cfg)
        return x

    blockdense_matvec_cuda.launches = 0
    ts = [min(_times_ms(lambda c=c: chain(c), dev, CHAIN_REPS))
          for c in CHAINS]
    xs, ys = np.array(CHAINS, float), np.array(ts)
    slope, icept = np.polyfit(xs, ys, 1)
    ss_tot = float(((ys - ys.mean()) ** 2).sum())
    r2 = 1.0 - float(((ys - slope * xs - icept) ** 2).sum()) / max(ss_tot,
                                                                   1e-30)
    if not slope > 0:
        raise RuntimeError(f"chained cycles of {CHAINS} took {ts} ms: no "
                           f"positive per-cycle slope")
    single = _times_ms(lambda: vc.v_cycle(h, torch.zeros_like(b), b, cfg),
                       dev, SINGLE_REPS)
    x12 = chain(CHAINS[1])
    resid = float(torch.linalg.norm(b - spmv(h.levels[0].op, x12))
                  / torch.linalg.norm(b))
    rec.update(chain_cycles=list(CHAINS), chain_ms=ts, vcycle_ms=float(slope),
               slope_r2=r2, single_cycle_ms=float(np.median(single)),
               single_cycle_runs_ms=single, residual_12cycles=resid)
    rec["mg_pcg"] = _solve(mg_pcg, h, b, cfg)
    rec["mg_solve"] = _solve(mg_solve, h, b, cfg)
    lvl0 = h.levels[0]
    rec["mg_solve"]["path"] = (
        "bf16_fcg" if lvl0.op.num_vertices >= cfg.bf16_threshold
        and lvl0.banded is not None else "f32_pcg")
    rec["k1_launches_total"] = blockdense_matvec_cuda.launches
    rec["cycle"] = cyc = cycle_account(h, b, cfg)
    if on_card and cyc["k1_launches"] != cyc["slab_matvecs"]:
        raise RuntimeError(f"K1 launched {cyc['k1_launches']} times for "
                           f"{cyc['slab_matvecs']} slab matvecs in one cycle")
    rec["levels"] = [lvl.op.num_vertices for lvl in h.levels]
    rec["shapes"] = [(lvl.op.num_vertices, lvl.op.max_degree)
                     for lvl in h.levels]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if on_card else None

    # The baseline's host copy; the card's hierarchy is freed first.
    t0 = time.perf_counter()
    sh = scipy_hierarchy(h)
    rec["baseline_copy_s"] = time.perf_counter() - t0
    del h, b, x12
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    rec.update(cpu_baseline(sh, cfg))
    del sh
    t0 = time.perf_counter()
    native.build_hierarchy(nbr, dst, pts, reduction_ratio=cfg.reduction_ratio,
                           threshold=cfg.coarse_threshold)
    rec["cpu_build_s"] = time.perf_counter() - t0
    rec["card"] = card_name() if on_card else None
    rec["vs_baseline"] = rec["cpu_vcycle_ms"] / rec["vcycle_ms"]
    return rec


def headline(rec: dict) -> dict:
    """The one stdout line."""
    return {"metric": f"vcycle_ms_{rec['n']}v", "value": rec["vcycle_ms"],
            "unit": "ms", "vs_baseline": rec["vs_baseline"]}


def account(rec: dict) -> str:
    """The ``#`` line on stderr."""
    p, s, c = rec["mg_pcg"], rec["mg_solve"], rec["cycle"]
    ts = " ".join(f"T({k})={t:.4f}ms" for k, t in zip(rec["chain_cycles"],
                                                        rec["chain_ms"]))
    return (f"# card={rec['card']} device={rec['device']} "
            f"timer={rec['timer']} front_s={rec['front_s']:.3f} "
            f"build_s={rec['build_s']:.3f} slab_s={rec['slab_s']:.3f} "
            f"fast_s={rec['fast_s']:.3f} "
            f"build_peak_bytes={rec['build_peak_bytes']} "
            f"peak_bytes={rec['peak_bytes']} "
            f"build_cpu_csrc={rec['cpu_build_s']:.3f}s "
            f"cpu_vcycle={rec['cpu_vcycle_ms']:.3f}ms "
            f"vcycle={rec['vcycle_ms']:.4f}ms slope_r2={rec['slope_r2']:.6f} "
            f"{ts} single_cycle_median={rec['single_cycle_ms']:.4f}ms "
            f"residual_12cycles={rec['residual_12cycles']:.3e} "
            f"pcg_iters_to_1e8={p['iters']} pcg_rel={p['rel']:.3e} "
            f"pcg_s={p['s']:.4f} default_path={s['path']} "
            f"default_iters={s['iters']} default_rel={s['rel']:.3e} "
            f"default_s={s['s']:.4f} "
            f"k1_launches_per_cycle={c['k1_launches']} "
            f"slab_matvecs_per_cycle={c['slab_matvecs']} "
            f"levels={rec['levels']} shapes={rec['shapes']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=DEFAULT_N,
                    help="points of the torus (default 1,000,000)")
    ap.add_argument("--out", help="write the whole record here as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    rec = run(args.n, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    print(json.dumps(headline(rec)), flush=True)
    print(account(rec), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
