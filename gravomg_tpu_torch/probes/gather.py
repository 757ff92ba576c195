"""Gather probe on the card: the windowed ELL SpMV of
``scripts/profile_pltake.py`` (P1) and ``scripts/profile_gather2.py``
(P2), through the kernel of ``ops/window_gather.py`` and its plain twin.

    python -m gravomg_tpu_torch.probes.gather [V]      # V = 200000 by default

Inputs are drawn with numpy exactly as the scripts draw them (one
``default_rng(0)``: x, then lidx, then w); the two probes differ only in
their window starts, which P1 shifts back by WD/4.  As in the scripts,
the probe takes x[:NB*B] and returns ``out * 1e-3 + x[:NB*B]``.  P2's
last starts (V - WD) run past that x; the kernel clamps them to
NB*B - WD, as ``lax.dynamic_slice`` clamps a slice that runs off the
end.

For each probe: the kernel against its twin (max|d| <= 1e-6 * max|y|,
the two sum the 32 products in another order), the kernel's and the
twin's time (CUDA events, median of 10), and the kernel's rate in GB/s of
lidx and w.  Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import json
import statistics
import sys

import numpy as np
import torch

from gravomg_tpu_torch.ops.window_gather import (window_gather_cuda,
                                                 window_gather_fast,
                                                 window_gather_plain)

B, K, WD = 1024, 32, 8192      # rows a block, entries a row, window width
TOL = 1e-6                     # max|kernel - twin| / max|twin|


def probe_inputs(v: int, device="cpu"):
    """(x[:NB*B], {"P1": starts, "P2": starts}, lidx, w) for V = ``v``."""
    nb = v // B
    rng = np.random.default_rng(0)
    x = rng.normal(size=v).astype(np.float32)
    starts = np.minimum((np.arange(nb) * B).astype(np.int32), v - WD)
    shifted = np.maximum(starts - WD // 4, 0).astype(np.int32)
    lidx = rng.integers(0, WD, size=(nb, B, K)).astype(np.int32)
    w = rng.normal(size=(nb, B, K)).astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    return t(x[:nb * B]), {"P1": t(shifted), "P2": t(starts)}, t(lidx), t(w)


def probe(x, starts, lidx, w):
    """The scripts' probe function: the gather, scaled, plus x."""
    return window_gather_fast(x, starts, lidx, w, WD).reshape(-1) * 1e-3 + x


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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


def measure(v: int):
    """Both probes at V = ``v`` on the card, with the kernel's launch
    count set to 0 just before and read just after; then, per probe, the
    kernel against its twin, and times.  Returns (launches in the probe
    runs, {probe: results}).  Raises if a probe's output is not finite
    or the kernel and its twin disagree beyond ``TOL``."""
    x, starts, lidx, w = probe_inputs(v, "cuda")
    nbytes = lidx.numel() * 4 + w.numel() * 4
    window_gather_cuda.launches = 0
    outs = {name: probe(x, st, lidx, w) for name, st in starts.items()}
    torch.cuda.synchronize()
    launches = window_gather_cuda.launches
    res = {}
    for name, st in starts.items():
        y = outs[name]
        if not (y.shape == x.shape and bool(torch.isfinite(y).all())):
            raise AssertionError(f"{name}: probe output not finite or of "
                                 f"the wrong shape {tuple(y.shape)}")
        yk = window_gather_cuda(x, st, lidx, w, WD)
        yp = window_gather_plain(x, st, lidx, w, WD)
        torch.cuda.synchronize()
        err = float((yk - yp).abs().max())
        rel = err / max(float(yp.abs().max()), 1e-30)
        if not rel <= TOL:
            raise AssertionError(f"{name} at V={v}: kernel vs twin "
                                 f"{rel:.3e} > {TOL}")
        # plain, kernel, kernel, plain: compare within one call.
        p1 = cuda_ms(lambda: window_gather_plain(x, st, lidx, w, WD))
        k1 = cuda_ms(lambda: window_gather_cuda(x, st, lidx, w, WD))
        k2 = cuda_ms(lambda: window_gather_cuda(x, st, lidx, w, WD))
        p2 = cuda_ms(lambda: window_gather_plain(x, st, lidx, w, WD))
        k_ms = min(k1, k2)
        res[name] = {"V": v, "max_abs_err": err,
                     "rel_err": rel, "ms": k_ms, "plain_ms": min(p1, p2),
                     "kernel_ms": [k1, k2], "plain_ms_runs": [p1, p2],
                     "GBps": nbytes / (k_ms * 1e-3) / 1e9}
    return launches, res


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("gather probe: no CUDA device; this probe runs only on a card",
              file=sys.stderr)
        return 2
    v = int(argv[1]) if len(argv) > 1 else 200_000
    launches, res = measure(v)
    print(f"V={v}: {launches} kernel launches in the probe runs")
    for name, r in res.items():
        print(f"{name} V={v}: kernel {r['ms']:.3f} ms ({r['GBps']:.0f} GB/s "
              f"of lidx+w), twin {r['plain_ms']:.3f} ms, max|d|/max|y| "
              f"{r['rel_err']:.3e}")
        print(json.dumps({name: r}))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
