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
the two sum the 32 products in another order) and against itself (two
runs on one input must agree bitwise), the kernel's and the twin's time
per wrapper call (CUDA events, median of 10), the kernel alone as
torch.profiler sees it (median of 5 traced calls, L2 flushed before
each), the kernel's rate in GB/s of lidx and w, and its bound: the
bytes of x, starts, lidx and w read once and y written once, over the H100's published 3.35 TB/s (its 2 operations per entry
over the published 67 TFLOP/s of f32 take less).  No single PyTorch call
computes the function (the twin is a gather, a product and a sum), so
there is no library time beside it.  Needs a CUDA device; exits 2
without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gravomg_tpu_torch.ops.window_gather import (window_gather_cuda,
                                                 window_gather_fast,
                                                 window_gather_plain)
from gravomg_tpu_torch.probes.timing import bound, cuda_ms, kernel_ms
from gravomg_tpu_torch.utils.device import resolve_device

B, K, WD = 1024, 32, 8192      # rows a block, entries a row, window width
TOL = 1e-6                     # max|kernel - twin| / max|twin|


def probe_inputs(v: int, device=None):
    """(x[:NB*B], {"P1": starts, "P2": starts}, lidx, w) for V = ``v``,
    on the card unless ``device`` names another device."""
    device = resolve_device(device)
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


def measure(v: int):
    """Both probes at V = ``v`` on the card, with the kernel's launch
    count set to 0 just before and read just after; then, per probe, the
    kernel against its twin, and times.  Returns (launches in the probe
    runs, {probe: results}).  Raises if a probe's output is not finite
    or the kernel and its twin disagree beyond ``TOL``."""
    x, starts, lidx, w = probe_inputs(v)
    nbytes = lidx.numel() * 4 + w.numel() * 4
    io_bytes = nbytes + x.numel() * 4 + lidx.shape[0] * 4 + x.numel() * 4
    bound_ms, bound_by = bound(io_bytes, 2 * lidx.numel())
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
        yk2 = window_gather_cuda(x, st, lidx, w, WD)
        yp = window_gather_plain(x, st, lidx, w, WD)
        torch.cuda.synchronize()
        if not torch.equal(yk, yk2):
            raise AssertionError(f"{name} at V={v}: two runs of the kernel "
                                 f"on one input differ")
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
        # The kernel alone, without the wrapper's host time; L2 flushed
        # before each call (at 200k, lidx and w are about L2's size).
        alone_ms = kernel_ms(
            lambda: window_gather_cuda(x, st, lidx, w, WD), "window_gather",
            cold=True)
        res[name] = {"V": v, "max_abs_err": err,
                     "rel_err": rel, "ms": k_ms, "plain_ms": min(p1, p2),
                     "kernel_ms": [k1, k2], "plain_ms_runs": [p1, p2],
                     "io_bytes": io_bytes, "bound_ms": bound_ms,
                     "bound_by": bound_by, "share_of_bound": bound_ms / k_ms,
                     "kernel_alone_ms": alone_ms,
                     "alone_share_of_bound": (bound_ms / alone_ms
                                              if alone_ms else None),
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
        alone = r["kernel_alone_ms"]
        print(f"{name} V={v}: kernel {r['ms']:.3f} ms ({r['GBps']:.0f} GB/s "
              f"of lidx+w; kernel alone "
              + ("not measured" if alone is None else f"{alone:.3f} ms")
              + f"), bound {r['bound_ms']:.3f} ms ({r['bound_by']}), share "
              f"{r['share_of_bound']:.2f}, twin {r['plain_ms']:.3f} ms, "
              f"max|d|/max|y| {r['rel_err']:.3e}")
        print(json.dumps({name: r}))
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
