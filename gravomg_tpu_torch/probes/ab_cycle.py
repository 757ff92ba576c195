"""The 1M main path on the card by the package of one or more checkouts,
each in a fresh process, so that two commits can be held against each
other within one call on one card (run them parent, change, change,
parent):

    python gravomg_tpu_torch/probes/ab_cycle.py ROOT [ROOT ...]

For each ROOT (a directory holding ``gravomg_tpu_torch/``): the bench
recipe at 1,000,000 points with its hierarchy built on the card and 8-row
slab forms; one V-cycle's time (CUDA events, median of 10), its device
time and the block-window kernel's share of it (torch.profiler), the
kernel's launches in one cycle; MG-PCG and ``mg_solve`` to 1e-8 (seconds,
median of 3; iterations); the level-0 A matvec per call in f32 and bf16.
Prints the card's name and power limit and one JSON line a run.  Uses
only functions that every commit of the port since its hierarchy build
ran on the card has.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time


def _one(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch
    import gravomg_tpu_torch as gt
    from gravomg_tpu_torch.ops import blockdense_cuda
    from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
    from gravomg_tpu_torch.probes.timing import cuda_ms, kernel_events
    n = 1_000_000
    cfg, h, _, _, _ = bench_hierarchy(n, "cuda")
    h = gt.attach_slab_operators(h)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=n)
                        .astype(np.float32), device="cuda")
    cycle = lambda: gt.v_cycle(h, torch.zeros_like(b), b, cfg)
    out = {"root": root, "vcycle_ms": cuda_ms(cycle)}
    evts = kernel_events(cycle)
    out["device_ms"] = sum(us for _, us in evts) / 1e3 if evts else None
    k1 = [us for name, us in evts if "blockdense_matvec_kernel" in name]
    out["k1_ms"] = sum(k1) / 1e3 if evts else None
    before = blockdense_cuda.blockdense_matvec_cuda.launches
    cycle()
    torch.cuda.synchronize()
    out["k1_launches"] = blockdense_cuda.blockdense_matvec_cuda.launches - before
    for name, solver in (("mg_pcg", gt.mg_pcg), ("mg_solve", gt.mg_solve)):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, rel, it = solver(h, b, cfg)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        out[name] = {"s": statistics.median(secs), "iters": it, "rel": rel}
    x = torch.randn(n, device="cuda")
    hb = gt.cast_fast_operators(h, torch.bfloat16)
    for label, lvl in (("f32", h.levels[0]), ("bf16", hb.levels[0])):
        out[f"a0_{label}_ms"] = cuda_ms(lambda: gt.level_matvec(lvl, x))
    return out


def main(roots) -> list:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    rows = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"run on {root} failed:\n{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(row))
        rows.append(row)
    return rows


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2])))
    elif len(sys.argv) > 1:
        main(sys.argv[1:])
    else:
        sys.exit(__doc__)
