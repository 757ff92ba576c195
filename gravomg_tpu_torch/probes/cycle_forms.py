"""The 1M V-cycle on two forms of one hierarchy, on the card: 8-row slab
forms alone (``chip_smoke.py`` phase 5's hierarchy) against slab forms
plus uniform block-dense forms on the levels they leave (bench.py's
recipe, which ``gravomg_tpu_torch/bench.py`` follows):

    python -m gravomg_tpu_torch.probes.cycle_forms [N]    # N = 1,000,000

Built once by ``probes/mxu_levels.py::bench_hierarchy``; then, in turns
(slab, uniform, uniform, slab): one cycle from an idle card (CUDA
events, median of 10) and the per-cycle time of 32 chained cycles
(median of 3), and from one cycle traced by torch.profiler its device
time and its kernel launches.  Prints the card's name and power limit,
then one JSON line a turn.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from gravomg_tpu_torch.bench import card_name
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator
from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
from gravomg_tpu_torch.probes.timing import cuda_ms
from gravomg_tpu_torch.solve import vcycle as vc


def _traced(fn) -> dict:
    """Device ms and kernel launches of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(1 for e in prof.events() if e.name == "cudaLaunchKernel")
    return {"device_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
            "device_ops": len(dev), "kernel_launches": launches}


def main(n: int) -> None:
    cfg, h, _, _, _ = bench_hierarchy(n)
    slab = vc.attach_slab_operators(h)
    forms = {"slab": slab, "slab+uniform": vc.attach_fast_operators(slab)}
    b = torch.as_tensor(np.random.default_rng(0).normal(size=n)
                        .astype(np.float32), device="cuda")

    def cycle(hh):
        return vc.v_cycle(hh, torch.zeros_like(b), b, cfg)

    def chain(hh, c=32):
        x = torch.zeros_like(b)
        for _ in range(c):
            x = vc.v_cycle(hh, x, b, cfg)
        return x

    print(card_name(), flush=True)
    for name in ("slab", "slab+uniform", "slab+uniform", "slab"):
        hh = forms[name]
        row = {"n": n, "forms": name,
               "uniform_levels": [li for li, lvl in enumerate(hh.levels)
                                  if isinstance(lvl.banded,
                                                BlockDenseOperator)],
               "single_ms": cuda_ms(lambda: cycle(hh)),
               "chained_ms": cuda_ms(lambda: chain(hh), reps=3) / 32}
        row.update(_traced(lambda: cycle(hh)))
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000)
