"""Milliseconds of one V-cycle (``solve/vcycle.py::v_cycle``) on the
cell's own hierarchy, in the dtype of the cycle its calls run (the bf16
cast that ``mg_solve`` preconditions with at 1M rows): CUDA events
around ``CYCLES`` chained cycles on the first right-hand side of the
pool, after the window.  Only for ``mg_solve`` mixes; nothing off the
card."""

import torch

from gravomg_tpu_torch.solve.vcycle import cast_fast_operators, v_cycle

from benchmark.deploy import cycle_dtype

CYCLES = 20


def read(run):
    if run.device.type != "cuda" or run.mix.kind != "mg_solve":
        return None
    dep = run.mix.dep
    dtype = cycle_dtype(dep, run.mix.kind)
    h = dep.h if dtype == torch.float32 else cast_fast_operators(dep.h, dtype)
    b = run.mix.inputs[0]

    def chain():
        x = torch.zeros_like(b)
        for _ in range(CYCLES):
            x = v_cycle(h, x, b, dep.cfg)
        return x

    chain()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chain()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / CYCLES
