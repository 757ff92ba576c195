"""One ``solve/cg.py::mg_solve`` a call, to the configuration's
tolerance, on the hierarchy built in set-up; the right-hand sides are a
pool of N(0,1) vectors drawn from the seed.

Compared: ``x_err``, the largest ||x - x_ref|| / ||x_ref|| over the
sampled calls, x_ref the float64 solve of the reference's screened
operator on the same right-hand side.  A call whose relative residual
is above the tolerance has broken its guarantee and counts as failed.

Control: the program's own bf16 path switched on for the whole solve,
the outer CG's operator included (``mg_fcg`` with the bf16-cast
hierarchy as ``h_outer`` too).
"""

import torch

from gravomg_tpu_torch.solve.cg import mg_fcg, mg_solve
from gravomg_tpu_torch.solve.vcycle import cast_fast_operators

from benchmark.check import rel_err
from benchmark.loop import Answer, finite
from benchmark.reference.graph import laplacian, screened
from benchmark.reference.solve import cg


def inputs(mix):
    v = mix.dep.graph.num_vertices
    return torch.randn((mix.pool, v), generator=mix.gen,
                       device=mix.device).unbind(0)


def call(mix, i):
    x, rel, it = mg_solve(mix.dep.h, mix.inputs[i % mix.pool], mix.dep.cfg)
    return Answer((x,), rel <= mix.dep.cfg.tolerance and finite(x), it,
                  {"rel": rel})


def readings(g, config, traffic, ins, outs, device):
    lap, mass = laplacian(g)
    b = torch.stack([x.to(device) for x in ins], dim=1)
    x_ref = cg(screened(lap, mass), b.double())
    x = torch.stack([o[0] for o in outs], dim=1)
    return {"x_err": rel_err(x, x_ref)}


def control(mix, i):
    if not hasattr(mix, "h16"):
        mix.h16 = cast_fast_operators(mix.dep.h, torch.bfloat16)
    b = mix.inputs[i % mix.pool]
    x, rel, it = mg_fcg(mix.h16, b, mix.dep.cfg, h_outer=mix.h16)
    return Answer((x,), True, it, None)
