"""One ``apps/heat.py::heat_geodesics`` a call, on the hierarchy built
in set-up (two refits, two MG-PCG solves), from the next of a pool of
source vertices drawn from the seed; ``t_factor`` from the mix.

Every call passes a ``record`` dict, so the app reports both solves'
iterations and relative residuals (and the refits' seconds, which
``heat.refit_ms`` reads); a call where either residual is above the
configuration's tolerance has broken its guarantee and counts as failed.

Compared: ``phi_err``, the largest ||phi - phi_ref|| / ||phi_ref|| over
the sampled calls, phi_ref the float64 heat method of
``benchmark/reference/heat.py`` from the same source.

Control: that reference heat method computed in bfloat16 in the
program's place, ``CONTROL_ITERS`` CG iterations at most.
"""

import torch

from gravomg_tpu_torch.apps.heat import heat_geodesics

from benchmark.check import rel_err
from benchmark.loop import Answer, finite
from benchmark.reference.graph import knn_graph
from benchmark.reference.heat import heat_distances

CONTROL_ITERS = 3000


def inputs(mix):
    v = mix.dep.graph.num_vertices
    return torch.randint(0, v, (mix.pool,), generator=mix.gen,
                         device=mix.device).tolist()


def call(mix, i):
    rec = {}
    phi = heat_geodesics(mix.dep.graph, mix.dep.h,
                         source=mix.inputs[i % mix.pool],
                         t_factor=mix.traffic["t_factor"], cfg=mix.dep.cfg,
                         record=rec)
    tol = mix.dep.cfg.tolerance
    ok = (rec["heat_rel"] <= tol and rec["poisson_rel"] <= tol
          and finite(phi))
    return Answer((phi,), ok, rec["heat_iters"] + rec["poisson_iters"], rec)


def readings(g, config, traffic, ins, outs, device):
    phi_ref = heat_distances(g, ins, traffic["t_factor"])
    phi = torch.stack([o[0] for o in outs], dim=1)
    return {"phi_err": rel_err(phi, phi_ref)}


def control(mix, i):
    if not hasattr(mix, "ref_graph"):
        mix.ref_graph = knn_graph(mix.dep.points, mix.config["knn"]["k"],
                                  mix.device)
    phi = heat_distances(mix.ref_graph, [mix.inputs[i % mix.pool]],
                         mix.traffic["t_factor"], dtype=torch.bfloat16,
                         max_iters=CONTROL_ITERS)
    return Answer((phi[:, 0],), True, None, None)
