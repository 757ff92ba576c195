"""One ``apps/spectral.py::laplace_eigs`` a call (the mix's ``k`` lowest
pairs, ``iters`` steps at most, stopping at ``tol``) on the hierarchy
built in set-up.  The pool is of generator seeds drawn from the run's
seed: a call hands ``laplace_eigs`` a generator on the card seeded with
its slot's, from which the entry draws its start block (column 0 ones,
the rest N(0,1)).  Every call passes a ``record`` dict, which the
``lobpcg.*`` readers read (iterations, the seconds of each step's device
block and Rayleigh-Ritz solve, host fallbacks, pinned directions).  A
call that raises or returns a non-finite pair counts as failed.

Compared, against the float64 pencil of ``benchmark/reference/eigs.py``
on the reference's own graph, over the sampled calls (Ritz vectors are
not compared column by column: the torus's eigenvalues come in
near-degenerate pairs, whose vectors are any basis of their plane):

- ``eig_gap``: the largest |theta_i - lam_i| / lam_k;
- ``eig_res``: the largest ||L v_i - theta_i M v_i||_{M^-1} /
  (lam_k ||v_i||_M), the pencil's residual of each returned pair.

Control: the reference pencil with its entries (L's weights and
diagonal, M) rounded to bfloat16, solved as the reference solves it,
in the program's place.
"""

import torch

from gravomg_tpu_torch.apps.spectral import laplace_eigs

from benchmark.loop import Answer, finite
from benchmark.reference.eigs import lowest_pairs, pencil_residual
from benchmark.reference.graph import RefOperator, knn_graph, laplacian

SEED_BOUND = 2**62


def inputs(mix):
    return torch.randint(0, SEED_BOUND, (mix.pool,), generator=mix.gen,
                         device=mix.device).tolist()


def call(mix, i):
    t, rec = mix.traffic, {}
    gen = torch.Generator(device=mix.device).manual_seed(
        mix.inputs[i % mix.pool])
    theta, x, _ = laplace_eigs(mix.dep.graph, k=t["k"], cfg=mix.dep.cfg,
                               h=mix.dep.h, iters=t["iters"], tol=t["tol"],
                               generator=gen, record=rec)
    return Answer((theta, x), finite(theta, x), None, rec)


def readings(g, config, traffic, ins, outs, device):
    lap, mass = laplacian(g)
    lam, _ = lowest_pairs(lap, mass, traffic["k"])
    lam_k = float(lam[-1])
    gap = res = 0.0
    for theta, x in outs:
        theta = theta.to(device=lam.device, dtype=torch.float64)
        gap = max(gap, float((theta - lam).abs().max()) / lam_k)
        res = max(res, float(pencil_residual(lap, mass, theta, x).max())
                  / lam_k)
    return {"eig_gap": gap, "eig_res": res}


def control(mix, i):
    if not hasattr(mix, "control_pairs"):
        g = knn_graph(mix.dep.points, mix.config["knn"]["k"], mix.device)
        lap, mass = laplacian(g)

        def rounded(t):
            return t.to(torch.bfloat16).double()

        mix.control_pairs = lowest_pairs(
            RefOperator(lap.neighbors, rounded(lap.offdiag),
                        rounded(lap.diag)), rounded(mass), mix.traffic["k"])
    return Answer(mix.control_pairs, True, None, None)
