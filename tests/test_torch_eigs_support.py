"""``laplace_eigs`` on near-singular blocks and against a plain float64
reference (``tests/plain_eigs.py``), on the CPU.

The orthonormalisation never raises on a finite block and returns it
M-orthonormal on its kept directions, in float32: a duplicated column,
a zero column and a column scaled by 1e-4 each leave one direction
below ``_RANK_TOL`` of the Gram's largest eigenvalue, which keeps a
unit scale (a column of M-norm at most 1e-3), while the other eleven
come out M-orthonormal to 1e-5 (a float32 product of a (V, 12) block
with a whitening of condition below 1e3).  The most nearly singular
P-block Gram dumped from the card (``GRAM_P``: rank one to 1e-11)
whitens to a finite transform with T^T G T the identity, to 1e-8, on its
one kept direction.

On a 3,000-point torus (k = 12, the spectral shift, the deployment's
Chebyshev hierarchy), with no fast forms and after
``attach_operators`` (slab forms from 750 rows, so the (V, 12) cycle
runs B1's CPU twin): the eigenvalues within 1e-3 of lam_k of the dense
reference (LOBPCG stops at a residual of 1e-5 of lam_max, which bounds
the eigenvalue error near 1e-5 of lam_k; 1e-3 leaves room for near-
degenerate pairs); the pencil residual ||L v - theta M v||_{M^-1} /
(lam_k ||v||_M) below 1e-3 (1e-4 observed: the stopping test's 1e-5 in
the plain norm, scaled by 1/sqrt(mass)); the nullspace value below 1e-5
of lam_k (float32 rounding of a zero eigenvalue).  Under a CPU profiler
the call opens one ``gmg:laplace_eigs``, a ``gmg:lobpcg.step``,
``gmg:block_s`` and ``gmg:rr_s`` per step and a ``gmg:lobpcg.orth`` per
orthonormalisation; its record carries ``iters``, ``orth_fallbacks`` and
``rr_pinned``; the host's thread count is as it was before the call.
Where the device's ``eigh`` raises on a Gram, the host's LAPACK takes
over: with ``torch.linalg.eigh`` made to raise once, a block still comes
back finite and M-orthonormal, with ``orth_fallbacks`` 1.
"""

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import gravomg_tpu_torch as gt
import plain_eigs
from gravomg_tpu_torch.apps import spectral
from gravomg_tpu_torch.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.solve.vcycle import attach_operators
from gravomg_tpu_torch.utils import profiling

torch.set_num_threads(2)

# The float64 Gram of the most nearly singular P block met in 460 calls on
# the card (torus100k's cloud, no fast forms, start seed 3700000046, 46th
# call): one eigenvalue of 1.36e-2, eleven below 1e-12.
GRAM_P = [
    [5.708776930178953e-13, -2.7583201274333287e-13, -2.2812227399962607e-13, 8.829143145069352e-13, -6.523062547849806e-13, 8.917399721151744e-13, 2.201229207868732e-13, -6.009886619166366e-14, -4.633791108054948e-12, -2.534586011568914e-12, 2.0268676261704954e-12, 8.782064920126064e-08],
    [-2.7583201274333287e-13, 1.348104523258294e-13, 1.0806864471846791e-13, -4.3704289904328553e-13, 3.2219733864169025e-13, -4.364295347305042e-13, -1.0699263093403253e-13, 2.83327750924036e-14, 2.2715440967934955e-12, 1.2429393366299607e-12, -1.003613752742267e-12, -4.2738786047498975e-08],
    [-2.2812227399962607e-13, 1.0806864471846791e-13, 9.417664446019234e-14, -3.3817090339969785e-13, 2.5081778207799236e-13, -3.4853568433952093e-13, -8.707011684333323e-14, 2.5004230575791212e-14, 1.8059194130502164e-12, 9.871652986615245e-13, -7.758845146184395e-13, -3.466362438295358e-08],
    [8.829143145069352e-13, -4.3704289904328553e-13, -3.3817090339969785e-13, 1.4365063444342729e-12, -1.0565844201768438e-12, 1.4169959671701606e-12, 3.447600614000808e-13, -8.815347809699253e-14, -7.388387816564468e-12, -4.044369390845411e-12, 3.29985621833122e-12, 1.379051163052877e-07],
    [-6.523062547849806e-13, 3.2219733864169025e-13, 2.5081778207799236e-13, -1.0565844201768438e-12, 7.774413007453267e-13, -1.0443750652488593e-12, -2.5442503849528853e-13, 6.54475599033778e-14, 5.443867526164139e-12, 2.979749478935655e-12, -2.4269876118667437e-12, -1.0174724690538907e-07],
    [8.917399721151744e-13, -4.364295347305042e-13, -3.4853568433952093e-13, 1.4169959671701606e-12, -1.0443750652488593e-12, 1.4131094298229172e-12, 3.461454973574892e-13, -9.132204631314531e-14, -7.356429913051155e-12, -4.025451945542852e-12, 3.2540715035019173e-12, 1.382901805941444e-07],
    [2.201229207868732e-13, -1.0699263093403253e-13, -8.707011684333323e-14, 3.447600614000808e-13, -2.5442503849528853e-13, 3.461454973574892e-13, 8.513934527761493e-14, -2.288158673623899e-14, -1.8002247278055824e-12, -9.848721844654718e-13, 7.915802373888038e-13, 3.3989194732279455e-08],
    [-6.009886619166366e-14, 2.83327750924036e-14, 2.5004230575791212e-14, -8.815347809699253e-14, 6.54475599033778e-14, -9.132204631314531e-14, -2.288158673623899e-14, 6.650699260250393e-15, 4.728403408659138e-13, 2.584258855703862e-13, -2.022261073137732e-13, -9.104635269371511e-09],
    [-4.633791108054948e-12, 2.2715440967934955e-12, 1.8059194130502164e-12, -7.388387816564468e-12, 5.443867526164139e-12, -7.356429913051155e-12, -1.8002247278055824e-12, 4.728403408659138e-13, 3.8305245806885474e-11, 2.0961774705746296e-11, -1.6967857083587054e-11, -7.193425590983033e-07],
    [-2.534586011568914e-12, 1.2429393366299607e-12, 9.871652986615245e-13, -4.044369390845411e-12, 2.979749478935655e-12, -4.025451945542852e-12, -9.848721844654718e-13, 2.584258855703862e-13, 2.0961774705746296e-11, 1.1471040206344042e-11, -9.288216267645133e-12, -3.9355546359511205e-07],
    [2.0268676261704954e-12, -1.003613752742267e-12, -7.758845146184395e-13, 3.29985621833122e-12, -2.4269876118667437e-12, 3.2540715035019173e-12, 7.915802373888038e-13, -2.022261073137732e-13, -1.6967857083587054e-11, -9.288216267645133e-12, 7.5802926303271e-12, 3.1664524526404423e-07],
    [8.782064920126064e-08, -4.2738786047498975e-08, -3.466362438295358e-08, 1.379051163052877e-07, -1.0174724690538907e-07, 1.382901805941444e-07, 3.3989194732279455e-08, -9.104635269371511e-09, -7.193425590983033e-07, -3.9355546359511205e-07, 3.1664524526404423e-07, 0.013570922218254846],
]


def _kept_identity(g64: torch.Tensor, t: torch.Tensor):
    """(T^T G T, the kept directions' mask)."""
    c = t.T @ g64 @ t
    return c, torch.diag(c) > 0.5


def test_orthonormalize_survives_near_singular_blocks(monkeypatch):
    rng = np.random.default_rng(5)
    v, k = 2000, 12
    mass = torch.as_tensor(rng.uniform(0.5, 1.5, v) * 1e-3, dtype=torch.float32)
    base = rng.normal(size=(v, k))
    blocks = {"duplicate": base.copy(), "zero": base.copy(),
              "scaled": base.copy()}
    blocks["duplicate"][:, 7] = blocks["duplicate"][:, 3]
    blocks["zero"][:, 5] = 0.0
    blocks["scaled"][:, 9] *= 1e-4
    m64 = mass.double()
    for name, b in blocks.items():
        counts = {"orth_fallbacks": 0}
        out = spectral._b_orthonormalize(
            mass, torch.as_tensor(b, dtype=torch.float32), counts)
        assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
        o64 = out.double()
        g = o64.T @ (m64[:, None] * o64)
        kept = torch.diag(g) > 0.5
        assert int(kept.sum()) == k - 1, name
        eye = torch.eye(k - 1, dtype=torch.float64)
        assert float((g[kept][:, kept] - eye).abs().max()) < 1e-5, name
        assert float(torch.diag(g)[~kept].max()) < 1e-6, name
        assert counts["orth_fallbacks"] == 0

    gram = torch.as_tensor(GRAM_P, dtype=torch.float64)
    counts = {"orth_fallbacks": 0}
    t = spectral._whitening(gram, counts)
    assert bool(torch.isfinite(t).all())
    c, kept = _kept_identity(0.5 * (gram + gram.T), t)
    assert int(kept.sum()) == 1
    assert abs(float(c[kept][:, kept]) - 1.0) < 1e-8
    assert counts["orth_fallbacks"] == 0

    # The fallback: the first eigh of the call raises, as the card's did
    # on an f32 Gram; the second, the host's, is the real one.
    eigh, calls = torch.linalg.eigh, []

    def failing_once(a, *args, **kwargs):
        calls.append(a.device.type)
        if len(calls) == 1:
            raise torch.linalg.LinAlgError(
                "linalg.eigh: The algorithm failed to converge")
        return eigh(a, *args, **kwargs)

    monkeypatch.setattr(torch.linalg, "eigh", failing_once)
    counts = {"orth_fallbacks": 0}
    out = spectral._b_orthonormalize(
        mass, torch.as_tensor(base, dtype=torch.float32), counts)
    monkeypatch.undo()
    assert calls == ["cpu", "cpu"] and counts["orth_fallbacks"] == 1
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    o64 = out.double()
    g = o64.T @ (m64[:, None] * o64)
    eye = torch.eye(k, dtype=torch.float64)
    assert float((g - eye).abs().max()) < 1e-5


def _spans(prof):
    return collections.Counter(
        e.name()[len(profiling.PREFIX):]
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(profiling.PREFIX))


def test_laplace_eigs_match_plain_reference():
    pts = torus_points(3000, seed=6)
    pts = pts[morton_order(pts)].astype(np.float32)
    pen = plain_eigs.pencil(pts, 12)
    lam, _ = plain_eigs.lowest_pairs(pen, 12)
    lam_k = float(lam[-1])

    graph = grid_knn_graph_nosync(pts, 12, margin=2.4, device="cpu")
    op, _ = gt.screened_poisson_operator(graph, alpha="spectral")
    cfg = gt.MultigridConfig(coarse_threshold=800, smoother="chebyshev")
    h = gt.build_hierarchy_device(
        graph, op, cfg, generator=torch.Generator().manual_seed(0))[0].solver
    attached = attach_operators(h, slab_min_rows=750)
    assert attached.levels[0].banded is not None
    threads = torch.get_num_threads()
    for name, hh in (("none", h), ("attach_operators", attached)):
        rec = {}
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
        try:
            theta, x, _ = gt.laplace_eigs(
                graph, k=12, cfg=cfg, h=hh, iters=40, tol=1e-5,
                generator=torch.Generator().manual_seed(11), record=rec)
        finally:
            prof.stop()
        gap = (theta.double() - lam).abs() / lam_k
        assert float(gap.max()) < 1e-3, (name, gap)
        assert abs(float(theta[0])) < 1e-5 * lam_k, name
        res = plain_eigs.pencil_residual(pen, theta, x) / lam_k
        assert float(res.max()) < 1e-3, (name, res)

        it = rec["iters"]
        assert 0 < it <= 40 and len(rec["steps"]) == it
        assert rec["orth_fallbacks"] == 0
        assert isinstance(rec["rr_pinned"], int) and rec["rr_pinned"] >= 0
        n = _spans(prof)
        assert n["laplace_eigs"] == 1, name
        assert n["lobpcg.step"] == n["block_s"] == n["rr_s"] == it, name
        # The start block, then W each step and P from the second on.
        assert n["lobpcg.orth"] == 2 * it, name
        # The Rayleigh-Ritz solves leave torch's thread count alone.
        assert torch.get_num_threads() == threads
