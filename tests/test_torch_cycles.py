"""The remaining solve loops of the port against the JAX package on
the shipped 24,000-row fixture (Chebyshev).

With x64 enabled the JAX package runs this f32 fixture's cycles in f64
(its Chebyshev bounds and coarse solve promote), so the parity runs use
the fixture cast to f64 on both sides: the ``fmg`` solution at 1e-9 of
its largest entry, the ``solve_with_history`` trace at rtol 1e-6 while
the residual is above 1e-9, +inf beyond the last cycle.  The port's f32
run is held against its own f64 run: ``fmg`` at 1e-3 of the largest
entry (measured 1.1e-4: f32 rounding times the coarse operator's
condition), the trace at rtol 1e-2 while the residual is above 5e-3
(the f32 stationary solve leaves the f64 trace from the third cycle on
and stalls near 4e-5).
``solve_refined`` (f32 cycles, f64 residual) reaches 1e-8 with the outer
iteration count within 1 of JAX's and the f64 solutions at 1e-6
relative; ``estimate_lambda_max`` from the same start vector at 1e-5
relative.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gravomg_tpu as g
from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.solve.spmv import spmv as jax_spmv

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import solver_from_numpy

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
KW = dict(smoother="chebyshev")


def _both():
    ht = gt.load_solver(HALO, device="cpu")
    b = np.random.default_rng(0).normal(size=24000).astype(np.float32)
    return jax_load_solver(HALO), ht, b


def _both64(tmp_path):
    with np.load(HALO) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = tmp_path / "halo64.npz"
    np.savez(path, **arrays)
    return jax_load_solver(str(path)), solver_from_numpy(arrays, device="cpu")


def test_fmg_and_history_match_jax(tmp_path):
    _, h32, b = _both()
    hj, ht = _both64(tmp_path)
    cfg, tcfg = g.MultigridConfig(**KW), gt.MultigridConfig(**KW)
    bt, bj = torch.as_tensor(b).double(), jnp.asarray(b, jnp.float64)
    b32 = torch.as_tensor(b)
    for cycles in (1, 2):
        xj = np.asarray(g.fmg(hj, bj, cfg, cycles_per_level=cycles))
        xt = gt.fmg(ht, bt, tcfg, cycles_per_level=cycles)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                                   atol=1e-9 * np.abs(xj).max())
        x32 = gt.fmg(h32, b32, tcfg, cycles_per_level=cycles)
        assert x32.dtype == torch.float32
        np.testing.assert_allclose(x32.numpy(), xj, rtol=0,
                                   atol=1e-3 * np.abs(xj).max())
    # One pass already beats a V-cycle from zero.
    res = lambda x: float((bt - gt.spmv(ht.levels[0].op, x)).norm())  # noqa: E731
    assert res(gt.fmg(ht, bt, tcfg)) < res(
        gt.v_cycle(ht, torch.zeros_like(bt), bt, tcfg))

    kw = dict(max_cycles=12, tolerance=1e-5, **KW)
    _, rel_j, it_j, hist_j = g.solve_with_history(hj, bj,
                                                  g.MultigridConfig(**kw))
    x, rel_t, it_t, hist_t = gt.solve_with_history(ht, bt,
                                                   gt.MultigridConfig(**kw))
    hist_j, hist_t = np.asarray(hist_j), hist_t.numpy()
    assert it_t == int(it_j) < 12 and hist_t.shape == (12,)
    assert np.all(np.isinf(hist_t[it_t:])) and rel_t <= 1e-5
    np.testing.assert_allclose(hist_t[:it_t], hist_j[:it_t], rtol=1e-6)
    assert hist_t[it_t - 1] == rel_t
    xs, rel_s, it_s = gt.solve(ht, bt, gt.MultigridConfig(**kw))
    assert it_s == it_t and torch.equal(xs, x)
    kw32 = dict(max_cycles=6, tolerance=1e-5, **KW)
    _, _, it_32, hist_32 = gt.solve_with_history(h32, b32,
                                                 gt.MultigridConfig(**kw32))
    hist_32 = hist_32.numpy()
    above = hist_t[:it_32] > 5e-3
    assert hist_32.dtype == np.float32 and above.sum() >= 2
    np.testing.assert_allclose(hist_32[:it_32][above], hist_t[:it_32][above],
                               rtol=1e-2)
    assert np.all(np.diff(hist_32[:4]) < 0)


def test_refined_solve_and_lambda_max_match_jax():
    hj, ht, b = _both()
    cfg, tcfg = g.MultigridConfig(**KW), gt.MultigridConfig(**KW)
    xj, rel_j, it_j = g.solve_refined(hj, jnp.asarray(b), cfg)
    xt, rel_t, it_t = gt.solve_refined(ht, torch.as_tensor(b), tcfg)
    assert xt.dtype == torch.float64
    assert rel_t <= 1e-8 and float(rel_j) <= 1e-8
    assert abs(it_t - int(it_j)) <= 1, (it_t, int(it_j))
    xj = np.asarray(xj)
    assert np.linalg.norm(xt.numpy() - xj) <= 1e-6 * np.linalg.norm(xj)
    with pytest.raises(ValueError):
        gt.solve_refined(ht, torch.as_tensor(b), tcfg, inner_cycles=0)

    # Power iteration from one start vector, by hand on the JAX side
    # (its own start comes from jax.random).
    x0 = np.random.default_rng(1).normal(size=24000).astype(np.float32)
    op = hj.levels[0].op
    x = jnp.asarray(x0)
    for _ in range(30):
        y = jax_spmv(op, x) / op.diag
        x = y / jnp.linalg.norm(y)
    y = jax_spmv(op, x) / op.diag
    lam_j = float(jnp.vdot(x, y) / jnp.vdot(x, x))
    top = ht.levels[0].op
    lam_t = float(gt.estimate_lambda_max(top, x0=torch.as_tensor(x0)))
    assert abs(lam_t - lam_j) <= 1e-5 * lam_j
    # Its own start: seeded, repeatable, below the Gershgorin bound.
    lam_a = float(gt.estimate_lambda_max(top))
    assert lam_a == float(gt.estimate_lambda_max(top))
    gen = torch.Generator().manual_seed(3)
    lam_g = float(gt.estimate_lambda_max(top, generator=gen))
    bound = ht.levels[0].cheb.lam_max         # the Gershgorin bound
    assert 0.5 * bound < min(lam_a, lam_g) and max(lam_a, lam_g) <= bound * (
        1 + 1e-6)
