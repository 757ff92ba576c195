"""PyTorch port vs the JAX package at f64: one V-cycle, a 10-cycle
residual trace and the stationary solve on the two shipped fixtures.

Tolerances: the V-cycle at rtol 1e-9 (same arithmetic, another summation
order); the trace at rtol 1e-9 down to the f64 floor of a relative
residual (see below); the stationary solve with equal iteration counts.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.io.serialization import load_solver as jax_load_solver

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import solver_from_numpy

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")
# Fixture -> the smoother it was built for.
FIXTURES = {"entry_hierarchy.npz": "jacobi", "halo_hierarchy.npz": "chebyshev"}


def _load64(name, tmp_path):
    with np.load(os.path.join(ASSETS, name)) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = tmp_path / f"{name}_64.npz"
    np.savez(path, **arrays)
    return jax_load_solver(str(path)), solver_from_numpy(arrays, device="cpu")


def test_vcycle_and_trace_match_f64(tmp_path):
    for name, smoother in FIXTURES.items():
        hj, ht = _load64(name, tmp_path)
        cfg = g.MultigridConfig(smoother=smoother)
        tcfg = gt.MultigridConfig(smoother=smoother)
        b = np.random.default_rng(0).normal(size=ht.levels[0].op.num_vertices)
        bt, bj = torch.as_tensor(b), jnp.asarray(b)
        step = jax.jit(lambda h, x, b: g.v_cycle(h, x, b, cfg))

        x1t = gt.v_cycle(ht, torch.zeros_like(bt), bt, tcfg)
        x1j = np.asarray(step(hj, jnp.zeros_like(bj), bj))
        np.testing.assert_allclose(x1t.numpy(), x1j, rtol=1e-9,
                                   atol=1e-9 * np.abs(x1j).max())
        assert torch.equal(
            gt.v_cycle(ht, torch.zeros_like(bt), bt, tcfg, x0_zero=True),
            x1t)

        xt, xj = torch.zeros_like(bt), jnp.zeros_like(bj)
        rels_t, rels_j = [], []
        for _ in range(10):
            xt = gt.v_cycle(ht, xt, bt, tcfg)
            xj = step(hj, xj, bj)
            rels_t.append(float(torch.linalg.norm(
                bt - gt.spmv(ht.levels[0].op, xt)) / torch.linalg.norm(bt)))
            rels_j.append(float(jnp.linalg.norm(
                bj - g.spmv(hj.levels[0].op, xj)) / jnp.linalg.norm(bj)))
        # rtol 1e-9, down to the f64 floor of a relative residual: a
        # rounding-level change delta_x moves it by |A delta_x| / |b|, up
        # to eps * |A| |x| / |b| per cycle (|A| as its largest row sum).
        op = ht.levels[0].op
        anorm = float((op.diag.abs() + op.offdiag.abs().sum(1)).max())
        floor = 10 * 2.2e-16 * anorm * float(xt.norm() / bt.norm())
        np.testing.assert_allclose(rels_t, rels_j, rtol=1e-9, atol=floor)
        assert rels_t[-1] < 0.1 * rels_t[0]


def test_stationary_solve_matches_f64(tmp_path):
    """Same iteration count, relative residual and solution as the JAX
    package's ``solve``."""
    for name, smoother in FIXTURES.items():
        hj, ht = _load64(name, tmp_path)
        kw = dict(smoother=smoother, tolerance=1e-6, max_cycles=30)
        b = np.random.default_rng(4).normal(
            size=ht.levels[0].op.num_vertices)
        xj, rel_j, it_j = g.solve(hj, jnp.asarray(b), g.MultigridConfig(**kw))
        xt, rel_t, it_t = gt.solve(ht, torch.as_tensor(b),
                                   gt.MultigridConfig(**kw))
        assert it_t == int(it_j) and rel_t <= 1e-6
        np.testing.assert_allclose(rel_t, float(rel_j), rtol=1e-6)
        xj = np.asarray(xj)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                                   atol=1e-9 * np.abs(xj).max())
