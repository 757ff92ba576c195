"""The (V, D) branch of the port's cycle against the JAX package on the
shipped 24,000-row fixture (Chebyshev), with a (V, 3) right-hand side.

In f64 on both sides (the fixture cast, as in test_torch_cycles.py): one
``v_cycle`` at 1e-9 of its largest entry, and ``solve`` for a few cycles
with the same iteration count, the residual of the whole array at rtol
1e-9 and the solution at 1e-9.  Each column of the 2-D cycle equals the
1-D cycle of that column alone at 1e-12 of its largest entry (the
fixture has no fast forms, so both take the ELL path).  With slab forms
attached a 2-D x takes them too (the batched block-window twin on the
CPU): each column of its cycle equals the 1-D slab cycle of that column
at 1e-12 of its largest entry, and its stationary solve takes the ELL
solve's iteration count, the solution at 1e-9 (summation order only).
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

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
KW = dict(smoother="chebyshev")


def _both64(tmp_path):
    with np.load(HALO) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = tmp_path / "halo64.npz"
    np.savez(path, **arrays)
    return jax_load_solver(str(path)), solver_from_numpy(arrays, device="cpu")


def _rhs():
    return np.random.default_rng(7).normal(size=(24000, 3))


def test_multi_rhs_cycle_and_solve_match_jax(tmp_path):
    hj, ht = _both64(tmp_path)
    b = _rhs()
    bj, bt = jnp.asarray(b), torch.as_tensor(b)
    cfg, tcfg = g.MultigridConfig(**KW), gt.MultigridConfig(**KW)
    v_cycle = jax.jit(g.v_cycle, static_argnames=("cfg",))
    xj = np.asarray(v_cycle(hj, jnp.zeros_like(bj), bj, cfg))
    xt = gt.v_cycle(ht, torch.zeros_like(bt), bt, tcfg)
    assert xt.shape == (24000, 3) and xt.dtype == torch.float64
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())

    kw = dict(max_cycles=4, tolerance=1e-12, **KW)
    xj, rel_j, it_j = g.solve(hj, bj, g.MultigridConfig(**kw))
    xt, rel_t, it_t = gt.solve(ht, bt, gt.MultigridConfig(**kw))
    xj = np.asarray(xj)
    assert it_t == int(it_j) == 4
    np.testing.assert_allclose(rel_t, float(rel_j), rtol=1e-9)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())
    # The stopping residual is that of the whole (V, 3) array.
    r = bt - gt.spmv(ht.levels[0].op, xt)
    assert abs(rel_t - float(r.norm() / bt.norm())) <= 1e-12 * rel_t


def test_multi_rhs_columns_and_fast_forms(tmp_path):
    _, ht = _both64(tmp_path)
    b = torch.as_tensor(_rhs())
    cfg = gt.MultigridConfig(**KW)
    x2 = gt.v_cycle(ht, torch.zeros_like(b), b, cfg)
    for j in range(3):
        x1 = gt.v_cycle(ht, torch.zeros_like(b[:, j]), b[:, j], cfg)
        torch.testing.assert_close(x2[:, j], x1, rtol=0,
                                   atol=1e-12 * float(x1.abs().max()))

    hs = gt.attach_slab_operators(ht)
    assert hs.levels[0].banded is not None and hs.levels[0].uw is not None
    xs = gt.v_cycle(hs, torch.zeros_like(b), b, cfg)
    for j in range(3):
        x1 = gt.v_cycle(hs, torch.zeros_like(b[:, j]), b[:, j], cfg)
        torch.testing.assert_close(xs[:, j], x1, rtol=0,
                                   atol=1e-12 * float(x1.abs().max()))
    kw = gt.MultigridConfig(max_cycles=3, tolerance=1e-12, **KW)
    xa, rel_a, it_a = gt.solve(hs, b, kw)
    xb, rel_b, it_b = gt.solve(ht, b, kw)
    assert it_a == it_b == 3
    np.testing.assert_allclose(rel_a, rel_b, rtol=1e-9)
    torch.testing.assert_close(xa, xb, rtol=0,
                               atol=1e-9 * float(xb.abs().max()))
