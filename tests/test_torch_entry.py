"""The port's driver entry (``gravomg_tpu_torch/entry.py``) against the
JAX one (``__graft_entry__.py``).

(1) ``entry(device="cpu")``'s V-cycle against JAX's ``entry()`` cycle:
the same fixture and the same f32 b, both in f32, at 1e-5 of the JAX
cycle's largest entry.  JAX's entry points its compile cache into the
checkout; the test switches that off (it does not touch the cycle).

(2) ``dryrun_multichip(2, device="cpu")`` on 2 gloo ranks: each solve
to the tolerance within 1 iteration of JAX's unsharded ``mg_pcg`` on its
fixture (the entry fixture: 6 iterations to 4.078e-9; the halo fixture,
b from seed 1: 13), the batched cycle's shape, the fine halo_frac
below 0.25; and ``device=None`` with fewer cards than ranks raises.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gravomg_tpu as gj
from gravomg_tpu.io.serialization import load_solver as jax_load_solver

from gravomg_tpu_torch import entry as ge

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _jax_entry(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(module, "_enable_compile_cache", lambda: None)
    return module


def test_entry_cycle_matches_jax(monkeypatch):
    fn_j, (hj, xj, bj) = _jax_entry(monkeypatch).entry()
    yj = np.asarray(jax.jit(fn_j)(hj, xj, bj))
    fn, (h, x, b) = ge.entry(device="cpu")
    assert b.dtype == torch.float32 and x.abs().max() == 0
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
    y = fn(h, x, b).numpy()
    assert y.dtype == yj.dtype == np.float32
    np.testing.assert_allclose(y, yj, rtol=0,
                               atol=1e-5 * float(np.abs(yj).max()))
    jax.clear_caches()


def test_dryrun_two_gloo_ranks():
    cfg = gj.MultigridConfig()
    want = {}
    for key, path, seed in (("entry", ge.ENTRY_FIXTURE, 0),
                            ("halo", ge.HALO_FIXTURE, 1)):
        hj = jax_load_solver(path)
        v = hj.levels[0].op.num_vertices
        b = jnp.asarray(np.random.default_rng(seed).normal(size=v),
                        jnp.float32)
        _, rel, it = gj.mg_pcg(hj, b, cfg)
        assert float(rel) <= cfg.tolerance
        want[key] = int(it)
    assert want == {"entry": 6, "halo": 13}
    out = ge.dryrun_multichip(2, device="cpu")
    assert out["backend"] == "gloo" and out["n_devices"] == 2
    assert out["batched"]["shape"] == (4, 2562)
    for name, key in (("sharded", "entry"), ("fast", "entry"),
                      ("halo", "halo")):
        assert out[name]["rel"] < 1e-8, name
        assert abs(out[name]["iters"] - want[key]) <= 1, (name, want)
    assert out["halo"]["halo_frac"] < 0.25 and out["halo"]["v"] == 24000
    # Rank 0 holds half of level 0's blocks of m.
    assert out["fast"]["m_rows"] == (1288, 2576)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ge.dryrun_multichip(2)
    jax.clear_caches()
