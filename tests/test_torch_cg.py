"""PyTorch port vs the JAX package at f32: MG-preconditioned CG on the
two shipped fixtures (ELL forms), and on the 24k fixture with slab forms
(the block-window kernel's twin on the CPU) and bf16 flexible CG.

Tolerances: iteration counts within 1 of JAX's, every run at 1e-8.
"""

import os

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


def _load32(name, tmp_path):
    """Both packages at f32 throughout (the stored f64 Chebyshev bounds
    too, so the JAX side does not promote under x64)."""
    with np.load(os.path.join(ASSETS, name)) as z:
        arrays = {k: (z[k].astype(np.float32) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = tmp_path / f"{name}_32.npz"
    np.savez(path, **arrays)
    return jax_load_solver(str(path)), solver_from_numpy(arrays, device="cpu")


def test_mg_pcg_f32_matches(tmp_path):
    for name, smoother in FIXTURES.items():
        hj, ht = _load32(name, tmp_path)
        b = np.random.default_rng(1).normal(
            size=ht.levels[0].op.num_vertices).astype(np.float32)
        _, rel_j, it_j = g.mg_pcg(hj, jnp.asarray(b),
                                  g.MultigridConfig(smoother=smoother))
        xt, rel_t, it_t = gt.mg_pcg(ht, torch.as_tensor(b),
                                    gt.MultigridConfig(smoother=smoother))
        assert xt.dtype == torch.float32
        assert float(rel_j) <= 1e-8 and rel_t <= 1e-8, (float(rel_j), rel_t)
        assert abs(it_t - int(it_j)) <= 1, (name, it_t, int(it_j))


def test_slab_solvers_on_halo_fixture(tmp_path):
    """With slab forms on level 0: f32 MG-PCG within 1 iteration of the
    JAX package's, and the bf16-FCG that ``mg_solve`` takes at or above
    ``bf16_threshold`` reaches 1e-8.

    bf16 window matrices cost iterations at this size (14 against 8 in
    f32 when written); the JAX package's non-kernel bf16 path, which also
    rounds x to bf16, needs 23 here, so the bound is 2x the f32 count."""
    hj, ht = _load32("halo_hierarchy.npz", tmp_path)
    hs = gt.attach_slab_operators(ht)
    assert hs.levels[0].banded is not None and hs.levels[0].uw is not None
    b = np.random.default_rng(2).normal(size=24000).astype(np.float32)
    _, rel_j, it_j = g.mg_pcg(hj, jnp.asarray(b),
                              g.MultigridConfig(smoother="chebyshev"))
    _, rel_s, it_s = gt.mg_pcg(hs, torch.as_tensor(b),
                               gt.MultigridConfig(smoother="chebyshev"))
    assert rel_s <= 1e-8 and abs(it_s - int(it_j)) <= 1, (rel_s, it_s,
                                                          int(it_j))
    cfg16 = gt.MultigridConfig(smoother="chebyshev", bf16_threshold=0)
    _, rel16, it16 = gt.mg_solve(hs, torch.as_tensor(b), cfg16)
    assert rel16 <= 1e-8 and it16 <= 2 * it_s, (rel16, it16, it_s)
