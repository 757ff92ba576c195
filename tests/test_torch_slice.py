"""The whole slice on a 3,000-point Morton-ordered torus: the port's
pipeline (grid kNN, screened Poisson, csrc hierarchy, slab forms from
512 rows so the slab path runs at this size) is written in the
``save_solver`` layout, loaded by the JAX package's ``load_solver``, and
both packages solve with MG-PCG.

Tolerances: iterations within 1, both at 1e-8; solutions within 1e-5
relative at f64 and 4e-5 at f32 (the operator's condition number,
~1.1e5, bounds how closely two f32 solves stopped at 1e-8 agree).
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.io.serialization import load_solver as jax_load_solver

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.io.serialization import (save_solver,
                                                solver_from_numpy,
                                                solver_to_numpy)
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator
from gravomg_tpu_torch.solve.vcycle import slab_slots
from gravomg_tpu_torch.types import INVALID_INDEX

torch.set_num_threads(2)

N = 3000
HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


def test_whole_slice_matches_jax(tmp_path):
    pts = torus_points(N, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph = gt.grid_knn_graph_nosync(pts, 16, margin=2.4,
                                     device="cpu")
    op, _ = gt.screened_poisson_operator(graph, alpha="auto")
    cfg = gt.MultigridConfig(coarse_threshold=100, smoother="chebyshev")
    jcfg = g.MultigridConfig(coarse_threshold=100, smoother="chebyshev")
    h = gt.build_hierarchy_host(graph, op, cfg)
    sizes = [lvl.op.num_vertices for lvl in h.levels]
    assert sizes[0] == N and len(sizes) >= 3 and sizes[-1] <= 100, sizes
    hs = gt.attach_slab_operators(h, min_rows=512)
    slots = slab_slots(hs, 512)
    assert {(0, "banded"), (0, "uw")} <= set(slots)
    assert all(getattr(hs.levels[li], f) is not None for li, f in slots)
    b = np.random.default_rng(0).normal(size=N).astype(np.float32)

    for dtype in (np.float32, np.float64):
        arrays = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
                  for k, v in solver_to_numpy(hs).items()}
        ht = gt.attach_slab_operators(solver_from_numpy(arrays, device="cpu"),
                                      min_rows=512)
        path = str(tmp_path / f"solver_{np.dtype(dtype).name}.npz")
        save_solver(path, ht)
        hj = jax_load_solver(path)
        bd = b.astype(dtype)
        xj, rel_j, it_j = g.mg_pcg(hj, jnp.asarray(bd), jcfg)
        xt, rel_t, it_t = gt.mg_pcg(ht, torch.as_tensor(bd), cfg)
        assert float(rel_j) <= 1e-8 and rel_t <= 1e-8, (float(rel_j), rel_t)
        assert abs(it_t - int(it_j)) <= 1, (it_t, int(it_j))
        xj = np.asarray(xj)
        # Measured 1.8e-5 at f32 (each ~1e-5 from the f64 solution).
        tol = 4e-5 if dtype == np.float32 else 1e-5
        assert np.linalg.norm(xt.numpy() - xj) <= tol * np.linalg.norm(xj)

    # Below bf16_threshold the default solve is f32 MG-PCG.
    _, rel_p, it_p = gt.mg_pcg(hs, torch.as_tensor(b), cfg)
    assert gt.mg_solve(hs, torch.as_tensor(b), cfg)[1:] == (rel_p, it_p)


def test_unordered_level_keeps_ell_on_cpu():
    """The 24k fixture's level 0 under a random row order: its blocks need
    more than 24 windows, so, as in the JAX package, it gets no slab form
    (None, on the CPU as on a card, tests/test_torch_kernel_card.py) and
    its matvec is the ELL one; attach_fast_operators then gives it the
    uniform block-dense form, whose matvec agrees with the ELL one at
    1e-6 * max|y| (another summation order)."""
    h = gt.load_solver(HALO, device="cpu")
    op = h.levels[0].op
    perm = torch.as_tensor(np.random.default_rng(3).permutation(
        op.num_vertices))
    inv = torch.argsort(perm).to(torch.int32)
    nbr = op.neighbors[perm]
    nbr = torch.where(nbr != INVALID_INDEX,
                      inv[torch.where(nbr != INVALID_INDEX, nbr, 0).long()],
                      nbr)
    shuffled = op._replace(neighbors=nbr, offdiag=op.offdiag[perm],
                           diag=op.diag[perm])
    h1 = h._replace(levels=(gt.SolverLevel(shuffled, None, None),
                            h.levels[-1]))
    hs = gt.attach_slab_operators(h1)
    assert (0, "banded") in slab_slots(h1) and hs.levels[0].banded is None
    x = torch.randn(op.num_vertices,
                    generator=torch.Generator().manual_seed(0))
    y_ell = gt.spmv(shuffled, x)
    assert torch.equal(gt.level_matvec(hs.levels[0], x), y_ell)
    hf = gt.attach_fast_operators(hs)
    assert isinstance(hf.levels[0].banded, BlockDenseOperator)
    torch.testing.assert_close(gt.level_matvec(hf.levels[0], x), y_ell,
                               rtol=0, atol=1e-6 * float(y_ell.abs().max()))
