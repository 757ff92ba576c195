"""PyTorch port vs the JAX package: the uniform block-dense forms of
``attach_fast_operators`` on the 24k fixture, and the whole transposed-tile
(``mxu``) path, ``attach_fast_operators(attach_slab_operators(h,
mxu=True))``, solved with bf16-preconditioned flexible CG.

Converted arrays and window-0 anchors are compared exactly.  Uniform
matvecs at atol 1e-6 * max|y| (the summation order differs).  The
solves: both reach 1e-8, iteration counts within 1.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.ops.blockdense import BlockDenseOperator as JaxBlockDense
from gravomg_tpu.ops.blockdense import block_anchors as jax_block_anchors
from gravomg_tpu.ops.blockdense import blockdense_matvec as jax_bd_matvec
from gravomg_tpu.ops.slab import SlabOperator as JaxSlab
from gravomg_tpu.solve import vcycle as jv

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.ops.blockdense import (BlockDenseOperator,
                                              block_anchors, blockdense_matvec)
from gravomg_tpu_torch.ops.slab import SlabOperator

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
FIELDS = ("banded", "uw", "utw")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _kind(op):
    if op is None:
        return None
    if isinstance(op, (SlabOperator, JaxSlab)):
        return "mxu" if op.mxu else "slab"
    assert isinstance(op, (BlockDenseOperator, JaxBlockDense))
    return "uniform"


def test_fast_operators_match_jax():
    """Every level's uniform A, U and U^T forms equal JAX's array for
    array (m, win_start, escape chute, geometry), as do the block_anchors
    of U and U^T, and each form's matvec agrees with JAX's."""
    hj = jv.attach_restrictions(jax_load_solver(HALO))
    ht = gt.attach_restrictions(gt.load_solver(HALO, device="cpu"))
    gj, gtt = {}, {}
    fj = jv.attach_fast_operators(hj, used_geometry=gj)
    ft = gt.attach_fast_operators(ht, used_geometry=gtt)
    assert gtt == gj and len(gj) == 9, (gtt, gj)
    rng = np.random.default_rng(11)
    n_forms = 0
    for li, (lj, lt) in enumerate(zip(fj.levels, ft.levels)):
        for f in FIELDS:
            oj, ot = getattr(lj, f), getattr(lt, f)
            assert _kind(oj) == _kind(ot), (li, f)
            if ot is None:
                continue
            n_forms += 1
            assert (ot.n_rows, ot.n_cols, ot.block, ot.window, ot.window0,
                    ot.align) == (oj.n_rows, oj.n_cols, oj.block, oj.window,
                                  oj.window0, oj.align), (li, f)
            for a in ("m", "win_start", "esc_rows", "esc_cols", "esc_w"):
                np.testing.assert_array_equal(_np(getattr(ot, a)),
                                              _np(getattr(oj, a)),
                                              err_msg=f"L{li} {f} {a}")
            x = rng.normal(size=ot.n_cols).astype(np.float32)
            want = _np(jax_bd_matvec(oj, jnp.asarray(x)))
            got = _np(blockdense_matvec(ot, torch.as_tensor(x)))
            np.testing.assert_allclose(got, want,
                                       atol=1e-6 * np.abs(want).max())
        if lt.u is not None:
            ones_j = jnp.ones_like(lj.u.cols, bool)
            ones_t = torch.ones_like(lt.u.cols, dtype=torch.bool)
            vm_j = lj.ut.rows != g.INVALID_INDEX
            for blk in (8, 64, 256):
                np.testing.assert_array_equal(
                    _np(block_anchors(lt.u.cols, ones_t, blk)),
                    _np(jax_block_anchors(lj.u.cols, ones_j, blk)))
                np.testing.assert_array_equal(
                    _np(block_anchors(lt.ut.safe_rows(), lt.ut.mask, blk)),
                    _np(jax_block_anchors(lj.ut.safe_rows(), vm_j, blk)))
    assert n_forms == 9


def test_mxu_path_solves_like_jax():
    """The transposed-tile slab forms on level 0 (A and U; U^T keeps its
    gather table, as in the JAX package), uniform forms on levels 1-2;
    then, in both packages, MG-PCG on that hierarchy (iterations within
    1) and flexible CG preconditioned by its bf16 cast, with the f32 one
    as the outer operator (iterations within 3).

    Why 3 for the bf16 solve: rounding x to bf16 makes the bf16 V-cycle
    discontinuous in its input, so f32 roundoff (another summation
    order) flips roundings.  Measured on this fixture, the packages' f32
    cycles agree to 2e-7, their bf16 cycles only to 4.6e-4-1.0e-3 (the
    bf16 error itself is 3e-3), and the counts scatter with the
    summation order alone: on this input the JAX package took 24
    iterations under this harness's settings (x64, 8 virtual CPU
    devices) and 26 under XLA's defaults, the port 24 with 2 torch
    threads and 25 with 4."""
    hj = jv.attach_fast_operators(jv.attach_slab_operators(
        jv.attach_restrictions(jax_load_solver(HALO)), mxu=True))
    ht = gt.attach_fast_operators(gt.attach_slab_operators(
        gt.load_solver(HALO, device="cpu"), mxu=True))
    kinds = [[_kind(getattr(lvl, f)) for f in FIELDS] for lvl in ht.levels]
    assert kinds == [[_kind(getattr(lvl, f)) for f in FIELDS]
                     for lvl in hj.levels]
    assert kinds[0] == ["mxu", "mxu", None], kinds
    assert kinds[1] == kinds[2] == ["uniform"] * 3, kinds
    b = np.random.default_rng(12).normal(size=24000).astype(np.float32)
    cfg = gt.MultigridConfig(smoother="chebyshev")
    jcfg = g.MultigridConfig(smoother="chebyshev")
    bj, bt = jnp.asarray(b), torch.as_tensor(b)
    _, rel_j, it_j = g.mg_pcg(hj, bj, jcfg)
    _, rel_t, it_t = gt.mg_pcg(ht, bt, cfg)
    assert float(rel_j) <= 1e-8 and rel_t <= 1e-8, (float(rel_j), rel_t)
    assert abs(it_t - int(it_j)) <= 1, (it_t, int(it_j))
    _, rel_j, it_j = g.mg_fcg(jv.cast_fast_operators(hj, jnp.bfloat16), bj,
                              jcfg, h_outer=hj)
    _, rel_t, it_t = gt.mg_fcg(gt.cast_fast_operators(ht, torch.bfloat16),
                               bt, cfg, h_outer=ht)
    assert float(rel_j) <= 1e-8 and rel_t <= 1e-8, (float(rel_j), rel_t)
    assert abs(it_t - int(it_j)) <= 3, (it_t, int(it_j))
