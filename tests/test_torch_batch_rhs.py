"""Many right-hand sides on one hierarchy: the port's (V, D) cycle with
slab and uniform forms against JAX's ``jax.vmap`` of its 1-D cycle (the
c5 recipe of scripts/bench_configs.py), and the batched block-window
twin against the 1-D one.

The cycle runs on the shipped 24,000-row fixture in f64 on both sides
(cast as tests/test_torch_multirhs.py casts it): level 0 gets 8-row slab
forms, the levels below uniform forms.  JAX's vmapped cycle reaches the
slab form's non-kernel matvec with one column at a time; the port's
(V, 8) cycle runs the batched twin of B1 once for all columns.  The
port's columns equal JAX's at 1e-9 of the largest entry (summation
order only), and the port's own 1-D cycles at 1e-12.

The twins: B1's plain twin against K1's, column by column on every
bucket of every slab form of the fixture (A, U, U^T of each level of at
least 512 rows), D in {1, 3, 64}, f32 and bf16 m, at 1e-6 of max|y| (a
batched product against a broadcast sum).  The uniform forms' 2-D
matvec against ``jax.vmap`` of JAX's at 1e-6 of max|y|.

JAX's forms are the port's arrays handed over (:func:`_to_jax`): the
conversions are held equal array for array in tests/test_torch_slab.py
and tests/test_torch_fast_operators.py, and JAX's own attach takes 40 s
of compiles here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

import gravomg_tpu as g
from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.ops.blockdense import BlockDenseOperator as JaxBlockDense
from gravomg_tpu.ops.blockdense import blockdense_matvec as jax_bd_matvec
from gravomg_tpu.ops.slab import SlabOperator as JaxSlab

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.ops.blockdense import blockdense_matvec, pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matmat_plain,
                                                   blockdense_matvec_plain)
from gravomg_tpu_torch.ops.slab import SlabOperator
from gravomg_tpu_torch.io.serialization import solver_from_numpy

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
KW = dict(smoother="chebyshev")
FIELDS = ("banded", "uw", "utw")


def _both64(tmp_path):
    with np.load(HALO) as z:
        arrays = {k: (z[k].astype(np.float64) if z[k].dtype.kind == "f"
                      else z[k]) for k in z.files}
    path = tmp_path / "halo64.npz"
    np.savez(path, **arrays)
    return (jax_load_solver(str(path)),
            solver_from_numpy(arrays, device="cpu"))


def _to_jax(op):
    """A fast form of the port as the JAX package's (slab forms with its
    non-kernel bucket matvec)."""
    if op is None:
        return None
    if isinstance(op, SlabOperator):
        return JaxSlab(_j(op.diag), tuple(_to_jax(b) for b in op.buckets),
                       _j(op.inv_block_perm), op.n_rows, op.n_cols,
                       op.block, use_pallas=False, mxu=op.mxu)
    return JaxBlockDense(_j(op.diag), _j(op.m), _j(op.win_start),
                         _j(op.esc_rows), _j(op.esc_cols), _j(op.esc_w),
                         op.n_rows, op.n_cols, op.block, op.window,
                         op.window0, op.align)


def _j(t):
    return None if t is None else jnp.asarray(t.numpy())


def test_rhs_batch_cycle_matches_jax_vmap(tmp_path):
    hj, ht = _both64(tmp_path)
    ht = gt.attach_fast_operators(gt.attach_slab_operators(ht))
    hj = hj._replace(levels=tuple(
        lvl._replace(**{f: _to_jax(getattr(lt, f)) for f in FIELDS})
        for lvl, lt in zip(hj.levels, ht.levels)))
    assert isinstance(ht.levels[0].banded, SlabOperator)
    assert not ht.levels[0].banded.mxu
    cfg, tcfg = g.MultigridConfig(**KW), gt.MultigridConfig(**KW)
    bs = np.random.default_rng(21).normal(size=(8, 24000))

    xj = np.asarray(jax.jit(jax.vmap(
        lambda b: g.v_cycle(hj, jnp.zeros_like(b), b, cfg)))(
            jnp.asarray(bs)))
    b2 = torch.as_tensor(bs.T.copy())
    x2 = gt.v_cycle(ht, torch.zeros_like(b2), b2, tcfg)
    assert x2.shape == (24000, 8) and x2.dtype == torch.float64
    np.testing.assert_allclose(x2.numpy().T, xj, rtol=0,
                               atol=1e-9 * np.abs(xj).max())
    for j in range(8):
        x1 = gt.v_cycle(ht, torch.zeros_like(b2[:, j]), b2[:, j], tcfg)
        torch.testing.assert_close(x2[:, j], x1, rtol=0,
                                   atol=1e-12 * float(x1.abs().max()))


def test_batched_twin_and_uniform_matmat():
    rng = np.random.default_rng(22)
    hs = gt.attach_slab_operators(gt.load_solver(HALO, device="cpu"),
                                  min_rows=512)
    slabs = [getattr(lvl, f) for lvl in hs.levels for f in FIELDS
             if getattr(lvl, f) is not None]
    assert len(slabs) >= 5
    for sop in slabs:
        for d in (1, 3, 64):
            x = torch.as_tensor(rng.normal(size=(sop.n_cols, d))
                                .astype(np.float32))
            xp = pad_x(sop.buckets[0], x)
            assert xp.shape == (xp.shape[0], d) and xp.is_contiguous()
            for dt in (torch.float32, torch.bfloat16):
                for b in sop.buckets:
                    b = b._replace(m=b.m.to(dt))
                    y = blockdense_matmat_plain(b, x, xp)
                    assert y.shape == (b.n_rows, d)
                    for j in range(d):
                        xj = x[:, j].contiguous()
                        y1 = blockdense_matvec_plain(b, xj, pad_x(b, xj))
                        torch.testing.assert_close(
                            y[:, j], y1, rtol=0,
                            atol=1e-6 * float(y1.abs().max()))

    ht = gt.attach_fast_operators(gt.load_solver(HALO, device="cpu"))
    ops = [getattr(lvl, f) for lvl in ht.levels for f in FIELDS
           if getattr(lvl, f) is not None]
    assert len(ops) == 9
    xs = [rng.normal(size=(op.n_cols, 6)).astype(np.float32) for op in ops]
    jops = [_to_jax(op) for op in ops]
    yjs = jax.jit(lambda vs: [
        jax.vmap(lambda v, o=o: jax_bd_matvec(o, v), in_axes=1,
                 out_axes=1)(v) for o, v in zip(jops, vs)])(
                     [jnp.asarray(x) for x in xs])
    for op, x, yj in zip(ops, xs, yjs):
        yj = np.asarray(yj)
        yt = blockdense_matvec(op, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(yt, yj, rtol=0,
                                   atol=1e-6 * np.abs(yj).max())
