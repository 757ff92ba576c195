"""PyTorch port: the work table of the one-launch transposed-tile kernel
and its plain walk (``mxu_slab_matvec_plain``), on every MXU form of the
24k fixture.

The table is checked exactly.  The walk is held against the JAX
package's ``slab_matvec`` on its own ``slab_from_ell(..., mxu=True)``
form (run through XLA, as ``tests/test_torch_mxu.py`` runs it on the
CPU) at atol 1e-6 * max|y| for f32 m and 2e-3 * max|y| for bf16 m (both
round x to bf16 alike; the bound leaves room for a rounding that falls
the other way), and against the port's per-bucket path at 1e-6 * max|y|:
the same exact products, summed in another order.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravomg_tpu.io.serialization import load_solver as jax_load_solver
from gravomg_tpu.ops import slab as jslab
from gravomg_tpu.solve import vcycle as jv

from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.mxu_cuda import (MXU_SPLIT, mxu_matvec_plain,
                                            mxu_slab_matvec_plain,
                                            plan_bytes, plan_table)
from gravomg_tpu_torch.ops.slab import SlabOperator, slab_matvec
from gravomg_tpu_torch.solve.vcycle import attach_slab_operators

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")
FIELDS = ("banded", "uw", "utw")


@pytest.fixture(scope="module")
def mxu_forms():
    """(label, JAX form, port form) for every MXU form of the fixture."""
    hj = jv.attach_slab_operators(jv.attach_restrictions(
        jax_load_solver(HALO)), mxu=True)
    ht = attach_slab_operators(load_solver(HALO, device="cpu"), mxu=True)
    forms = [(f"L{li} {f}", getattr(lj, f), getattr(lt, f))
             for li, (lj, lt) in enumerate(zip(hj.levels, ht.levels))
             for f in FIELDS if isinstance(getattr(lt, f), SlabOperator)]
    assert len(forms) >= 2 and all(sj is not None and st.mxu
                                   for _, sj, st in forms)
    return forms


def test_work_table_covers_every_real_block_once(mxu_forms):
    """Each real block's segments are covered exactly once by items of
    at most MXU_SPLIT segments, longest first; no padding block has an
    item; an uncut block's item names its original block, a cut block's
    items name consecutive scratch rows in part order, listed once in
    the split table; the bytes of m the table reads are the real
    blocks' tiles, not the padding blocks'."""
    for label, _, st in mxu_forms:
        plan, t = st.plan, plan_table(st.plan)
        inv = st.inv_block_perm.numpy().astype(np.int64)
        nblk = inv.shape[0]
        assert plan.n_out == nblk and nblk * 128 >= st.n_rows, label
        assert plan.shapes == tuple(tuple(b.win_start.shape)
                                    for b in st.buckets)
        offs = np.cumsum([0] + [b.m.shape[0] for b in st.buckets])
        pos = offs[t[:, 0]] + t[:, 1]       # place in the padded bucket list
        orig = np.full(offs[-1], -1)
        orig[inv] = np.arange(nblk)         # -1: a padding block
        assert (orig[pos] >= 0).all(), label
        lens = t[:, 3] - t[:, 2]
        assert lens.min() >= 1 and lens.max() <= MXU_SPLIT
        assert (np.diff(lens) <= 0).all(), "items longest first"
        cover = np.zeros((offs[-1], 24), np.int64)
        for p, s0, s1 in zip(pos, t[:, 2], t[:, 3]):
            cover[p, s0:s1] += 1
        for k, b in enumerate(st.buckets):
            real = orig[offs[k]:offs[k + 1]] >= 0
            want = np.zeros((b.m.shape[0], 24), np.int64)
            want[real, :b.win_start.shape[1]] = 1
            np.testing.assert_array_equal(cover[offs[k]:offs[k + 1]], want)
        real_tiles = sum(int((orig[offs[k]:offs[k + 1]] >= 0).sum())
                         * b.win_start.shape[1]
                         for k, b in enumerate(st.buckets))
        pb = plan_bytes(st.buckets, st.plan)
        assert pb["tiles"] == real_tiles * 128 * 128 * 4 <= st.m_bytes
        assert pb["scratch"] == 2 * plan.n_slots * 512
        assert pb["io"] == (pb["tiles"] + pb["win_start"] + pb["tables"]
                            + pb["x"] + pb["y"])
        direct = t[:, 4] >= 0
        np.testing.assert_array_equal(t[direct, 4], orig[pos[direct]])
        sp = plan.splits.numpy().astype(np.int64)
        slots = -t[~direct, 4] - 1
        assert sorted(slots) == list(range(plan.n_slots))
        assert sorted(sp[:, 0]) == sorted(set(orig[pos[~direct]]))
        by_slot = dict(zip(slots, np.flatnonzero(~direct)))
        for out, first, parts, _ in sp:
            items = [by_slot[first + p] for p in range(parts)]
            assert (orig[pos[items]] == out).all()
            assert parts == -(-t[items[-1], 3] // MXU_SPLIT) >= 2
            np.testing.assert_array_equal(t[items[1:], 2], t[items[:-1], 3])
            assert t[items[0], 2] == 0


def test_plain_walk_matches_jax_and_buckets(mxu_forms):
    """``mxu_slab_matvec_plain`` against the JAX package's slab matvec
    and the port's per-bucket twins (concatenated, un-permuted), f32 and
    bf16 m; ``slab_matvec`` on the CPU is the walk plus the diagonal."""
    rng = np.random.default_rng(17)
    for label, sj, st in mxu_forms:
        x = rng.normal(size=st.n_cols).astype(np.float32)
        xj, xt = jnp.asarray(x), torch.as_tensor(x)
        xp = pad_x(st.buckets[0], xt)
        for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6),
                              (jnp.bfloat16, torch.bfloat16, 2e-3)):
            sjd = sj._replace(buckets=tuple(b._replace(m=b.m.astype(jdt))
                                            for b in sj.buckets))
            std = st._replace(buckets=tuple(b._replace(m=b.m.to(tdt))
                                            for b in st.buckets))
            got = mxu_slab_matvec_plain(std, xt)
            full = slab_matvec(std, xt).numpy()
            if st.diag is not None:
                got = got + st.diag * xt
            got = got.numpy()
            np.testing.assert_array_equal(full, got)
            want = np.asarray(jslab.slab_matvec(sjd, xj, pallas=False)
                              .astype(jnp.float32))
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=tol * scale,
                                       err_msg=f"{label} {tdt} vs JAX")
            ycat = torch.cat([mxu_matvec_plain(b, xt, xp).reshape(-1, 128)
                              for b in std.buckets])
            per_bucket = ycat[std.inv_block_perm].reshape(-1)[:std.n_rows]
            if st.diag is not None:
                per_bucket = per_bucket + st.diag * xt
            np.testing.assert_allclose(got, per_bucket.numpy(),
                                       atol=1e-6 * scale,
                                       err_msg=f"{label} {tdt} vs buckets")
