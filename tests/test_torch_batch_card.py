"""The batched block-window kernel B1 against its plain torch twin, on a
card: over one bucket, and in one launch over all buckets of a slab form
(``slab_matmat_cuda``) against the per-bucket twin route (each bucket's
twin, the buckets laid end to end, the ``inv_block_perm`` gather).

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_batch_card.py

Tolerance: atol 1e-6 * max|Y| per bucket (K1's bound, tests/test_slab.py
for the Pallas-vs-XLA pair): the kernel sums in another order than the
twin's batched product.
"""

import os

import numpy as np
import pytest
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator, pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matmat_cuda,
                                                   blockdense_matmat_plain,
                                                   slab_matmat_cuda,
                                                   slab_matmat_fast)
from gravomg_tpu_torch.ops.slab import slab_from_operator, slab_matvec
from gravomg_tpu_torch.solve.vcycle import attach_slab_operators
from test_torch_b1_util import per_bucket_twin

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _slabs(h):
    return [getattr(lvl, f) for lvl in h.levels
            for f in ("banded", "uw", "utw") if getattr(lvl, f) is not None]


def _many_windows(card, nw=40, nblk=96):
    """An aligned 8-row operator of ``nw`` windows a block, more than the
    32 lanes of a warp and more than one chunk of the kernel's ring, with
    nine entries in ten zero."""
    gen = torch.Generator(device=card).manual_seed(2)
    n_cols = 128 * 48
    m = torch.randn((nblk, 8, 128 * nw), device=card, generator=gen)
    m = m * (torch.rand(m.shape, device=card, generator=gen) < 0.1)
    ws = 128 * torch.randint(0, n_cols // 128, (nblk, nw), device=card,
                             generator=gen, dtype=torch.int32)
    empty = torch.zeros((0,), device=card)
    return BlockDenseOperator(
        diag=None, m=m, win_start=ws, esc_rows=empty.long(),
        esc_cols=empty.long(), esc_w=empty, n_rows=8 * nblk, n_cols=n_cols,
        block=8, window=128, window0=128, align=128)


@pytest.mark.cuda
def test_batched_kernel_matches_twin_on_card(card):
    """Every bucket of every slab form of the 24k fixture (A, U and U^T
    of each level of at least 512 rows), D in {1, 3, 8, 12, 64}, f32 and
    bf16 m, each twice on one input (bitwise equal), and so a bucket of
    40 windows a block at D in {3, 64}; one launch over all
    buckets of each form against the per-bucket twin route, D in {3, 5,
    64, 70} (an odd D, and one above 64: two column passes), f32 and bf16
    m, twice (bitwise equal, one launch each); then the whole slab matvec
    and one (V, 8) V-cycle on the card against the CPU."""
    hc = attach_slab_operators(load_solver(HALO, device=card), min_rows=512)
    h_cpu = attach_slab_operators(load_solver(HALO, device="cpu"),
                                  min_rows=512)
    gen = torch.Generator(device=card).manual_seed(1)
    rng = np.random.default_rng(0)
    wide = _many_windows(card)
    for d in (3, 64):
        x = torch.randn((wide.n_cols, d), device=card, generator=gen)
        xp = pad_x(wide, x)
        for mdtype in (torch.float32, torch.bfloat16):
            b = wide._replace(m=wide.m.to(mdtype))
            y1 = blockdense_matmat_cuda(b, x, xp)
            y2 = blockdense_matmat_cuda(b, x, xp)
            yp = blockdense_matmat_plain(b, x, xp)
            torch.cuda.synchronize()
            assert torch.equal(y1, y2)
            assert (float((y1 - yp).abs().max())
                    <= 1e-6 * float(yp.abs().max()))
    for sop, sop_cpu in zip(_slabs(hc), _slabs(h_cpu)):
        for d in (1, 3, 8, 12, 64):
            x = torch.randn((sop.n_cols, d), device=card, generator=gen)
            xp = pad_x(sop.buckets[0], x)
            for mdtype in (torch.float32, torch.bfloat16):
                before = blockdense_matmat_cuda.launches
                for b in sop.buckets:
                    b = b._replace(m=b.m.to(mdtype))
                    y1 = blockdense_matmat_cuda(b, x, xp)
                    y2 = blockdense_matmat_cuda(b, x, xp)
                    yp = blockdense_matmat_plain(b, x, xp)
                    torch.cuda.synchronize()
                    assert torch.equal(y1, y2)
                    assert (float((y1 - yp).abs().max())
                            <= 1e-6 * float(yp.abs().max()))
                assert (blockdense_matmat_cuda.launches
                        == before + 2 * len(sop.buckets))
        for d in (3, 5, 64, 70):
            x = torch.randn((sop.n_cols, d), device=card, generator=gen)
            for mdtype in (torch.float32, torch.bfloat16):
                s = sop._replace(buckets=tuple(
                    b._replace(m=b.m.to(mdtype)) for b in sop.buckets))
                before = blockdense_matmat_cuda.launches
                y1 = slab_matmat_cuda(s, x)
                y2 = slab_matmat_cuda(s, x)
                assert blockdense_matmat_cuda.launches == before + 2
                yp = per_bucket_twin(s, x)
                torch.cuda.synchronize()
                assert y1.shape == (s.n_rows, d) and torch.equal(y1, y2)
                assert (float((y1 - yp).abs().max())
                        <= 1e-6 * float(yp.abs().max()))
        xh = rng.normal(size=(sop.n_cols, 5)).astype(np.float32)
        y_cpu = slab_matvec(sop_cpu, torch.as_tensor(xh)).numpy()
        y_card = slab_matvec(sop, torch.as_tensor(xh, device=card))
        np.testing.assert_allclose(y_card.cpu().numpy(), y_cpu,
                                   atol=1e-6 * np.abs(y_cpu).max())

    cfg = gt.MultigridConfig(smoother="chebyshev")
    bh = rng.normal(size=(24000, 8)).astype(np.float32)
    xs = {}
    for name, h in (("card", hc), ("cpu", h_cpu)):
        b = torch.as_tensor(bh, device=h.coarse_chol.device)
        xs[name] = gt.v_cycle(h, torch.zeros_like(b), b, cfg).cpu().numpy()
    np.testing.assert_allclose(xs["card"], xs["cpu"], rtol=0,
                               atol=1e-5 * np.abs(xs["cpu"]).max())


@pytest.mark.cuda
def test_batched_wrapper_refuses_what_the_kernel_cannot_take(card):
    """Shapes, types and layouts B1 does not take raise, over one bucket
    and in one launch over a form (x not float32, a 1-D x, the
    transposed-tile form); a CUDA tensor never takes the twin; the
    transposed-tile form refuses a 2-D x."""
    h = load_solver(HALO, device=card)
    b = slab_from_operator(h.levels[0].op, escape_cap=65536).buckets[0]
    x = torch.randn((b.n_cols, 4), device=card)
    xp = pad_x(b, x)
    with pytest.raises(ValueError, match="2-D float32"):
        blockdense_matmat_cuda(b, x.double(), xp)
    with pytest.raises(ValueError, match="2-D float32"):
        blockdense_matmat_cuda(b, x[:, 0], xp)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        blockdense_matmat_cuda(b._replace(m=b.m.half()), x, xp)
    with pytest.raises(ValueError, match="pad_x"):
        blockdense_matmat_cuda(b, x, xp[:, :3])
    with pytest.raises(ValueError, match="pad_x"):
        blockdense_matmat_cuda(b, x, xp.t().contiguous().t())
    wide = slab_from_operator(h.levels[0].op, escape_cap=65536,
                              mxu=True)
    with pytest.raises(ValueError, match="8-row"):
        blockdense_matmat_cuda(wide.buckets[0]._replace(
            m=torch.zeros((wide.buckets[0].m.shape[0], 128,
                           128 * wide.buckets[0].nw), device=card)),
            x, xp)
    with pytest.raises(ValueError, match="1-D x only"):
        slab_matvec(wide, x)
    sop = slab_from_operator(h.levels[0].op, escape_cap=65536)
    for bad, match in ((x.double(), "2-D float32"), (x[:, 0], "2-D float32"),
                       (x.half(), "2-D float32")):
        with pytest.raises(ValueError, match=match):
            slab_matmat_cuda(sop, bad)
    with pytest.raises(ValueError, match="8-row slab form"):
        slab_matmat_cuda(wide, x)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        slab_matmat_cuda(sop._replace(buckets=tuple(
            bb._replace(m=bb.m.half()) for bb in sop.buckets)), x)
    before = blockdense_matmat_cuda.launches
    slab_matmat_fast(sop, x)
    assert blockdense_matmat_cuda.launches == before + 1
