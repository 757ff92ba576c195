"""K1, the block-window kernel, in one launch over all buckets of an
8-row slab form (``slab_matvec_cuda``) against its plain twins, on a
card.

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_k1_card.py

Tolerance: atol 1e-6 * max|y| (the bound of the JAX package's
Pallas-vs-XLA test, tests/test_slab.py): the kernel sums in another
order than the twins.
"""

import os

import numpy as np
import pytest
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator, pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matvec_cuda,
                                                   blockdense_matvec_plain,
                                                   slab_matvec_cuda,
                                                   slab_matvec_plain)
from gravomg_tpu_torch.ops.slab import slab_from_operator, slab_matvec
from gravomg_tpu_torch.solve import vcycle
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


def _close(y, want):
    torch.cuda.synchronize()
    assert y.shape == want.shape
    assert (float((y - want).abs().max())
            <= 1e-6 * float(want.abs().max()))


def _many_windows(card, nw=40, nblk=96):
    """An aligned 8-row operator of ``nw`` windows a block (more than the
    32 lanes of a warp, several chunks of the kernel's ring) whose last
    windows run past x's end (n_cols not a multiple of 128)."""
    gen = torch.Generator(device=card).manual_seed(2)
    n_cols = 128 * 48 - 37
    m = torch.randn((nblk, 8, 128 * nw), device=card, generator=gen)
    ws = 128 * torch.randint(0, 48, (nblk, nw), device=card,
                             generator=gen, dtype=torch.int32)
    empty = torch.zeros((0,), device=card)
    return BlockDenseOperator(
        diag=None, m=m, win_start=ws, esc_rows=empty.long(),
        esc_cols=empty.long(), esc_w=empty, n_rows=8 * nblk, n_cols=n_cols,
        block=8, window=128, window0=128, align=128)


@pytest.mark.cuda
def test_one_launch_matches_twins_on_card(card):
    """Every 8-row slab form of the 24k fixture (A, U and U^T of each
    level of at least 512 rows), f32 and bf16 m: one launch against the
    one-launch twin and against the per-bucket twin route (each bucket's
    twin, the buckets laid end to end, the inv_block_perm gather, the
    diagonal), twice on one input (bitwise equal, one launch each); level
    0's A with an escape chute; a bucket of 40 windows a block over one
    bucket; then the wrappers' refusals."""
    hc = attach_slab_operators(load_solver(HALO, device=card), min_rows=512)
    gen = torch.Generator(device=card).manual_seed(1)
    slabs = _slabs(hc)
    assert len(slabs) >= 5 and not any(s.mxu for s in slabs)
    a0 = slabs[0]
    b0 = a0.buckets[0]
    escaped = a0._replace(buckets=(b0._replace(
        esc_rows=torch.tensor([0, 9, 8 * b0.m.shape[0] - 1], device=card,
                              dtype=b0.esc_rows.dtype),
        esc_cols=torch.tensor([3, 0, a0.n_cols - 1], device=card,
                              dtype=b0.esc_cols.dtype),
        esc_w=torch.tensor([0.5, -1.25, 2.0], device=card)),)
        + a0.buckets[1:])
    for sop in slabs + [escaped]:
        x = torch.randn(sop.n_cols, device=card, generator=gen)
        for mdtype in (torch.float32, torch.bfloat16):
            s = sop._replace(buckets=tuple(
                b._replace(m=b.m.to(mdtype)) for b in sop.buckets))
            before = blockdense_matvec_cuda.launches
            y1 = slab_matvec_cuda(s, x)
            y2 = slab_matvec_cuda(s, x)
            assert blockdense_matvec_cuda.launches == before + 2
            torch.cuda.synchronize()
            assert torch.equal(y1, y2)
            _close(y1, slab_matvec_plain(s, x))
            want = per_bucket_twin(s, x)
            if s.diag is not None:
                want = want + s.diag * x
            _close(y1, want)
            assert blockdense_matvec_cuda.launches == before + 2

    wide = _many_windows(card)
    x = torch.randn(wide.n_cols, device=card, generator=gen)
    xp = pad_x(wide, x)
    for mdtype in (torch.float32, torch.bfloat16):
        b = wide._replace(m=wide.m.to(mdtype))
        y1 = blockdense_matvec_cuda(b, x, xp)
        y2 = blockdense_matvec_cuda(b, x, xp)
        torch.cuda.synchronize()
        assert torch.equal(y1, y2)
        _close(y1, blockdense_matvec_plain(b, x, xp))

    x = torch.randn(a0.n_cols, device=card, generator=gen)
    with pytest.raises(ValueError, match="1-D float32"):
        slab_matvec_cuda(a0, x.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        slab_matvec_cuda(a0._replace(buckets=tuple(
            b._replace(m=b.m.half()) for b in a0.buckets)), x)
    with pytest.raises(ValueError, match="diagonal"):
        slab_matvec_cuda(a0._replace(diag=a0.diag.double()), x)
    wide_form = slab_from_operator(load_solver(HALO, device=card)
                                   .levels[0].op, escape_cap=65536, mxu=True)
    with pytest.raises(ValueError, match="8-row slab form"):
        slab_matvec_cuda(wide_form, x)
    # A CUDA x never takes a twin: slab_matvec launches K1 once.
    before = blockdense_matvec_cuda.launches
    y = slab_matvec(a0, x)
    assert blockdense_matvec_cuda.launches == before + 1
    _close(y, slab_matvec_plain(a0, x))


@pytest.mark.cuda
def test_cycle_launches_equal_slab_matvecs(card):
    """One V-cycle on the fixture with slab forms on every level of at
    least 512 rows: K1's launches equal the cycle's 1-D matvecs on 8-row
    slab forms, and the cycle equals the CPU's at 1e-5 of max|x|."""
    hc = attach_slab_operators(load_solver(HALO, device=card), min_rows=512)
    h_cpu = attach_slab_operators(load_solver(HALO, device="cpu"),
                                  min_rows=512)
    cfg = gt.MultigridConfig(smoother="chebyshev")
    bh = np.random.default_rng(0).normal(size=24000).astype(np.float32)
    inner, count = vcycle.slab_matvec, [0]

    def counted(op, x):
        if x.ndim == 1 and not op.mxu:
            count[0] += 1
        return inner(op, x)

    b = torch.as_tensor(bh, device=card)
    before = blockdense_matvec_cuda.launches
    vcycle.slab_matvec = counted
    try:
        x_card = gt.v_cycle(hc, torch.zeros_like(b), b, cfg)
        torch.cuda.synchronize()
    finally:
        vcycle.slab_matvec = inner
    assert count[0] > 0
    assert blockdense_matvec_cuda.launches - before == count[0]
    bc = torch.as_tensor(bh)
    x_cpu = gt.v_cycle(h_cpu, torch.zeros_like(bc), bc, cfg).numpy()
    np.testing.assert_allclose(x_card.cpu().numpy(), x_cpu, rtol=0,
                               atol=1e-5 * np.abs(x_cpu).max())
