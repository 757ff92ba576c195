"""The transposed-tile CUDA kernel (``ops/mxu_cuda.py``) and the gather
probes' kernel (``ops/window_gather.py``) against their plain torch
twins, on a card.

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_mxu_card.py

Tolerance: atol 1e-6 * max|y|.  The kernels form the same products as
their twins (bf16 m times bf16-rounded x is exact in f32) and sum them
in another order.
"""

import os

import numpy as np
import pytest
import torch

from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.mxu_cuda import (bucket_plan, mxu_matvec_cuda,
                                            mxu_matvec_plain,
                                            mxu_slab_matvec_cuda,
                                            mxu_slab_matvec_fast,
                                            mxu_slab_matvec_plain)
from gravomg_tpu_torch.ops.slab import (SlabOperator, slab_from_operator,
                                        slab_matvec)
from gravomg_tpu_torch.ops.window_gather import (window_gather_cuda,
                                                 window_gather_fast,
                                                 window_gather_plain)
from gravomg_tpu_torch.probes.gather import WD, probe_inputs
from gravomg_tpu_torch.solve.vcycle import attach_slab_operators

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # The twin's f32 matrix products must run in full f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(yk, yp):
    return float((yk - yp).abs().max()) / max(float(yp.abs().max()), 1e-30)


@pytest.mark.cuda
def test_kernels_match_twins_on_card(card):
    """K2 on every transposed-tile form of the 24k fixture, f32 and bf16
    m: each bucket as a work table of one bucket against its twin; the
    one launch over the whole form against the per-bucket twins and the
    plain walk of its table, and twice on one input (bitwise equal);
    each whole slab matvec on the card against the CPU; the gather
    kernel with P1's and P2's starts, twice (bitwise equal)."""
    hc = attach_slab_operators(load_solver(HALO, device=card), mxu=True)
    h_cpu = attach_slab_operators(load_solver(HALO, device="cpu"), mxu=True)
    forms = [(getattr(lc, f), getattr(lh, f))
             for lc, lh in zip(hc.levels, h_cpu.levels)
             for f in ("banded", "uw", "utw")
             if isinstance(getattr(lc, f), SlabOperator)]
    assert len(forms) >= 2
    gen = torch.Generator(device=card).manual_seed(1)
    rng = np.random.default_rng(0)
    for sop, sop_cpu in forms:
        assert sop.mxu and sop_cpu.mxu
        x = torch.randn(sop.n_cols, device=card, generator=gen)
        xp = pad_x(sop.buckets[0], x)
        for mdtype in (torch.float32, torch.bfloat16):
            before = mxu_matvec_cuda.launches
            for b in sop.buckets:
                b = b._replace(m=b.m.to(mdtype))
                yk = mxu_matvec_cuda(b, x, xp, bucket_plan(b))
                yp = mxu_matvec_plain(b, x, xp)
                torch.cuda.synchronize()
                assert _rel(yk, yp) <= 1e-6
            assert mxu_matvec_cuda.launches == before + len(sop.buckets)
            sd = sop._replace(buckets=tuple(
                b._replace(m=b.m.to(mdtype)) for b in sop.buckets))
            y1 = mxu_slab_matvec_cuda(sd, x)
            y2 = mxu_slab_matvec_fast(sd, x)
            ycat = torch.cat([mxu_matvec_plain(b, x, xp).reshape(-1, 128)
                              for b in sd.buckets])
            y_twins = ycat[sd.inv_block_perm].reshape(-1)[:sd.n_rows]
            y_walk = mxu_slab_matvec_plain(sd, x)
            torch.cuda.synchronize()
            assert mxu_matvec_cuda.launches == before + len(sop.buckets) + 2
            assert torch.equal(y1, y2)
            assert _rel(y1, y_twins) <= 1e-6 and _rel(y1, y_walk) <= 1e-6
        xh = rng.normal(size=sop.n_cols).astype(np.float32)
        y_cpu = slab_matvec(sop_cpu, torch.as_tensor(xh)).numpy()
        y_card = slab_matvec(sop, torch.as_tensor(xh, device=card))
        np.testing.assert_allclose(y_card.cpu().numpy(), y_cpu,
                                   atol=1e-6 * np.abs(y_cpu).max())

    x, starts, lidx, w = probe_inputs(20_000, card)
    for st in starts.values():
        before = window_gather_cuda.launches
        yk = window_gather_fast(x, st, lidx, w, WD)
        yp = window_gather_plain(x, st, lidx, w, WD)
        torch.cuda.synchronize()
        assert window_gather_cuda.launches == before + 1
        assert _rel(yk, yp) <= 1e-6
        assert torch.equal(yk, window_gather_cuda(x, st, lidx, w, WD))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_cannot_take(card):
    """Shapes and types the kernels do not take raise; a CUDA tensor
    never takes a twin."""
    h = load_solver(HALO, device=card)
    b = slab_from_operator(h.levels[0].op, escape_cap=65536,
                           mxu=True).buckets[0]
    x = torch.randn(b.n_cols, device=card)
    xp = pad_x(b, x)
    plan = bucket_plan(b)
    with pytest.raises(ValueError, match="float32"):
        mxu_matvec_cuda(b, x.double(), xp, plan)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mxu_matvec_cuda(b._replace(m=b.m.half()), x, xp, plan)
    with pytest.raises(ValueError, match="contiguous"):
        mxu_matvec_cuda(
            b._replace(m=b.m.transpose(2, 3).contiguous().transpose(2, 3)),
            x, xp, plan)
    with pytest.raises(ValueError, match="pad_x"):
        mxu_matvec_cuda(b, x, x, plan)
    vpu = slab_from_operator(h.levels[0].op, escape_cap=65536).buckets[0]
    with pytest.raises(ValueError, match="transposed-tile"):
        mxu_matvec_cuda(vpu, x, pad_x(vpu, x), plan)
    with pytest.raises(ValueError, match="work table"):
        mxu_matvec_cuda(b, x, xp, plan._replace(items=plan.items.long()))
    with pytest.raises(ValueError, match="work table"):
        mxu_matvec_cuda(b, x, xp, plan._replace(
            items=plan.items.t().contiguous().t()))
    with pytest.raises(ValueError, match="work table"):
        mxu_matvec_cuda(b, x, xp, plan._replace(
            shapes=((plan.shapes[0][0] + 8, plan.shapes[0][1]),)))
    sop = slab_from_operator(h.levels[0].op, escape_cap=65536, mxu=True)
    with pytest.raises(ValueError, match="work table"):
        mxu_slab_matvec_cuda(sop._replace(plan=None), x)
    before = mxu_matvec_cuda.launches
    mxu_slab_matvec_fast(sop, x)
    mxu_matvec_cuda(b, x, xp, plan)
    assert mxu_matvec_cuda.launches == before + 2

    xg, starts, lidx, w = probe_inputs(20_000, card)
    st = starts["P1"]
    with pytest.raises(ValueError, match="int32"):
        window_gather_cuda(xg, st, lidx.long(), w, WD)
    # Row counts that the kernel's split over 4 thread blocks of whole
    # 8-row groups does not divide.
    for rows in (40, 1000):
        with pytest.raises(ValueError, match="multiple of 32"):
            window_gather_cuda(xg, st, lidx[:, :rows].contiguous(),
                               w[:, :rows].contiguous(), WD)
    with pytest.raises(ValueError, match="window"):
        window_gather_cuda(xg, st, lidx, w, 16384)
    with pytest.raises(ValueError, match="CUDA"):
        window_gather_cuda(xg.cpu(), st, lidx, w, WD)
