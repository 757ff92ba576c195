"""The batched block-window kernel B1 against its plain torch twin, on a
card.

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
from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matmat_cuda,
                                                   blockdense_matmat_fast,
                                                   blockdense_matmat_plain)
from gravomg_tpu_torch.ops.slab import slab_from_operator, slab_matvec
from gravomg_tpu_torch.solve.vcycle import attach_slab_operators

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


@pytest.mark.cuda
def test_batched_kernel_matches_twin_on_card(card):
    """Every bucket of every slab form of the 24k fixture (A, U and U^T
    of each level of at least 512 rows), D in {1, 3, 8, 12, 64}, f32 and
    bf16 m, each twice on one input (bitwise equal); then the whole slab
    matvec and one (V, 8) V-cycle on the card against the CPU."""
    hc = attach_slab_operators(load_solver(HALO, device=card), min_rows=512)
    h_cpu = attach_slab_operators(load_solver(HALO, device="cpu"),
                                  min_rows=512)
    gen = torch.Generator(device=card).manual_seed(1)
    rng = np.random.default_rng(0)
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
    """Shapes, types and layouts B1 does not take raise; a CUDA tensor
    never takes the twin; the transposed-tile form refuses a 2-D x."""
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
    before = blockdense_matmat_cuda.launches
    blockdense_matmat_fast(b, x, xp)
    assert blockdense_matmat_cuda.launches == before + 1
