"""The block-window CUDA kernel against its plain torch twin, on a card.

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_card.py

Tolerance: atol 1e-6 * max|y| (the bound of the JAX package's
Pallas-vs-XLA test, tests/test_slab.py): the kernel sums in another
order than the twin.
"""

import os

import numpy as np
import pytest
import torch

from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import BlockDenseOperator, pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matvec_cuda,
                                                   blockdense_matvec_fast,
                                                   blockdense_matvec_plain)
from gravomg_tpu_torch.ops.slab import slab_from_operator, slab_matvec
from gravomg_tpu_torch.solve.spmv import spmv
from gravomg_tpu_torch.solve.vcycle import (SolverLevel,
                                            attach_fast_operators,
                                            attach_slab_operators,
                                            level_matvec, slab_slots)
from gravomg_tpu_torch.types import INVALID_INDEX

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
def test_kernel_matches_twin_on_card(card):
    """Every bucket of every slab form of the 24k fixture (A, U and U^T
    of each level of at least 512 rows), f32 and bf16 m; then each whole
    slab matvec on the card against the CPU."""
    hc = attach_slab_operators(load_solver(HALO, device=card), min_rows=512)
    h_cpu = attach_slab_operators(load_solver(HALO, device="cpu"),
                                  min_rows=512)
    slots = slab_slots(hc, 512)
    assert {f for _, f in slots} == {"banded", "uw", "utw"}
    assert all(getattr(hc.levels[li], f) is not None for li, f in slots)
    gen = torch.Generator(device=card).manual_seed(1)
    rng = np.random.default_rng(0)
    for sop, sop_cpu in zip(_slabs(hc), _slabs(h_cpu)):
        x = torch.randn(sop.n_cols, device=card, generator=gen)
        xp = pad_x(sop.buckets[0], x)
        for mdtype in (torch.float32, torch.bfloat16):
            before = blockdense_matvec_cuda.launches
            for b in sop.buckets:
                b = b._replace(m=b.m.to(mdtype))
                yk = blockdense_matvec_cuda(b, x, xp)
                yp = blockdense_matvec_plain(b, x, xp)
                torch.cuda.synchronize()
                assert (float((yk - yp).abs().max())
                        <= 1e-6 * float(yp.abs().max()))
            assert (blockdense_matvec_cuda.launches
                    == before + len(sop.buckets))
        xh = rng.normal(size=sop.n_cols).astype(np.float32)
        y_cpu = slab_matvec(sop_cpu, torch.as_tensor(xh)).numpy()
        y_card = slab_matvec(sop, torch.as_tensor(xh, device=card))
        np.testing.assert_allclose(y_card.cpu().numpy(), y_cpu,
                                   atol=1e-6 * np.abs(y_cpu).max())


@pytest.mark.cuda
def test_wrapper_refuses_what_the_kernel_cannot_take(card):
    """Shapes and types the kernel does not take raise; a level that
    gets no slab form gets the uniform form from attach_fast_operators."""
    h = load_solver(HALO, device=card)
    b = slab_from_operator(h.levels[0].op, escape_cap=65536).buckets[0]
    x = torch.randn(b.n_cols, device=card)
    xp = pad_x(b, x)
    with pytest.raises(ValueError, match="float32"):
        blockdense_matvec_cuda(b, x.double(), xp)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        blockdense_matvec_cuda(b._replace(m=b.m.half()), x, xp)
    with pytest.raises(ValueError, match="contiguous"):
        blockdense_matvec_cuda(
            b._replace(m=b.m.transpose(1, 2).contiguous().transpose(1, 2)),
            x, xp)
    with pytest.raises(ValueError, match="pad_x"):
        blockdense_matvec_cuda(b, x, x)
    # A CUDA tensor never takes the twin.
    before = blockdense_matvec_cuda.launches
    blockdense_matvec_fast(b, x, xp)
    assert blockdense_matvec_cuda.launches == before + 1

    # A level that gets no slab form (random row order: its blocks need
    # more than 24 windows) stays None on the card, as in the JAX
    # package; attach_fast_operators then gives it the uniform form,
    # which runs plain torch, as the JAX package runs it through XLA.
    op = h.levels[0].op
    perm = torch.as_tensor(np.random.default_rng(3).permutation(
        op.num_vertices), device=card)
    inv = torch.argsort(perm).to(torch.int32)
    nbr = op.neighbors[perm]
    valid = nbr != INVALID_INDEX
    nbr = torch.where(valid, inv[torch.where(valid, nbr, 0).long()], nbr)
    shuffled = op._replace(neighbors=nbr, offdiag=op.offdiag[perm],
                           diag=op.diag[perm])
    h1 = h._replace(levels=(SolverLevel(shuffled, None, None), h.levels[-1]))
    hs = attach_slab_operators(h1)
    assert hs.levels[0].banded is None
    hf = attach_fast_operators(hs)
    assert isinstance(hf.levels[0].banded, BlockDenseOperator)
    xs = torch.randn(op.num_vertices, device=card)
    y_ell = spmv(shuffled, xs)
    torch.testing.assert_close(level_matvec(hf.levels[0], xs), y_ell, rtol=0,
                               atol=1e-6 * float(y_ell.abs().max()))
