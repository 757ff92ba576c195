"""The block-window kernel's plain twin against the JAX package's Pallas
kernel (interpret mode), bucket by bucket on the 24k fixture's level-0
slab, and the dispatch between kernel and twin.

The CUDA kernel itself cannot run on a CPU; tests/test_torch_kernel_card.py
holds it against the twin on a card.  Tolerance: atol 1e-6 * max|y|, the
bound of the JAX package's Pallas-vs-XLA test (tests/test_slab.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravomg_tpu.ops.blockdense import BlockDenseOperator as JaxBlockDense
from gravomg_tpu.ops.pallas_blockdense import blockdense_matvec_pallas

from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops.blockdense import pad_x
from gravomg_tpu_torch.ops.blockdense_cuda import (blockdense_matvec_cuda,
                                                   blockdense_matvec_fast,
                                                   blockdense_matvec_plain)
from gravomg_tpu_torch.ops.slab import slab_from_operator

torch.set_num_threads(2)

HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


@pytest.fixture(scope="module")
def halo_a0():
    return slab_from_operator(load_solver(HALO, device="cpu").levels[0].op,
                              escape_cap=65536)


def _as_jax(b):
    """The same bucket as a JAX BlockDenseOperator (arrays equal JAX's
    own conversion, tests/test_torch_slab.py)."""
    return JaxBlockDense(None, *(jnp.asarray(t.numpy()) for t in
                                 (b.m.float(), b.win_start, b.esc_rows,
                                  b.esc_cols, b.esc_w)),
                         b.n_rows, b.n_cols, b.block, b.window, b.window0,
                         b.align)


def test_twin_matches_pallas_interpret(halo_a0):
    """Every bucket, f32 and bf16 m, f32 x."""
    x = np.random.default_rng(4).normal(size=halo_a0.n_cols)
    x = x.astype(np.float32)
    assert len(halo_a0.buckets) >= 3
    for b in halo_a0.buckets:
        bj = _as_jax(b)
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            xt = torch.as_tensor(x)
            yt = blockdense_matvec_plain(b._replace(m=b.m.to(tdt)), xt,
                                         pad_x(b, xt)).numpy()
            yj = np.asarray(blockdense_matvec_pallas(
                bj._replace(m=bj.m.astype(jdt)), jnp.asarray(x),
                interpret=True, group=8))
            np.testing.assert_allclose(yt, yj, atol=1e-6 * np.abs(yj).max())


def test_fast_dispatch_and_cuda_wrapper_checks(halo_a0):
    """CPU tensors take the twin; the kernel wrapper refuses anything
    that is not on the card and counts no launch."""
    b = halo_a0.buckets[0]
    x = torch.randn(halo_a0.n_cols,
                    generator=torch.Generator().manual_seed(0))
    xp = pad_x(b, x)
    assert torch.equal(blockdense_matvec_fast(b, x, xp),
                       blockdense_matvec_plain(b, x, xp))
    before = blockdense_matvec_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        blockdense_matvec_cuda(b, x, xp)
    assert blockdense_matvec_cuda.launches == before
    with pytest.raises(ValueError, match="128"):
        blockdense_matvec_plain(b._replace(align=0), x, xp)
