"""The uniform kernel (``csrc/uniform_matvec.cu``) against its plain twin
``blockdense_matvec`` on a card, at the 1M main path's shapes and on
random forms, and a 1M ``mg_solve`` through it.

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_uniform_card.py

Tolerance: each row within 1e-5 of its sum of absolute terms
(``probes/uniform.py::check``, which says why: f32 sums in another
order).
"""

import numpy as np
import pytest
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.ops.blockdense import blockdense_matvec
from gravomg_tpu_torch.ops.uniform_cuda import (uniform_matvec,
                                                uniform_matvec_cuda)
from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
from gravomg_tpu_torch.probes.uniform import check
from gravomg_tpu_torch.solve import vcycle
from test_torch_uniform_util import random_forms, uniform_forms


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def main_path(card):
    """The bench's 1M recipe, its hierarchy built on the card, with the
    forms ``attach_operators`` gives it (uniform forms on level 4)."""
    cfg, h, _, _, _ = bench_hierarchy(1_000_000, card)
    return cfg, gt.attach_operators(h)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(card, main_path):
    """The uniform forms of the 1M hierarchy (A, U and U^T of level 4)
    and the random forms of ``test_torch_uniform_util``, m in f32 and
    bf16: one launch a call (``.launches`` up by exactly one), bitwise
    repeatable, against the twin; ``uniform_matvec`` launches it for a
    1-D float32 x; then the wrapper's refusals."""
    _, h = main_path
    attached = uniform_forms(h)
    assert {lab for lab, _ in attached} >= {"L4 A", "L4 U", "L4 U^T"}
    gen = torch.Generator(device=card).manual_seed(5)
    forms = random_forms(card) + [
        (lab, op, torch.randn(op.n_cols, generator=gen, device=card))
        for lab, op in attached]
    for label, op, x in forms:
        for dtype in (torch.float32, torch.bfloat16):
            form = op._replace(m=op.m.to(dtype))
            before = uniform_matvec_cuda.launches
            y1 = uniform_matvec_cuda(form, x)
            assert uniform_matvec_cuda.launches == before + 1, label
            y2 = uniform_matvec(form, x)
            assert uniform_matvec_cuda.launches == before + 2, label
            torch.cuda.synchronize()
            assert torch.equal(y1, y2), label
            assert check(form, x, y1)["within_tol"], label

    op, x = forms[1][1], forms[1][2]
    with pytest.raises(ValueError, match="1-D float32"):
        uniform_matvec_cuda(op, x.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        uniform_matvec_cuda(op._replace(m=op.m.half()), x)
    with pytest.raises(ValueError, match="diagonal"):
        uniform_matvec_cuda(op._replace(diag=op.diag.double()), x)
    with pytest.raises(ValueError, match="escape chute"):
        uniform_matvec_cuda(op._replace(esc_rows=op.esc_rows.long()), x)
    with pytest.raises(ValueError, match="one form"):
        uniform_matvec_cuda(op._replace(m=op.m[None],
                                        win_start=op.win_start[None]), x)
    before = uniform_matvec_cuda.launches
    uniform_matvec(op, torch.stack([x, x], dim=1))
    uniform_matvec(op, x.double())
    assert uniform_matvec_cuda.launches == before


@pytest.mark.cuda
def test_mg_solve_through_kernel(card, main_path, monkeypatch):
    """A 1M ``mg_solve`` (f32 FCG, the bf16 cycle) through the kernel and
    through the plain path: the kernel's launches equal the cycle's 1-D
    matvecs on uniform forms, and the iteration counts differ by at most
    one."""
    cfg, h = main_path
    b = torch.as_tensor(np.random.default_rng(0).normal(size=1_000_000)
                        .astype(np.float32), device=card)
    count = [0]

    def counted(op, x):
        if x.ndim == 1 and not op.stacked:
            count[0] += 1
        return uniform_matvec(op, x)

    before = uniform_matvec_cuda.launches
    monkeypatch.setattr(vcycle, "uniform_matvec", counted)
    _, rel, iters = gt.mg_solve(h, b, cfg)
    torch.cuda.synchronize()
    assert count[0] > 0
    assert uniform_matvec_cuda.launches - before == count[0]
    assert rel <= cfg.tolerance

    monkeypatch.setattr(vcycle, "uniform_matvec", blockdense_matvec)
    _, rel_plain, iters_plain = gt.mg_solve(h, b, cfg)
    assert uniform_matvec_cuda.launches - before == count[0]
    assert rel_plain <= cfg.tolerance
    assert abs(iters - iters_plain) <= 1
