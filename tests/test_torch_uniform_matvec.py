"""The uniform kernel's dispatch on the CPU (``ops/uniform_cuda.py``;
the kernel itself runs in ``tests/test_torch_uniform_card.py``).

The kernel's plain twin is ``blockdense_matvec``, the plain path.  The
dispatch sends only one form with a 1-D float32 CUDA x to the kernel;
on the CPU every form takes the twin, and no cycle launches the kernel.
"""

import os
import types

import numpy as np
import pytest
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.io.serialization import load_solver
from gravomg_tpu_torch.ops import uniform_cuda
from gravomg_tpu_torch.ops.uniform_cuda import (uniform_matvec,
                                                uniform_matvec_cuda)
from gravomg_tpu_torch.parallel.batch import stack_solvers
from gravomg_tpu_torch.solve.vcycle import attach_operators
from test_torch_uniform_util import random_forms, uniform_forms

torch.set_num_threads(2)
HALO = os.path.join(os.path.dirname(__file__), "..", "assets",
                    "halo_hierarchy.npz")


def _dispatch_routes(monkeypatch, op):
    """Which route ``uniform_matvec`` takes for stand-ins of x that
    claim to be CUDA tensors (no card needed)."""
    routes = []
    monkeypatch.setattr(uniform_cuda, "uniform_matvec_cuda",
                        lambda o, x: routes.append("kernel"))
    monkeypatch.setattr(uniform_cuda, "blockdense_matvec",
                        lambda o, x: routes.append("plain"))
    stacked = op._replace(win_start=op.win_start[None])
    for form, ndim, dtype, cuda in ((op, 1, torch.float32, True),
                                    (op, 2, torch.float32, True),
                                    (stacked, 2, torch.float32, True),
                                    (op, 1, torch.float64, True),
                                    (op, 1, torch.float32, False)):
        uniform_matvec(form, types.SimpleNamespace(is_cuda=cuda, ndim=ndim,
                                                   dtype=dtype))
    return routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cpu_paths_stay_plain(dtype, monkeypatch):
    """The 24k fixture's levels under 4,096 rows get uniform forms from
    ``attach_operators`` (A, U and U^T of levels 1 and 2).  With m in
    ``dtype``, the real cycle on the CPU (1-D x, a 2-D x, a stack of
    hierarchies) never launches the kernel, and the wrapper refuses a
    CPU x; stand-ins for CUDA tensors show the dispatch's routes."""
    forms = random_forms("cpu")
    h = attach_operators(load_solver(HALO, device="cpu"))
    assert {lab for lab, _ in uniform_forms(h)} == {
        "L1 A", "L1 U", "L1 U^T", "L2 A", "L2 U", "L2 U^T"}
    before = uniform_matvec_cuda.launches
    cfg = gt.MultigridConfig(smoother="chebyshev")
    hd = gt.cast_fast_operators(h, dtype)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=(24000, 3)),
                        dtype=torch.float32)
    gt.v_cycle(hd, torch.zeros_like(b[:, 0]), b[:, 0], cfg)
    gt.v_cycle(hd, torch.zeros_like(b), b, cfg)
    small = gt.attach_fast_operators(load_solver(HALO, device="cpu"))
    hb = stack_solvers([small, small])
    bb = torch.stack([b[:, 1], b[:, 2]])
    gt.batched_v_cycle(hb, torch.zeros_like(bb), bb, cfg)
    assert uniform_matvec_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        uniform_matvec_cuda(forms[0][1], forms[0][2])

    assert _dispatch_routes(monkeypatch, forms[1][1]) == [
        "kernel", "plain", "plain", "plain", "plain"]
