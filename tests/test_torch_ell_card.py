"""The ELL kernel E1 (``csrc/ell_spmv.cu``) against its plain twin
``spmv_plain`` on a card, on a kNN Laplacian with padding, and inside a
CUDA graph.

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_ell_card.py

Tolerance: each entry within 1e-6 of its row's sum of absolute terms
(``probes/ell.py::check``): the kernel sums the same f32 products as the
twin, in slot order with fused multiply-adds where the twin reduces in
its own order.
"""

import pytest
import torch

from gravomg_tpu_torch import bench_configs as bc
from gravomg_tpu_torch.geometry.laplacian import graph_laplacian
from gravomg_tpu_torch.ops.ell_cuda import ell_spmv_cuda
from gravomg_tpu_torch.probes.ell import check, shuffled_slots
from gravomg_tpu_torch.solve.spmv import spmv

N = 20_000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def operators(card):
    """The c6 recipe's front end at 20,000 points on the card: its kNN
    Laplacian (symmetrised, so rows pad to the widest), the screened
    operator, the Laplacian with each row's slots shuffled, so that
    padding sits between real slots, the Laplacian without its last slot
    column (K % 4 != 0), and the Laplacian's table at a 4-byte offset
    from 16-byte alignment (the last two read one slot a load)."""
    rec = bc.c6_inputs(N)
    graph, screened = bc.front_end(rec.points, rec.k, alpha="spectral",
                                   device=card)
    lap, _ = graph_laplacian(graph, "invdist")
    assert bool((~lap.mask).any()) and lap.neighbors.shape[1] % 4 == 0
    gen = torch.Generator(device=card).manual_seed(7)
    return {"L": lap, "A": screened,
            "L shuffled": shuffled_slots(lap, gen),
            "L K-1": lap._replace(
                neighbors=lap.neighbors[:, :-1].contiguous(),
                offdiag=lap.offdiag[:, :-1].contiguous()),
            "L unaligned": lap._replace(neighbors=_unaligned(lap.neighbors),
                                        offdiag=_unaligned(lap.offdiag))}


def _unaligned(t):
    """A contiguous copy of ``t`` one element past 16-byte alignment."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape).copy_(t)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(card, operators):
    """On a 1-D x and at D = 1 (lanes over slots), 3 and 37 (a column a
    lane; 37 tiles its columns), 8 (four a lane), 12 and 36 (twelve a
    lane, LOBPCG's L X and L S), and at D = 12 on an x 4 bytes past
    16-byte alignment (a column a lane): one launch a call
    (``.launches`` up by exactly one, through the wrapper and through
    ``spmv``), bitwise repeatable, each entry within the tolerance of the
    twin; the shuffled operator within it of the unshuffled twin."""
    gen = torch.Generator(device=card).manual_seed(8)
    for label, op in operators.items():
        for shape in ((N,), (N, 1), (N, 3), (N, 8), (N, 12), (N, 36),
                      (N, 37), "offset"):
            if shape == "offset":
                x = _unaligned(torch.randn((N, 12), generator=gen,
                                           device=card))
            else:
                x = torch.randn(shape, generator=gen, device=card)
            before = ell_spmv_cuda.launches
            y1 = ell_spmv_cuda(op, x)
            assert ell_spmv_cuda.launches == before + 1, (label, shape)
            y2 = spmv(op, x)
            assert ell_spmv_cuda.launches == before + 2, (label, shape)
            torch.cuda.synchronize()
            assert y1.shape == x.shape and torch.equal(y1, y2), (label, shape)
            res = check(op, x, y1)
            assert res["within_tol"], (label, shape, res)
            if label in ("L shuffled", "L unaligned"):
                assert check(operators["L"], x, y1)["within_tol"], shape


@pytest.mark.cuda
def test_graph_replay_equals_eager(card, operators):
    """A product captured in a ``torch.cuda.CUDAGraph`` and replayed on
    new contents of its input equals the eager product bit for bit; the
    replay passes no launch through the wrapper, so ``.launches`` counts
    the eager launches and the capture only."""
    op = operators["L"]
    gen = torch.Generator(device=card).manual_seed(9)
    for d in (1, 12, 36):
        x = torch.randn((N, d), generator=gen, device=card)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            spmv(op, x)                       # warm-up, off the capture
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = ell_spmv_cuda.launches
        with torch.cuda.graph(graph):
            y = spmv(op, x)
        assert ell_spmv_cuda.launches == before + 1
        for _ in range(3):
            x.copy_(torch.randn((N, d), generator=gen, device=card))
            graph.replay()
            want = spmv(op, x)
            torch.cuda.synchronize()
            assert torch.equal(y, want), d
        assert ell_spmv_cuda.launches == before + 4
