"""The hierarchy build on a card against the same build on the CPU.

Every test here needs a CUDA device and skips without one.  This module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_build_card.py

A 24,000-point Morton-ordered torus, f32, the bench's recipe.
Tolerances: samples and parents equal (every comparison of the sampling
and of the parent sweeps does the same f32 operations on both devices);
U rows at 1e-5 with under 0.5% of the rows flipped (the card fuses
multiply-adds where the CPU does not, so a borderline containment test
may go the other way); MG-PCG iterations within 1.
"""

import numpy as np
import pytest
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.probes.build_check import u_rows_diff

N = 24000


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the build is compared across "
                    "devices)")
    return torch.device("cuda")


def _problem(device):
    pts = torus_points(N, seed=1).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph = gt.grid_knn_graph_nosync(pts, 16, margin=2.4, device=device)
    op, _ = gt.screened_poisson_operator(graph, alpha="auto")
    return graph, op, gt.MultigridConfig(coarse_threshold=500,
                                         smoother="chebyshev")


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, tuple):
        for item in obj:
            yield from _tensors(item)


@pytest.mark.cuda
def test_build_on_card_matches_cpu(card):
    g_c, op_c, cfg = _problem(card)
    g_h, op_h, _ = _problem("cpu")
    assert torch.equal(g_c.neighbors.cpu(), g_h.neighbors)
    b = torch.as_tensor(np.random.default_rng(0).normal(size=N)
                        .astype(np.float32))
    for build in (gt.build_hierarchy,
                  lambda g, o, c: gt.build_hierarchy_device(
                      g, o, c, priorities=[torch.randperm(
                          N, generator=torch.Generator().manual_seed(7))] * 8
                  )[0]):
        hc, hh = build(g_c, op_c, cfg), build(g_h, op_h, cfg)
        assert [g.num_vertices for g in hc.graphs] == [
            g.num_vertices for g in hh.graphs]
        assert len(hc.levels) >= 2
        for lc, lh in zip(hc.levels, hh.levels):
            assert torch.equal(lc.samples.cpu(), lh.samples)
            assert torch.equal(lc.parents.cpu(), lh.parents)
            err, flipped = u_rows_diff(
                lc.u.cols.cpu().numpy(), lc.u.weights.cpu().numpy(),
                lh.u.cols.numpy(), lh.u.weights.numpy())
            assert err.max() < 1e-5, err.max()
            assert flipped.sum() <= max(2, lc.stats.n_fine // 200)
        _, rel_c, it_c = gt.mg_pcg(hc.solver, b.to(card), cfg)
        _, rel_h, it_h = gt.mg_pcg(hh.solver, b, cfg)
        assert rel_c <= 1e-8 and rel_h <= 1e-8
        assert abs(it_c - it_h) <= 1, (it_c, it_h)


@pytest.mark.cuda
def test_device_build_stays_on_card(card):
    graph, op, cfg = _problem(card)
    gen = torch.Generator(device=card).manual_seed(0)
    h, stats = gt.build_hierarchy_device(graph, op, cfg, generator=gen)
    tensors = list(_tensors(h))
    assert len(tensors) > 40
    assert all(t.device.type == "cuda" for t in tensors)
    assert len(stats) == len(h.levels) and all(
        isinstance(s.n_coarse, int) for s in stats)
    # The same seed gives the same hierarchy, run after run.
    gen = torch.Generator(device=card).manual_seed(0)
    h2, _ = gt.build_hierarchy_device(graph, op, cfg, generator=gen)
    assert all(torch.equal(a, b) for a, b in zip(tensors, _tensors(h2)))
