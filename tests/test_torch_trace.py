"""The port's spans (``utils/profiling.py::span``) on the CPU.

With no profiler running, ``span`` hands back one shared no-op.  Under
``torch.profiler.profile().start()`` (as the benchmark's tracer starts
it), ``mg_solve`` on a 3,000-point torus with slab forms and the bf16
cast opens one ``gmg:mg_solve`` and one ``gmg:mg_solve.cast``, a
``gmg:krylov.iter`` per returned iteration, a
``gmg:krylov.residual_read`` per host norm read (iterations + 2) and a
``gmg:vcycle`` per preconditioner application (iterations + 1), every
``gmg:vcycle.L<l>`` inside a ``gmg:vcycle``; ``heat_geodesics`` on an
icosphere opens ``gmg:rap.L<l>`` twice a level but the coarsest and
``gmg:coarse.factor`` twice.  Both entries return the same bits and the
same ``record=`` keys with the profiler on and off.
"""

import collections

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import icosphere, torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.solve.cg import mg_solve
from gravomg_tpu_torch.solve.vcycle import attach_operators
from gravomg_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _traced(fn):
    """fn() under a profiler started as the benchmark's tracer starts
    it; (its result, the gmg spans as (start_ns, end_ns, name))."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(profiling.PREFIX))
    return out, spans


def _counts(spans):
    return collections.Counter(name[len(profiling.PREFIX):]
                               for _, _, name in spans)


def test_span_gate_and_solve_spans():
    for name in ("mg_solve", "krylov.iter"):
        assert profiling.span(name) is profiling._OFF
    assert profiling.span("vcycle.L", 3) is profiling._OFF
    with profiling.span("mg_solve") as nothing:
        assert nothing is None

    pts = torus_points(3000, seed=31).astype(np.float32)
    pts = pts[morton_order(pts)]
    graph = gt.knn_graph(torch.as_tensor(pts), k=12)
    op, _ = gt.screened_poisson_operator(graph, alpha="auto")
    cfg = gt.MultigridConfig(coarse_threshold=200, smoother="chebyshev",
                             bf16_threshold=1000)
    h, _ = gt.build_hierarchy_device(
        graph, op, cfg, generator=torch.Generator().manual_seed(0))
    h = attach_operators(h.solver, slab_min_rows=750)
    assert h.levels[0].banded is not None
    b = torch.as_tensor(np.random.default_rng(7).normal(size=3000),
                        dtype=torch.float32)

    plain = mg_solve(h, b, cfg)
    traced, spans = _traced(lambda: mg_solve(h, b, cfg))
    assert torch.equal(plain[0], traced[0]) and plain[1:] == traced[1:]
    it = traced[2]
    n = _counts(spans)
    assert n["mg_solve"] == 1 and n["mg_solve.cast"] == 1
    assert n["krylov.iter"] == it
    assert n["krylov.residual_read"] == it + 2
    assert n["vcycle"] == it + 1
    levels = len(h.levels)
    for lvl in range(levels - 1):
        assert n[f"vcycle.L{lvl}"] == it + 1
    assert n["vcycle.coarse"] == it + 1
    cycles = [(s, e) for s, e, name in spans if name == "gmg:vcycle"]
    for s, e, name in spans:
        if name.startswith("gmg:vcycle.L"):
            assert any(cs <= s and e <= ce for cs, ce in cycles), name


def test_heat_refit_spans_and_records():
    v, _ = icosphere(3)
    graph = gt.knn_graph(torch.as_tensor(v), k=8)
    cfg = gt.MultigridConfig(coarse_threshold=64, smoother="chebyshev")
    h = gt.poisson_hierarchy(graph, alpha=0.5, cfg=cfg)
    levels = len(h.solver.levels)
    assert levels >= 3

    rec_off = {}
    phi_off = gt.heat_geodesics(graph, h, source=0, cfg=cfg, record=rec_off)
    rec_on = {}
    phi_on, spans = _traced(lambda: gt.heat_geodesics(
        graph, h, source=0, cfg=cfg, record=rec_on))
    assert torch.equal(phi_off, phi_on)
    assert set(rec_off) == set(rec_on)
    for key in ("heat_iters", "heat_rel", "poisson_iters", "poisson_rel"):
        assert rec_off[key] == rec_on[key]
    n = _counts(spans)
    assert n["heat_geodesics"] == 1
    assert sum(c for name, c in n.items()
               if name.startswith("rap.L")) == 2 * (levels - 1)
    for lvl in range(levels - 1):
        assert n[f"rap.L{lvl}"] == 2
    assert n["coarse.factor"] == 2
    for lvl in range(levels):
        assert n[f"cheb.L{lvl}"] == 2
    for name in ("heat.operators", "heat.field", "heat.scale",
                 "refit_heat_s", "heat_s", "refit_poisson_s", "poisson_s"):
        assert n[name] == 1, name
    assert n["krylov.iter"] == rec_on["heat_iters"] + rec_on["poisson_iters"]
    # Without record= the stages still open their spans.
    _, bare = _traced(lambda: gt.heat_geodesics(graph, h, source=0, cfg=cfg))
    assert _counts(bare)["refit_heat_s"] == 1
