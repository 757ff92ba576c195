"""Phases 3, 5 and 6 of chip_smoke.py (K1 in one launch on every 8-row
slab form, the main path's solves with K1's launch account, K1's timing
row and bound) on the CPU at 3,000 points, so that a fault of the
script's own bookkeeping shows before a run on the card.  Slab forms go
on every level of at least 750 rows there (``slab_min_rows``).  The CPU
takes the plain twins: no launch is counted and no time is measured."""

import importlib.util
import os

import torch

torch.set_num_threads(2)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_k1_phases_on_cpu():
    cs = _chip_smoke()
    n = 3000
    problem = cs.k1_problem(torch, "cpu", n)
    h = problem[1]
    check = cs.phase_kernel_check(torch, "cpu", n, h)
    assert check["forms"] and check["worst_rel"] <= cs.TOL_KERNEL
    assert {r["against"] for r in check["forms"]} == {
        "one-launch twin", "per-bucket twins"}
    main = cs.phase_main(torch, "cpu", n, problem)
    assert main["vcycle_ms"] is None and main["launches"] == 0
    assert main["cycle"]["launches"] == 0 and main["cycle"]["matvecs"] > 0
    for name in ("mg_pcg", "mg_solve"):
        assert main[name]["rel"] <= 1e-8
        assert abs(main[f"{name}_greedy"]["iters"] - main[name]["iters"]) <= 2
    timing = cs.phase_timing(torch, "cpu", n, h)
    for name in ("float32", "bfloat16"):
        row = timing[name]
        assert row["bound_by"] == "bytes" and row["bound_ms"] > 0
        assert row["twin_rel_err"] <= cs.TOL_KERNEL
    assert timing["bfloat16"]["m_bytes"] * 2 == timing["float32"]["m_bytes"]
