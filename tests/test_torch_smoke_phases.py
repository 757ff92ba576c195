"""Phases 13-16 of chip_smoke.py (the apps, LOBPCG, many right-hand
sides on one hierarchy, a stacked mesh collection) on the CPU at a small
n, so that a fault of the script's own bookkeeping shows before a run on
the card.  The kernels' launch counts are not asserted here: the CPU
takes the plain twins, and gives no device time (the times are None)."""

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


def test_apps_and_lobpcg_phases_on_cpu():
    cs = _chip_smoke()
    apps = cs.phase_apps(torch, "cpu", 3000)
    heat, smooth = apps["heat"], apps["smooth"]
    assert apps["n"] == 3000 and heat["rising"] and heat["phi0"] == 0.0
    assert heat["heat_rel"] <= 1e-8 and heat["poisson_rel"] <= 1e-8
    assert len(heat["bin_means"]) == 8
    assert smooth["finite"] and smooth["steps"][0]["cycles"] >= 1
    # heat's float32 ELL products take E1's CPU twin: no launch.
    assert heat["ell_products"] > 0 and heat["e1_launches"] == 0
    lob = cs.phase_lobpcg(torch, "cpu", 2000)
    assert 1 <= lob["iters"] == len(lob["block_s"]) == len(lob["rr_s"]) <= 40
    assert lob["orth_err"] <= 1e-4 and lob["peak_bytes"] is None
    assert len(lob["lams"]) == 12
    # Slab forms from 500 rows at 2,000 points: the (V, 12) cycle takes
    # them, through B1's CPU twin (no launch off the card).
    assert lob["slab_matvecs"] > 0 and lob["b1_launches"] == 0
    assert lob["ell_products"] > 0 and lob["e1_launches"] == 0


def test_batch_phases_on_cpu():
    cs = _chip_smoke()
    rhs = cs.phase_rhs_batch(torch, "cpu", 3000, 4)
    assert rhs["n"] == 3000 and rhs["d"] == 4
    assert rhs["worst_column_rel"] <= cs.TOL_COLUMNS
    assert rhs["batch_ms"] is None and rhs["b1_launches"] == 0
    mesh = cs.phase_meshes(torch, "cpu", 4, 1000)
    assert mesh["meshes"] == 4 and mesh["padded_rows_zero"]
    assert mesh["worst_mesh_rel"] <= cs.TOL_COLUMNS
    assert mesh["padded_rows"] == mesh["real_rows_max"]
    assert 1 <= mesh["solve_iters"] <= 200 and mesh["peak_bytes"] is None
