"""Phase 18 of chip_smoke.py (the port's driver surfaces) in its CPU
mode: (a) the ``entry()`` cycle on the CPU against itself (the card's
run holds the card's cycle against it), (b) ``dryrun_multichip`` on 2
gloo ranks on the CPU, each path held to the unsharded MG-PCG on its
fixture, and the refusal of ``device=None`` without enough cards (here,
none).  The bench of (c) runs on the card only; its CPU run is in
tests/test_torch_bench.py.
"""

import importlib.util
import os

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_phase_on_cpu():
    out = _chip_smoke().phase_entry(torch, "cpu")
    assert out["rel_to_cpu"] == 0.0 and out["ms"] is None
    # One Jacobi V-cycle from zero on the 2,562-row fixture.
    assert 1e-3 < out["residual"] < 0.1


def test_dryrun_phase_on_cpu():
    out = _chip_smoke().phase_dryrun(torch, "cpu")
    assert out["unsharded_iters"] == {"entry": 6, "halo": 13}
    (res,) = out["runs"].values()
    assert res["n_devices"] == 2 and res["backend"] == "gloo"
    assert res["batched"]["shape"] == (4, 2562)
    assert res["fast"]["m_rows"] == (1288, 2576)
    assert out["refused"]["n"] == 1 and out["refused"]["s"] < 1.0
