"""Phase 17 of chip_smoke.py (multi-device) on the CPU at 3,000 points
with 2 gloo ranks, and the port's demo against examples/demo.py.

The phase's own checks run as they do on the card (iterations within 1
of the unsharded solve, re-measured residuals, the CG step and the
batched columns against the unsharded ones); B1 is not launched on the
CPU (no slab form at this size, and the CPU takes the twins), and the
NCCL rank runs only on the card.

The demo prints the counts of each stage of the reference workload;
they equal those examples/demo.py prints on the same seed, but for the
prolongation's column count, which JAX pads to a size bucket (384
columns for 372 coarse points) and the port does not.
"""

import importlib.util
import os
import re

import numpy as np
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_multidevice_phase_on_cpu():
    cs = _load("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    out = cs.phase_multidevice(torch, "cpu", 3000, 2, n_rhs=4)
    it = out["unsharded"]["iters"]
    for name in ("halo", "sharded"):
        assert len(out[name]["iters"]) == 1
        assert abs(out[name]["iters"][0] - it) <= 1
        assert max(out[name]["rel"]) <= 1e-8
    assert max(out["step"]["rel_to_unsharded"].values()) <= cs.TOL_COLUMNS
    assert out["batched"]["worst_rel_to_max"] <= 1e-6
    assert out["batched"]["b1_launches"] == [0, 0]
    assert "nccl" not in out and out["peak_bytes"] == [None, None]
    assert out["plan"]["equal_to_record"] is None
    lvl0 = out["plan"]["levels"][0]
    assert all(lvl0[k]["seg_max"] % 8 == 0 for k in ("A", "U", "Ut"))


def test_demo_counts_equal_jax(tmp_path, capsys):
    from gravomg_tpu_torch import demo
    jdemo = _load("jax_demo", os.path.join(ROOT, "examples", "demo.py"))
    jdemo.main(str(tmp_path / "jax"))
    jax_out = capsys.readouterr().out
    mine = demo.main(str(tmp_path / "torch"), device="cpu")
    port_out = capsys.readouterr().out

    def counts(text):
        nums = re.findall(r"-?\d+(?:\.\d+)?", text)
        return [float(v) for v in nums]

    jl, pl = jax_out.splitlines(), port_out.splitlines()
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        if a.startswith("Produced a prolongation operator"):
            # "5000x384 (...)" in JAX, "5000x372 (...)" in the port.
            a, b = a.split("x", 1)[1], b.split("x", 1)[1]
            assert b.startswith(str(mine["n_coarse"]))
            a, b = a.split(" ", 1)[1], b.split(" ", 1)[1]
        if a.startswith("Wrote"):
            continue
        assert counts(a) == counts(b), (a, b)
    assert mine["n_coarse"] == 372 and mine["point_fallbacks"] == 14
    for name in ("fine", "coarse", "projected"):
        pj = np.loadtxt(tmp_path / "jax" / f"{name}.obj", usecols=(1, 2, 3))
        pt = np.loadtxt(tmp_path / "torch" / f"{name}.obj",
                        usecols=(1, 2, 3))
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-6)
