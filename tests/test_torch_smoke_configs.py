"""Phase 19 of chip_smoke.py (c1, c2 and c3 of the config sweep) on the
CPU at 3,000 points, and the sweep's command line
(``python -m gravomg_tpu_torch.bench_configs``) in smoke mode on the CPU,
so that a fault of the bookkeeping shows before a run on the card.  The
kernels' launch counts are 0 here (the CPU takes the plain twins) and
the device numbers are None."""

import importlib.util
import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_configs_phase_on_cpu():
    out = _chip_smoke().phase_configs(torch, "cpu", 3000)
    c1, c2, c3 = (out["rows"][k] for k in ("c1", "c2", "c3"))
    assert out["k1_launches"] == out["b1_launches"] == 0
    assert c1["config"] == "c1_sphere5k" and c1["n"] == 3000
    assert len(c1["levels"]) == 1 and len(c2["levels"]) <= 2
    for row, key in ((c1, "solve"), (c2, "pcg_solve")):
        assert row["rel_residual"] <= 1e-8 and 1 <= row["iters"] <= 30
        assert row[f"{key}_s"] > 0 and len(row[f"{key}_runs_s"]) == 5
        assert row[f"{key}_device_s"] is None
        assert row[f"{key}_busy_share"] is None
        assert row["peak_bytes"] is None
    assert c2["vcycle8_s"] > 0
    assert c3["finite"] and c3["n"] == 3000
    assert c3["heat_rel"] <= 1e-8 and c3["poisson_rel"] <= 1e-8


def test_sweep_cli_on_cpu(tmp_path):
    out = tmp_path / "configs.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    cmd = [sys.executable, "-m", "gravomg_tpu_torch.bench_configs"]
    proc = subprocess.run(
        cmd + ["c1", "c5b", "--smoke", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert out.read_text().splitlines() == lines
    rows = [json.loads(ln) for ln in lines]
    assert [r["config"] for r in rows] == ["header", "c1_sphere5k",
                                           "c5b_meshes64", "footer"]
    assert rows[0]["smoke"] and rows[0]["card"] is None
    assert rows[1]["n"] == 2000 and rows[1]["rel_residual"] <= 1e-8
    c5b = rows[2]
    assert c5b["meshes"] == c5b["stacked"] == 8 and c5b["n"] == 2000
    assert c5b["padded_rows_zero"] and c5b["worst_mesh_rel"] <= 1e-5
    assert c5b["padded_rows"] == c5b["real_rows_max"]
    # An unknown config is refused before anything runs.
    bad = subprocess.run(cmd + ["c4", "--device", "cpu"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2 and not bad.stdout
