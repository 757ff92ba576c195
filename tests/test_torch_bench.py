"""The port's bench (``gravomg_tpu_torch/bench.py``) on the CPU.

(1) Its SciPy baseline cycle against the port's ``v_cycle`` in f64 on
one 3,000-point hierarchy of the bench's recipe (2 levels, so the coarse
solve carries the whole correction), so that ``vs_baseline`` divides
equal work.  The baseline factors the coarsest operator with a shift of
1e-10 x max|diag|.  Such a shift moves the coarse solve by at most
1e-10 x kappa relative, kappa = max|diag(A_c)| / lambda_min(A_c); the
port's cycle with an unshifted factor is held to twice that (the
correction then passes through U and the post-smoother), which must lie
within 1e-6 of max|x|.  With the port's own factor, which settles on the
same shift in f64, the two agree to f64 rounding: 10 kappa eps.

(2) ``python -m gravomg_tpu_torch.bench --n 3000 --device cpu`` prints
exactly one JSON line on stdout with the four keys, one ``#`` line on
stderr, and both solves reach 1e-8.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from gravomg_tpu_torch import bench
from gravomg_tpu_torch.probes.mxu_levels import bench_hierarchy
from gravomg_tpu_torch.solve.coarse import factor_coarse
from gravomg_tpu_torch.solve.vcycle import v_cycle

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _f64(h, shifts):
    """``h`` in f64, its coarse factor made anew with ``shifts``."""
    levels = []
    for lvl in h.levels:
        op = lvl.op._replace(offdiag=lvl.op.offdiag.double(),
                             diag=lvl.op.diag.double())
        u = (None if lvl.u is None
             else lvl.u._replace(weights=lvl.u.weights.double()))
        ut = (None if lvl.ut is None
              else lvl.ut._replace(weights=lvl.ut.weights.double()))
        levels.append(lvl._replace(op=op, u=u, ut=ut))
    return h._replace(levels=tuple(levels),
                      coarse_chol=factor_coarse(levels[-1].op, shifts))


def test_scipy_baseline_cycle_matches_port():
    cfg, h, _, _, _ = bench_hierarchy(3000, "cpu")
    assert [lvl.op.num_vertices for lvl in h.levels] == [3000, 385]
    sh = bench.scipy_hierarchy(h)
    assert sh.shift == 1e-10
    ac = sh.a[-1].toarray()
    ac = 0.5 * (ac + ac.T)
    kappa = np.abs(np.diag(ac)).max() / np.linalg.eigvalsh(ac)[0]
    b = np.random.default_rng(31).standard_normal(3000)
    x = bench.scipy_vcycle(sh, cfg, np.zeros(3000), b)
    scale = float(np.abs(x).max())
    tol_shift = 2 * 1e-10 * kappa
    assert tol_shift <= 1e-6
    for shifts, tol in (((0.0,), tol_shift),
                        (bench.COARSE_SHIFTS,
                         10 * kappa * np.finfo(np.float64).eps)):
        h64 = _f64(h, shifts)
        y = v_cycle(h64, torch.zeros(3000, dtype=torch.float64),
                    torch.as_tensor(b), cfg).numpy()
        assert np.abs(y - x).max() <= tol * scale, (shifts, tol)


def test_bench_cli_on_cpu(tmp_path):
    out = tmp_path / "bench.json"
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "gravomg_tpu_torch.bench", "--n", "3000",
         "--device", "cpu", "--out", str(out)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "vcycle_ms_3000v" and line["unit"] == "ms"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert len([ln for ln in proc.stderr.splitlines()
                if ln.startswith("#")]) == 1
    rec = json.loads(out.read_text())
    assert rec["vcycle_ms"] == line["value"]
    for name in ("mg_pcg", "mg_solve"):
        assert rec[name]["rel"] <= 1e-8, rec[name]
    assert rec["mg_solve"]["path"] == "f32_pcg"
    assert rec["levels"] == [3000, 385]
    assert rec["cpu_vcycle_ms"] > 0 and rec["cpu_build_s"] > 0
