"""``correct`` for the eigenpairs cell (``torus100k.eigs``) on the CPU at
3,000 points, driven as ``run.py`` drives it: the control (the
reference pencil stored in bfloat16) and one eigenvalue of every answer
altered by 10% make it false; a sound run is true."""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run  # noqa: E402
from benchmark.loop import load_call  # noqa: E402

CPU = torch.device("cpu")
CELL = "torus100k.eigs"
SEED = 2**31 + 5


def _measure(call=None):
    return run.measure(CELL, SEED, 1.0, False, CPU,
                       overrides={"points": {"n": 3000}}, call=call)[0]


def _over(res):
    return [name for name, c in res["compared"].items()
            if name != "failed" and c["value"] > c["limit"]]


def test_bench_eigs_control_fails():
    res = _measure(load_call("laplace_eigs").control)
    assert res["correct"] is False and _over(res), res["compared"]


def test_bench_eigs_altered_eigenvalue_fails(monkeypatch):
    mod = load_call("laplace_eigs")
    entry = mod.laplace_eigs

    def altered(*args, **kw):
        theta, x, res = entry(*args, **kw)
        theta = theta.clone()
        theta[5] *= 1.1
        return theta, x, res

    monkeypatch.setattr(mod, "laplace_eigs", altered)
    res = _measure()
    assert res["correct"] is False and "eig_gap" in _over(res)


def test_bench_eigs_sound_run_is_correct():
    res = _measure()
    assert res["correct"] is True and res["failed"] == 0, res["compared"]
