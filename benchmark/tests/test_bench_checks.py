"""``correct`` comes out false for the controls and for the faults a
cell can have, on the CPU at a small size, with the harness's look for a
card skipped and the rest of a run driven as ``run.py`` drives it.

Controls (``benchmark/calls/<call>.py::control``): the program's bf16 path on the
whole solve; the reference heat method in bfloat16.  Faults, planted where the answer is
produced: a solver step that returns its state unchanged, and the
answer altered by 10%."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from importlib import import_module  # noqa: E402

# (``gravomg_tpu_torch.solve`` is also the name of a function the
# package exports, so its modules are imported by their full names.)
heat_mod = import_module("gravomg_tpu_torch.apps.heat")
cg_mod = import_module("gravomg_tpu_torch.solve.cg")

from benchmark import run  # noqa: E402
from benchmark.loop import load_call  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 3


def _measure(cell, n=3000, call=None):
    return run.measure(cell, SEED, 1.0, False, CPU,
                       overrides={"points": {"n": n}}, call=call)[0]


@pytest.mark.parametrize("cell,n", [("torus1m.poisson", 8000),
                                    ("torus1m.heat", 20000)])
def test_bench_control_fails(cell, n):
    kind = run.cell_spec(cell)[3]["call"]
    res = _measure(cell, n, load_call(kind).control)
    assert res["correct"] is False
    over = [c for name, c in res["compared"].items()
            if name != "failed" and c["value"] > c["limit"]]
    assert over, res["compared"]


def _unchanged_krylov(op, b, precond, tol=1e-8, max_iters=500, x0=None,
                      mv=None, dot=None):
    return (torch.zeros_like(b) if x0 is None else x0), 0.0, 0


def _altered(fn):
    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        if isinstance(out, torch.Tensor):
            return out * 1.1
        return (out[0] * 1.1,) + tuple(out[1:])
    return wrapped


FAULTS = {
    "unchanged": {
        "torus1m.poisson": [(cg_mod, "pcg", _unchanged_krylov),
                            (cg_mod, "fcg", _unchanged_krylov)],
        "torus1m.heat": [(heat_mod, "mg_pcg",
                          lambda h, b, cfg, **kw: (torch.zeros_like(b), 0.0,
                                                   0))],
    },
    "altered": {
        "torus1m.poisson": [(load_call("mg_solve"), "mg_solve",
                             _altered(load_call("mg_solve").mg_solve))],
        "torus1m.heat": [(load_call("heat_geodesics"), "heat_geodesics",
                          _altered(load_call("heat_geodesics")
                                   .heat_geodesics))],
    },
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["torus1m.poisson", "torus1m.heat"])
def test_bench_fault_is_caught(monkeypatch, cell, fault):
    for mod, name, fn in FAULTS[fault][cell]:
        monkeypatch.setattr(mod, name, fn)
    assert _measure(cell)["correct"] is False


@pytest.mark.parametrize("cell", ["torus1m.poisson", "torus1m.heat"])
def test_bench_sound_run_is_correct(cell):
    assert _measure(cell)["correct"] is True
