"""PyTorch port: where the entry points put their tensors.

The port runs on the card unless the caller asks for the CPU:
``resolve_device(None)`` is the card and raises without one; an explicit
device is taken as given.
"""

import os

import numpy as np
import pytest
import torch

import gravomg_tpu_torch as gt
from gravomg_tpu_torch.geometry.meshes import torus_points
from gravomg_tpu_torch.geometry.order import morton_order
from gravomg_tpu_torch.io.serialization import (load_solver,
                                                solver_from_numpy,
                                                solver_to_numpy)
from gravomg_tpu_torch.probes.gather import probe_inputs
from gravomg_tpu_torch.utils.device import resolve_device

torch.set_num_threads(2)

ENTRY = os.path.join(os.path.dirname(__file__), "..", "assets",
                     "entry_hierarchy.npz")


def _points(n=600):
    pts = torus_points(n, seed=4).astype(np.float32)
    return pts[morton_order(pts)]


def test_explicit_cpu_is_honoured():
    """``device="cpu"`` (a string or a torch.device) puts every tensor
    of every entry point on the CPU."""
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    h = load_solver(ENTRY, device="cpu")
    h2 = solver_from_numpy(solver_to_numpy(h), device=torch.device("cpu"))
    for hh in (h, h2):
        assert hh.coarse_chol.device.type == "cpu"
        for lvl in hh.levels:
            assert lvl.op.neighbors.device.type == "cpu"
            assert lvl.op.diag.device.type == "cpu"
            assert lvl.u is None or lvl.u.cols.device.type == "cpu"
            assert lvl.ut is None or lvl.ut.weights.device.type == "cpu"
    np.testing.assert_array_equal(h.levels[0].op.offdiag.numpy(),
                                  h2.levels[0].op.offdiag.numpy())
    graph = gt.grid_knn_graph_nosync(_points(), 8, margin=2.4, device="cpu")
    assert graph.neighbors.device.type == "cpu"
    assert graph.points.device.type == "cpu"
    x, starts, lidx, w = probe_inputs(16_384, device="cpu")
    assert {t.device.type for t in (x, lidx, w, *starts.values())} == {"cpu"}


def test_default_is_the_card_and_raises_without_one():
    """With no CUDA device the default raises and says how to ask for
    the CPU; nothing steps down to it quietly."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    calls = {
        "resolve_device": lambda: resolve_device(),
        "load_solver": lambda: load_solver(ENTRY),
        "solver_from_numpy": lambda: solver_from_numpy(
            solver_to_numpy(load_solver(ENTRY, device="cpu"))),
        "grid_knn_graph_nosync": lambda: gt.grid_knn_graph_nosync(
            _points(), 8, margin=2.4),
        "probe_inputs": lambda: probe_inputs(16_384),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
