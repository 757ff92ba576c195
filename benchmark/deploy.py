"""A configuration's set-up through the port's public calls, in order:
the front end (grid kNN, Laplacian and the screened-Poisson operator
with the configuration's shift), the hierarchy build, and the fast
forms.  Each stage is a
span on the synchronised host clock, which the ``setup.*`` metrics
read."""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from gravomg_tpu_torch.apps.poisson import screened_poisson_operator
from gravomg_tpu_torch.config import MultigridConfig
from gravomg_tpu_torch.geometry.gridknn import grid_knn_graph_nosync
from gravomg_tpu_torch.hierarchy import build_hierarchy_device
from gravomg_tpu_torch.solve.vcycle import SolverHierarchy, attach_operators
from gravomg_tpu_torch.types import Graph


class Deployment(NamedTuple):
    """What set-up hands to the traffic."""
    points: np.ndarray            # (V, 3) float32, as the front end got them
    graph: Graph
    h: SolverHierarchy
    cfg: MultigridConfig


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def span(spans: dict, name: str, device: torch.device):
    """Adds the synchronised seconds of the block to ``spans[name]``."""
    synchronize(device)
    t0 = time.perf_counter()
    yield
    synchronize(device)
    spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


def deploy(config: dict, points: np.ndarray, device: torch.device,
           spans: dict) -> Deployment:
    """The configuration's set-up on ``points`` (float32, ordered) on
    ``device``; stage seconds into ``spans`` ("front", "build",
    "forms")."""
    cfg = MultigridConfig(**config["multigrid"])
    with span(spans, "front", device):
        graph = grid_knn_graph_nosync(points, config["knn"]["k"],
                                      margin=config["knn"]["margin"],
                                      device=device)
        op, _ = screened_poisson_operator(graph, alpha=config["shift"])
    with span(spans, "build", device):
        gen = torch.Generator(device=device).manual_seed(
            config["build_seed"])
        h = build_hierarchy_device(graph, op, cfg, generator=gen)[0].solver
    if config["forms"] == "attach_operators":
        with span(spans, "forms", device):
            h = attach_operators(h)
    elif config["forms"] != "none":
        raise ValueError(f"unknown forms {config['forms']!r}")
    return Deployment(points, graph, h, cfg)


def cycle_dtype(dep: Deployment, call: str) -> torch.dtype:
    """The dtype of the window matrices in the V-cycle that ``call``
    runs: ``mg_solve`` preconditions with a bf16 cast of the hierarchy
    at or above ``cfg.bf16_threshold`` rows when level 0 has a fast form
    (its documented rule); every other entry cycles in float32."""
    lvl0 = dep.h.levels[0]
    if (call == "mg_solve" and lvl0.banded is not None
            and lvl0.op.num_vertices >= dep.cfg.bf16_threshold):
        return torch.bfloat16
    return torch.float32
