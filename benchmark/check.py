"""How ``correct`` is decided: the answers of a sample of the window's
calls against the plain reference (``benchmark/reference``), which
works out the graph and operators again from the same points.

The numbers compared are the ``readings`` of the mix's entry,
``benchmark/calls/<call>.py``, each against its limit in
``benchmark/limits/<workload>.json`` (how each limit was set is in
PERF.md).  Besides, ``failed``: calls that raised or broke their own guarantee
(limit 0).  ``correct`` holds when every number is within its limit.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.loop import load_call
from benchmark.reference.graph import RefGraph, knn_graph

HERE = os.path.dirname(os.path.abspath(__file__))


def limits(workload: str) -> Dict[str, float]:
    """The cell's limits; none before they were set."""
    path = os.path.join(HERE, "limits", f"{workload}.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return {k: v for k, v in json.load(f).items() if k != "readings"}


def rel_err(a: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest column-wise ||a - ref|| / ||ref||."""
    a = a.to(device=ref.device, dtype=ref.dtype)
    return float((torch.linalg.norm(a - ref, dim=0)
                  / torch.linalg.norm(ref, dim=0)).max())


def readings(kind: str, points: np.ndarray, config: dict, traffic: dict,
             inputs: list, outputs: List[tuple], device: torch.device,
             g: RefGraph = None) -> Dict[str, float]:
    """The numbers compared, from the sampled calls' ``inputs`` and the
    program's ``outputs`` (one tuple per call); ``g`` the reference's
    graph of ``points`` where it is made already."""
    if g is None:
        g = knn_graph(points, config["knn"]["k"], device)
    return load_call(kind).readings(g, config, traffic, inputs, outputs,
                                    device)


def judge(values: Dict[str, float], failed: int,
          lim: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number within its
    limit, and no failed call; a number without a limit is not correct."""
    compared = {n: {"value": v, "limit": lim.get(n)}
                for n, v in values.items()}
    compared["failed"] = {"value": failed, "limit": 0}
    ok = bool(values) and all(
        c["limit"] is not None and np.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
