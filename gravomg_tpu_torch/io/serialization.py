"""Solver hierarchy serialization (counterpart of
``gravomg_tpu/io/serialization.py``): the same flat npz keys, so files
written by either package load in the other.

Per level ``l{i}_nbr``, ``l{i}_off``, ``l{i}_diag`` (ELL operator),
``l{i}_ucols``, ``l{i}_uw``, ``l{i}_unc`` (prolongation, all but the
coarsest level), ``l{i}_cheb`` (Chebyshev bounds, if any); plus
``n_levels`` and ``coarse_chol``.

The build's inputs and outputs cross as numpy arrays too:
:func:`graph_from_numpy` makes a graph from ELL tables, and
:func:`level_to_numpy` / :func:`hierarchy_to_numpy` give back what each
coarsening step made.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gravomg_tpu_torch.solve.smoothers import ChebyshevParams
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            attach_restrictions)
from gravomg_tpu_torch.types import (INVALID_INDEX, EllOperator, Graph,
                                     Prolongation)
from gravomg_tpu_torch.utils.device import resolve_device


def solver_to_numpy(h: SolverHierarchy) -> dict:
    """The npz key layout of ``h`` as numpy arrays."""
    arrays = {"n_levels": np.int64(len(h.levels)),
              "coarse_chol": h.coarse_chol.cpu().numpy()}
    for i, lvl in enumerate(h.levels):
        arrays[f"l{i}_nbr"] = lvl.op.neighbors.cpu().numpy()
        arrays[f"l{i}_off"] = lvl.op.offdiag.cpu().numpy()
        arrays[f"l{i}_diag"] = lvl.op.diag.cpu().numpy()
        if lvl.u is not None:
            arrays[f"l{i}_ucols"] = lvl.u.cols.cpu().numpy()
            arrays[f"l{i}_uw"] = lvl.u.weights.cpu().numpy()
            arrays[f"l{i}_unc"] = np.int64(lvl.u.n_coarse)
        if lvl.cheb is not None:
            arrays[f"l{i}_cheb"] = np.array(
                [float(lvl.cheb.lam_min), float(lvl.cheb.lam_max)])
    return arrays


def save_solver(path: str, h: SolverHierarchy) -> None:
    np.savez_compressed(path, **solver_to_numpy(h))


def solver_from_numpy(arrays: Mapping[str, np.ndarray],
                      device=None) -> SolverHierarchy:
    """Tensors on ``device`` (the card unless the caller names another:
    :func:`resolve_device`) from the npz key layout (a loaded npz or a
    dict, e.g. the arrays of a JAX ``SolverHierarchy``), with the
    gather-form U^T tables recomputed (derived data, never stored).

    Every tensor is row-major, whatever order the file stored (JAX saves
    its tables column-major), as the ELL kernel reads them; a level's
    real neighbour slots must lie in [0, V), which the kernel takes on
    trust, else ValueError."""
    device = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.ascontiguousarray(arrays[key]),
                               device=device)

    levels = []
    for i in range(int(arrays["n_levels"])):
        nbr = np.asarray(arrays[f"l{i}_nbr"])
        real = nbr[nbr != INVALID_INDEX]
        if real.size and (real.min() < 0 or real.max() >= nbr.shape[0]):
            raise ValueError(f"level {i}: a neighbour index outside "
                             f"[0, {nbr.shape[0]})")
        op = EllOperator(t(f"l{i}_nbr"), t(f"l{i}_off"), t(f"l{i}_diag"))
        u = None
        if f"l{i}_ucols" in arrays:
            u = Prolongation(t(f"l{i}_ucols"), t(f"l{i}_uw"),
                             int(arrays[f"l{i}_unc"]))
        cheb = None
        if f"l{i}_cheb" in arrays:
            lo, hi = np.asarray(arrays[f"l{i}_cheb"], np.float64)
            cheb = ChebyshevParams(float(lo), float(hi))
        levels.append(SolverLevel(op=op, u=u, cheb=cheb))
    return attach_restrictions(SolverHierarchy(levels=tuple(levels),
                                               coarse_chol=t("coarse_chol")))


def load_solver(path: str, device=None) -> SolverHierarchy:
    """The hierarchy of an npz file, on the card unless ``device`` names
    another device (``"cpu"``)."""
    device = resolve_device(device)
    with np.load(path) as z:
        return solver_from_numpy(z, device=device)


def graph_from_numpy(neighbors: np.ndarray, distances: np.ndarray,
                     points: np.ndarray, device=None) -> Graph:
    """A graph on ``device`` (the card unless the caller names another)
    from its ELL tables: neighbours (V, K) integer with INVALID_INDEX
    padding, distances (V, K) and points (V, 3) of one float dtype."""
    device = resolve_device(device)
    return Graph(
        neighbors=torch.as_tensor(np.array(neighbors, np.int32),
                                  device=device),
        distances=torch.as_tensor(np.array(distances), device=device),
        points=torch.as_tensor(np.array(points), device=device))


def level_to_numpy(level) -> dict:
    """What one coarsening step made (a ``hierarchy.LevelData``), as
    numpy arrays: samples, parents, the coarse graph's neighbours and
    points, the triangles with their normals and association lists, and
    U's columns and weights."""
    def n(t):
        return t.cpu().numpy()

    return {"samples": n(level.samples), "parents": n(level.parents),
            "coarse_neighbors": n(level.coarse.neighbors),
            "coarse_points": n(level.coarse.points),
            "triangles": n(level.triangles.vertices),
            "normals": n(level.triangles.normals),
            "assoc": n(level.triangles.assoc),
            "assoc_rot": n(level.triangles.assoc_rot),
            "u_cols": n(level.u.cols), "u_weights": n(level.u.weights)}


def hierarchy_to_numpy(hierarchy) -> list:
    """:func:`level_to_numpy` of every level of a
    ``hierarchy.Hierarchy``, finest first."""
    return [level_to_numpy(level) for level in hierarchy.levels]
