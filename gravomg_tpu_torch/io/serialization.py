"""Solver hierarchy serialization (counterpart of
``gravomg_tpu/io/serialization.py``): the same flat npz keys, so files
written by either package load in the other.

Per level ``l{i}_nbr``, ``l{i}_off``, ``l{i}_diag`` (ELL operator),
``l{i}_ucols``, ``l{i}_uw``, ``l{i}_unc`` (prolongation, all but the
coarsest level), ``l{i}_cheb`` (Chebyshev bounds, if any); plus
``n_levels`` and ``coarse_chol``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from gravomg_tpu_torch.solve.smoothers import ChebyshevParams
from gravomg_tpu_torch.solve.vcycle import (SolverHierarchy, SolverLevel,
                                            attach_restrictions)
from gravomg_tpu_torch.types import EllOperator, Prolongation
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
    gather-form U^T tables recomputed (derived data, never stored)."""
    device = resolve_device(device)

    def t(key):
        return torch.as_tensor(np.asarray(arrays[key]), device=device)

    levels = []
    for i in range(int(arrays["n_levels"])):
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
