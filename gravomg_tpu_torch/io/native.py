"""ctypes binding to the sequential C++ coarsener
(``csrc/gravomg_host.cpp::gmg_coarsen_level``), framework-free.

The library is compiled with ``g++`` and the flags of ``csrc/Makefile``
at first use into ``gravomg_tpu_torch/_build/``.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from gravomg_tpu_torch.types import INVALID_INDEX
from gravomg_tpu_torch.utils.build import build_shared

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "gravomg_host.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++20", "-fPIC", "-Wall",
             "-Wextra", "-shared"]

_lib = None
_lib_lock = threading.Lock()


def build_library(force: bool = False) -> str:
    """Compile the coarsener if missing (or ``force``); returns the
    path of the shared library."""
    return build_shared([os.environ.get("CXX", "g++"), *CXX_FLAGS], _SRC,
                        "libgravomg_host.so", force)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.gmg_coarsen_level.restype = ctypes.c_int32
            lib.gmg_coarsen_level.argtypes = [
                ctypes.c_int64, ctypes.c_int32, i32p, f64p, f64p,
                ctypes.c_double, ctypes.c_int32, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
                i32p, i32p, i32p, f64p, f64p, i32p]
            _lib = lib
    return _lib


def coarsen_level(neighbors: np.ndarray, distances: np.ndarray,
                  points: np.ndarray, reduction_ratio: float = 2.0,
                  scheme: int = 0, kc_cap: int = 96) -> dict:
    """One sequential coarsening step with the reference-greedy Poisson
    disc sampling: samples, parents, U, coarse points and coarse
    adjacency, as numpy arrays.  Raises ValueError if the coarse graph's
    degree exceeds ``kc_cap``."""
    lib = _load()
    v, k = neighbors.shape
    d = np.where(neighbors != INVALID_INDEX, distances, 0.0)
    n_s = ctypes.c_int64()
    samples = np.empty(v, np.int32)
    parents = np.empty(v, np.int32)
    u_cols = np.empty(v * 3, np.int32)
    u_w = np.empty(v * 3, np.float64)
    cpoints = np.empty(v * 3, np.float64)
    cnbr = np.empty(v * kc_cap, np.int32)
    nc = lib.gmg_coarsen_level(
        v, k, np.ascontiguousarray(neighbors, np.int32),
        np.ascontiguousarray(d, np.float64),
        np.ascontiguousarray(points, np.float64),
        float(reduction_ratio), int(scheme), int(kc_cap),
        ctypes.byref(n_s), samples, parents, u_cols, u_w, cpoints, cnbr)
    if nc < 0:
        raise ValueError(f"kc_cap={kc_cap} too small for coarse graph")
    return {
        "samples": samples[:n_s.value].copy(),
        "parents": parents,
        "u_cols": u_cols.reshape(v, 3),
        "u_weights": u_w.reshape(v, 3),
        "coarse_points": cpoints[:nc * 3].reshape(nc, 3).copy(),
        "coarse_nbr": cnbr.reshape(v, kc_cap)[:nc].copy(),
    }
