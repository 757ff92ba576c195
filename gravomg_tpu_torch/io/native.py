"""ctypes bindings to the native host runtime (``csrc/gravomg_host.cpp``),
framework-free: the counterpart of ``gravomg_tpu/io/native.py``.

The library is compiled with ``g++`` and the flags of ``csrc/Makefile``
at first use into ``gravomg_tpu_torch/_build/``.  Every binding takes
and returns numpy arrays, as the JAX package's do: the sequential
reference-semantics coarsener (one level, or a whole hierarchy's sizes),
its stages (Poisson disc sampling, parents, mean edge length), an f64
ELL SpMV and an OBJ reader.  ``available()`` says whether the library
builds and loads here; the other functions raise if it does not.
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
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
            i64 = ctypes.c_int64
            lib.gmg_disc_sample.restype = ctypes.c_int64
            lib.gmg_disc_sample.argtypes = [i64, ctypes.c_int32, i32p, f64p,
                                            ctypes.c_double, i32p]
            lib.gmg_assign_parents.restype = None
            lib.gmg_assign_parents.argtypes = [i64, ctypes.c_int32, i32p,
                                               f64p, i32p, i64, i32p, f64p]
            lib.gmg_average_edge_length.restype = ctypes.c_double
            lib.gmg_average_edge_length.argtypes = [i64, ctypes.c_int32,
                                                    i32p, f64p]
            lib.gmg_ell_spmv.restype = None
            lib.gmg_ell_spmv.argtypes = [i64, ctypes.c_int32, i32p, f64p,
                                         f64p, f64p, f64p]
            lib.gmg_read_obj.restype = ctypes.c_int64
            lib.gmg_read_obj.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.POINTER(ctypes.c_int64)]
            lib.gmg_build_hierarchy.restype = ctypes.c_int32
            lib.gmg_build_hierarchy.argtypes = [
                i64, ctypes.c_int32, i32p, f64p, f64p, ctypes.c_double, i64,
                ctypes.c_int32, ctypes.c_int32, i64p,
                ctypes.POINTER(ctypes.c_double)]
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
    v, k, nbr, d = _graph_args(neighbors, distances)
    n_s = ctypes.c_int64()
    samples = np.empty(v, np.int32)
    parents = np.empty(v, np.int32)
    u_cols = np.empty(v * 3, np.int32)
    u_w = np.empty(v * 3, np.float64)
    cpoints = np.empty(v * 3, np.float64)
    cnbr = np.empty(v * kc_cap, np.int32)
    nc = lib.gmg_coarsen_level(
        v, k, nbr, d, np.ascontiguousarray(points, np.float64),
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


def available() -> bool:
    """Whether the library builds (``g++``) and loads here."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _graph_args(neighbors: np.ndarray, distances: np.ndarray):
    """(V, K, neighbours int32, distances f64 with 0 in padding slots:
    the mean-edge reductions need finite padding)."""
    v, k = neighbors.shape
    d = np.where(neighbors != INVALID_INDEX, distances, 0.0)
    return (v, k, np.ascontiguousarray(neighbors, np.int32),
            np.ascontiguousarray(d, np.float64))


def disc_sample(neighbors: np.ndarray, distances: np.ndarray,
                radius: float) -> np.ndarray:
    """The reference's greedy Poisson disc sampling at ``radius``: the
    sampled vertex ids, in the order they were taken."""
    lib = _load()
    v, k = neighbors.shape
    out = np.empty(v, np.int32)
    n = lib.gmg_disc_sample(v, k, np.ascontiguousarray(neighbors, np.int32),
                            np.ascontiguousarray(distances, np.float64),
                            float(radius), out)
    return out[:n].copy()


def assign_parents(neighbors: np.ndarray, points: np.ndarray,
                   samples: np.ndarray):
    """(parent (V,) int32 index into ``samples``, distance (V,) f64 to
    it) by the reference's graph search from the samples."""
    lib = _load()
    v, k = neighbors.shape
    parent = np.empty(v, np.int32)
    dist = np.empty(v, np.float64)
    lib.gmg_assign_parents(v, k, np.ascontiguousarray(neighbors, np.int32),
                           np.ascontiguousarray(points, np.float64),
                           np.ascontiguousarray(samples, np.int32),
                           len(samples), parent, dist)
    return parent, dist


def average_edge_length(neighbors: np.ndarray,
                        distances: np.ndarray) -> float:
    """Mean length over the graph's valid edge slots."""
    return float(_load().gmg_average_edge_length(
        *_graph_args(neighbors, distances)))


def ell_spmv(neighbors: np.ndarray, offdiag: np.ndarray, diag: np.ndarray,
             x: np.ndarray) -> np.ndarray:
    """y = diag*x + sum_k offdiag*x[nbr] in f64 (INVALID slots skipped)."""
    lib = _load()
    v, k = neighbors.shape
    y = np.empty(v, np.float64)
    lib.gmg_ell_spmv(v, k, np.ascontiguousarray(neighbors, np.int32),
                     np.ascontiguousarray(offdiag, np.float64),
                     np.ascontiguousarray(diag, np.float64),
                     np.ascontiguousarray(x, np.float64), y)
    return y


def build_hierarchy(neighbors: np.ndarray, distances: np.ndarray,
                    points: np.ndarray, reduction_ratio: float = 2.0,
                    threshold: int = 1000, max_levels: int = 16,
                    scheme: int = 0):
    """The whole sequential reference-semantics build (every stage of
    every level): (coarse level sizes int64, checksum of U's weights)."""
    lib = _load()
    v, k, nbr, d = _graph_args(neighbors, distances)
    sizes = np.zeros(max_levels, np.int64)
    checksum = ctypes.c_double()
    n = lib.gmg_build_hierarchy(
        v, k, nbr, d, np.ascontiguousarray(points, np.float64),
        float(reduction_ratio), int(threshold), int(max_levels),
        int(scheme), sizes, ctypes.byref(checksum))
    return sizes[:n].copy(), float(checksum.value)


def read_obj(path: str):
    """(verts (V, 3) f64, faces (F, 3) int32) of an OBJ file; raises
    FileNotFoundError if it cannot be read."""
    lib = _load()
    nv = ctypes.c_int64()
    nf = ctypes.c_int64()
    rc = lib.gmg_read_obj(path.encode(), None, None,
                          ctypes.byref(nv), ctypes.byref(nf))
    if rc != 0:
        raise FileNotFoundError(path)
    verts = np.empty((nv.value, 3), np.float64)
    faces = np.empty((nf.value, 3), np.int32)
    lib.gmg_read_obj(path.encode(),
                     verts.ctypes.data_as(ctypes.c_void_p),
                     faces.ctypes.data_as(ctypes.c_void_p),
                     ctypes.byref(nv), ctypes.byref(nf))
    return verts, faces
