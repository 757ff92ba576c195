"""Synthetic point clouds (host-side NumPy; a copy of
``gravomg_tpu/geometry/meshes.py::torus_points``)."""

from __future__ import annotations

import numpy as np


def torus_points(n: int, r_major: float = 1.0, r_minor: float = 0.35,
                 seed: int = 0) -> np.ndarray:
    """``n`` points drawn uniformly in the torus angles (seeded)."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    t = rng.uniform(0, 2 * np.pi, n)
    x = (r_major + r_minor * np.cos(t)) * np.cos(u)
    y = (r_major + r_minor * np.cos(t)) * np.sin(u)
    z = r_minor * np.sin(t)
    return np.stack([x, y, z], axis=1)
