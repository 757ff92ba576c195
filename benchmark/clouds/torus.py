"""``n`` points drawn uniformly in the two angles of a torus (float64);
the port's ``geometry/meshes.py::torus_points`` draws the same."""

import numpy as np


def points(n: int, r_major: float, r_minor: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 2 * np.pi, n)
    t = rng.uniform(0, 2 * np.pi, n)
    x = (r_major + r_minor * np.cos(t)) * np.cos(u)
    y = (r_major + r_minor * np.cos(t)) * np.sin(u)
    z = r_minor * np.sin(t)
    return np.stack([x, y, z], axis=1)
