"""Synthetic meshes and point clouds (host-side NumPy; copies of the
generators of ``gravomg_tpu/geometry/meshes.py``, which draw the same
numbers from the same seeds)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def cube_mesh() -> Tuple[np.ndarray, np.ndarray]:
    """Unit cube triangle mesh (8 vertices, 12 faces)."""
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                 dtype=np.float64)
    f = np.array([
        [0, 1, 3], [0, 3, 2],  # x = 0
        [4, 6, 7], [4, 7, 5],  # x = 1
        [0, 4, 5], [0, 5, 1],  # y = 0
        [2, 3, 7], [2, 7, 6],  # y = 1
        [0, 2, 6], [0, 6, 4],  # z = 0
        [1, 5, 7], [1, 7, 3],  # z = 1
    ], dtype=np.int32)
    return v, f


def icosphere(subdivisions: int) -> Tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron: 10 * 4**n + 2 vertices.

    n=4 -> 2562, n=5 -> 10242, n=6 -> 40962, n=7 -> 163842, n=9 -> ~2.6M.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], dtype=np.int64)
    for _ in range(subdivisions):
        edge_mid: dict = {}
        new_faces = []
        verts_list = [verts]
        n = verts.shape[0]

        edges = {}
        for tri in faces:
            for a, b in ((tri[0], tri[1]), (tri[1], tri[2]), (tri[2], tri[0])):
                key = (min(a, b), max(a, b))
                edges.setdefault(key, None)
        keys = np.array(sorted(edges.keys()), dtype=np.int64)
        mids = verts[keys[:, 0]] + verts[keys[:, 1]]
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        for i, key in enumerate(map(tuple, keys)):
            edge_mid[key] = n + i
        verts = np.concatenate([verts, mids], axis=0)

        def mid(a, b):
            return edge_mid[(min(a, b), max(a, b))]

        for tri in faces:
            a, b, c = int(tri[0]), int(tri[1]), int(tri[2])
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        faces = np.array(new_faces, dtype=np.int64)
    return verts, faces.astype(np.int32)


def grid_mesh(nx: int, ny: int) -> Tuple[np.ndarray, np.ndarray]:
    """Planar triangulated grid patch on [0,1]^2 (z=0)."""
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                         indexing="ij")
    verts = np.stack([xs.ravel(), ys.ravel(), np.zeros(nx * ny)], axis=1)
    faces = []
    for i in range(nx - 1):
        for j in range(ny - 1):
            a = i * ny + j
            b = (i + 1) * ny + j
            faces += [[a, b, a + 1], [b, b + 1, a + 1]]
    return verts, np.array(faces, dtype=np.int32)


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


def random_points_on_mesh(n: int, verts: np.ndarray, faces: np.ndarray,
                          seed: int = 0) -> np.ndarray:
    """Uniform random surface samples, area-weighted over faces (the
    reference demo's ``igl::random_points_on_mesh``)."""
    rng = np.random.default_rng(seed)
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    probs = areas / areas.sum()
    chosen = rng.choice(len(faces), size=n, p=probs)
    r1 = np.sqrt(rng.uniform(size=(n, 1)))
    r2 = rng.uniform(size=(n, 1))
    return ((1 - r1) * a[chosen] + r1 * (1 - r2) * b[chosen]
            + r1 * r2 * c[chosen])


def mesh_edges(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edge list (E, 2) of a triangle mesh."""
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0).astype(np.int32)


def max_vertex_degree(faces: np.ndarray, num_verts: int) -> int:
    """Largest number of mesh edges at one vertex."""
    edges = mesh_edges(faces)
    deg = np.zeros(num_verts, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    return int(deg.max())
