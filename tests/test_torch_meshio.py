"""Mesh files and vertex order: the port's ``io/meshio.py`` and
``geometry/order.py::permute_graph``/``bandwidth`` against the JAX
package's.

(a) OBJ and binary PLY round trips through the port (vertices at the
f32/print precision the formats keep, faces exact); the files the port
writes are byte for byte those the JAX package writes; the port reads
JAX-written files to JAX's arrays, with the C++ OBJ loader and with the
Python parser; a PLY of another layout is refused.

(b) On a 3,000-point cloud (f32 and f64): the Morton permutation,
``permute_graph`` and ``bandwidth`` equal JAX's exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gravomg_tpu as g
from gravomg_tpu.geometry import order as jorder
from gravomg_tpu.geometry.meshes import icosphere
from gravomg_tpu.io import meshio as jmeshio

from gravomg_tpu_torch import Graph
from gravomg_tpu_torch.geometry import order
from gravomg_tpu_torch.io import meshio, native


def test_obj_and_ply_files(tmp_path, monkeypatch):
    v, f = icosphere(2)
    v = v + np.random.default_rng(51).normal(scale=1e-3, size=v.shape)
    for ext, write, read, jwrite, jread in (
            ("obj", meshio.write_obj, meshio.read_obj, jmeshio.write_obj,
             jmeshio.read_obj),
            ("ply", meshio.write_ply, meshio.read_ply, jmeshio.write_ply,
             jmeshio.read_ply)):
        mine, theirs = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        write(mine, v, f)
        jwrite(theirs, v, f)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), ext
        v2, f2 = read(mine)
        np.testing.assert_allclose(v2, v, atol=1e-6)
        np.testing.assert_array_equal(f2, f)
        vj, fj = jread(theirs)
        v3, f3 = read(theirs)
        np.testing.assert_array_equal(v3, vj)
        np.testing.assert_array_equal(f3, fj)
        assert v3.dtype == np.float64 and f3.dtype == np.int32
    # Points only, through the Python parser (no C++ loader).
    pts = str(tmp_path / "p.obj")
    jmeshio.write_obj(pts, v)
    monkeypatch.setattr(native, "available", lambda: False)
    vp, fp = meshio.read_obj(pts)
    np.testing.assert_array_equal(vp, jmeshio.read_obj(pts)[0])
    assert fp is None
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"ply\nformat ascii 1.0\nelement vertex 0\nend_header\n")
    with pytest.raises(ValueError):
        meshio.read_ply(str(bad))


def test_permute_graph_and_bandwidth_equal_jax():
    rng = np.random.default_rng(52)
    pts = rng.normal(size=(3000, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    perm = order.morton_order(pts)
    np.testing.assert_array_equal(perm, jorder.morton_order(pts))
    for dt in (np.float32, np.float64):
        gj = g.knn_graph(jnp.asarray(pts.astype(dt)), k=10)
        gt_ = Graph(*(torch.as_tensor(np.array(a)) for a in gj))
        pj, pt = jorder.permute_graph(gj, perm), order.permute_graph(gt_,
                                                                     perm)
        for a, b in zip(pj, pt):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
            assert b.numpy().dtype == np.asarray(a).dtype
        assert order.bandwidth(gt_) == jorder.bandwidth(gj)
        assert order.bandwidth(pt) == jorder.bandwidth(pj) \
            < order.bandwidth(gt_)
