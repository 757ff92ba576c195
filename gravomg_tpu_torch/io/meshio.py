"""Mesh and point-cloud files: OBJ and binary little-endian PLY
(counterpart of ``gravomg_tpu/io/meshio.py``, a copy of its numpy code).

Arrays in and out are numpy, as in the JAX package: vertices (V, 3)
float64, faces (F, 3) int32 or None.  ``read_obj`` takes the C++ loader
of ``csrc/gravomg_host.cpp`` (``io/native.py``) when it builds here, and
parses in Python otherwise.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from gravomg_tpu_torch.io import native


def read_obj(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (verts (V, 3) f64, faces (F, 3) i32 or None)."""
    if native.available():
        v, f = native.read_obj(path)
        return v, (f if len(f) else None)
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:4]]
                faces.append(idx)
    v = np.array(verts, np.float64)
    f = np.array(faces, np.int32) if faces else None
    return v, f


def write_obj(path: str, verts: np.ndarray,
              faces: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as fh:
        for p in np.asarray(verts):
            fh.write(f"v {p[0]} {p[1]} {p[2]}\n")
        if faces is not None:
            for f in np.asarray(faces):
                fh.write(f"f {f[0]+1} {f[1]+1} {f[2]+1}\n")


def write_ply(path: str, verts: np.ndarray,
              faces: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY: float x/y/z vertices, uchar-list int
    triangle faces."""
    verts = np.ascontiguousarray(verts, np.float32)
    nf = 0 if faces is None else len(faces)
    with open(path, "wb") as fh:
        header = ["ply", "format binary_little_endian 1.0",
                  f"element vertex {len(verts)}",
                  "property float x", "property float y",
                  "property float z"]
        if nf:
            header += [f"element face {nf}",
                       "property list uchar int vertex_indices"]
        header.append("end_header")
        fh.write(("\n".join(header) + "\n").encode())
        fh.write(verts.tobytes())
        if nf:
            buf = bytearray()
            for tri in np.asarray(faces, np.int32):
                buf += struct.pack("<B3i", 3, *tri)
            fh.write(bytes(buf))


def read_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Reads the format :func:`write_ply` writes (binary little-endian,
    three float x/y/z vertex properties, optional triangle faces);
    raises ValueError on any other layout."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        nv = nf = 0
        fmt_seen = False
        cur_element = None
        vertex_props: list = []
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: PLY header without end_header")
            parts = line.strip().split()
            if parts == [b"end_header"]:
                break
            if not parts or parts[0] == b"comment":
                continue
            if parts[0] == b"format":
                fmt_seen = True
                if parts[1] != b"binary_little_endian":
                    raise ValueError(
                        f"{path}: unsupported PLY format "
                        f"{parts[1].decode()} (only binary_little_endian)")
            elif parts[0] == b"element":
                cur_element = parts[1]
                if parts[1] == b"vertex":
                    nv = int(parts[2])
                elif parts[1] == b"face":
                    nf = int(parts[2])
                else:
                    raise ValueError(f"{path}: unsupported PLY element "
                                     f"{parts[1].decode()}")
            elif parts[0] == b"property" and cur_element == b"vertex":
                vertex_props.append(tuple(parts[1:]))
        if not fmt_seen:
            raise ValueError(f"{path}: PLY header missing format line")
        if vertex_props != [(b"float", b"x"), (b"float", b"y"),
                            (b"float", b"z")]:
            raise ValueError(f"{path}: unsupported vertex layout "
                             f"{vertex_props} (only three float x/y/z "
                             f"properties)")
        verts = np.frombuffer(fh.read(nv * 12), np.float32).reshape(nv, 3)
        faces = None
        if nf:
            faces = np.empty((nf, 3), np.int32)
            for i in range(nf):
                cnt = fh.read(1)[0]
                if cnt != 3:
                    raise ValueError(f"{path}: face {i} has {cnt} "
                                     f"vertices (only triangles)")
                faces[i] = np.frombuffer(fh.read(12), np.int32)
        return verts.astype(np.float64), faces
