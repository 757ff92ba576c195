"""Morton (Z-order) vertex ordering (host-side NumPy; a copy of
``gravomg_tpu/geometry/order.py::morton_order``).  After it, neighbours
lie nearby in memory, which is what the block-window operator forms
need."""

from __future__ import annotations

import numpy as np


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleave 21-bit integers with two zero bits (for 3-D Morton)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """Permutation sorting points along a 3-D Z-order curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    hi = p.max(axis=0)
    scale = (2**bits - 1) / np.maximum(hi - lo, 1e-30)
    q = ((p - lo) * scale).astype(np.uint64)
    code = (_spread_bits(q[:, 0]) << np.uint64(2)) \
        | (_spread_bits(q[:, 1]) << np.uint64(1)) | _spread_bits(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)
