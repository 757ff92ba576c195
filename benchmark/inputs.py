"""The inputs of a run.

The point cloud is the configuration's: drawn on the host, from the
seed its recipe states, by the generator it names,
``benchmark/clouds/<generator>.py``, found by name (the benchmark owns
its yardstick, so a change to the program's generators cannot change
the inputs); Morton ordered as the program's builders require, and
handed as the same float32 array to the program and to the reference.
The cloud is the same in every run, so a run's seed never changes the
work.  The traffic (right-hand sides, source vertices) and the sample
of answers the check compares come from the run's ``--seed``: the
traffic drawn on the run's device by a ``torch.Generator``.

Streams: the run's seed is split by ``numpy.random.SeedSequence`` into
one stream per purpose, so what the traffic draws never moves the
sample, and any whole number (negative or beyond 64 bits too) is a
valid seed.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

TRAFFIC, SAMPLE = 1, 2        # the run seed's streams


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run seed ``seed``."""
    entropy = [abs(int(seed)) % 2**64, int(seed < 0), stream]
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def _spread_bits(x: np.ndarray) -> np.ndarray:
    """Interleaves 21-bit integers with two zero bits (3-D Morton)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(points: np.ndarray, bits: int = 21) -> np.ndarray:
    """The permutation that sorts ``points`` along a 3-D Z-order curve."""
    p = np.asarray(points, np.float64)
    lo = p.min(axis=0)
    scale = (2**bits - 1) / np.maximum(p.max(axis=0) - lo, 1e-30)
    q = ((p - lo) * scale).astype(np.uint64)
    code = (_spread_bits(q[:, 0]) << np.uint64(2)) \
        | (_spread_bits(q[:, 1]) << np.uint64(1)) | _spread_bits(q[:, 2])
    return np.argsort(code, kind="stable")


def point_cloud(spec: dict) -> np.ndarray:
    """The configuration's cloud: (V, 3) float32, Morton ordered in f64
    before the cast.  ``spec`` names the generator and its arguments,
    its seed among them."""
    kw = {k: v for k, v in spec.items() if k != "generator"}
    gen = importlib.import_module("benchmark.clouds." + spec["generator"])
    pts = gen.points(**kw)
    return np.ascontiguousarray(pts[morton_order(pts)].astype(np.float32))


def generator(seed: int, stream: int, device: torch.device
              ) -> torch.Generator:
    """A generator on ``device`` for ``stream`` of ``seed``."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))
