"""Mesh and point-cloud normalisation (counterpart of
``gravomg_tpu/geometry/transforms.py``)."""

from __future__ import annotations

import torch


def scale_mesh(points: torch.Tensor, scale_ratio: float = 1.0) -> torch.Tensor:
    """A point cloud normalised to a centred bounding box, as the
    reference's ``scaleMesh`` does it: the per-axis minimum goes to the
    origin, the longest bounding-box edge is scaled to ``scale_ratio``,
    then the box's centre goes to the origin.  Returns a new tensor."""
    mins = points.min(dim=0).values
    extent = (points.max(dim=0).values - mins).max()
    scaled = (points - mins) * (scale_ratio / extent)
    # The per-axis minimum is now 0, so the centre is half the maximum.
    return scaled - 0.5 * scaled.max(dim=0).values
