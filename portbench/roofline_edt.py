"""K5's count, for the roofline share of the exact EDT's envelope passes.

Frozen copy of chip_smoke.py:4207-4214: a pass reads the squared
distances and the packed sites and writes both, 16 B a voxel; a
linear-time envelope exists, so no operation count sets a higher floor.
The bound is the bytes at `roofline.HBM_BYTES_PER_S`.
"""
from __future__ import annotations

from .roofline import least_s

K5_BYTES_PER_VOXEL = 16


def k5_least_s(voxels: int) -> tuple[float, str]:
    """One envelope pass (along y or x) over `voxels`."""
    return least_s(K5_BYTES_PER_VOXEL * voxels, 0)
