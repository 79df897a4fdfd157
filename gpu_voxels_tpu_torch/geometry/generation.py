"""Deterministic test geometry (helpers/GeometryGeneration.{h,cpp}).

Counterpart of gpu_voxels_tpu/geometry/generation.py: the same numpy code,
so generated scenes are identical in both packages. Points are host numpy
float32 arrays of shape [N, 3]; maps move them to their device on insert.
The oriented-box generators are not ported yet (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import numpy as np


def _frange32(start, stop_inclusive, step):
    """C-style `for(float v=start; v<=stop; v+=step)` in float32."""
    vals = []
    v = np.float32(start)
    stop = np.float32(stop_inclusive)
    step = np.float32(step)
    while v <= stop:
        vals.append(v)
        v = np.float32(v + step)
    return np.asarray(vals, dtype=np.float32)


def create_box_of_points(mins, maxs, delta) -> np.ndarray:
    """createBoxOfPoints (GeometryGeneration.cpp:92-108): inclusive grid."""
    xs = _frange32(mins[0], maxs[0], delta)
    ys = _frange32(mins[1], maxs[1], delta)
    zs = _frange32(mins[2], maxs[2], delta)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)


def create_sphere_of_points(center, radius, delta) -> np.ndarray:
    """createSphereOfPoints (GeometryGeneration.cpp:111-134)."""
    center = np.asarray(center, dtype=np.float32)
    pts = create_box_of_points(center - radius, center + radius, delta)
    keep = np.linalg.norm(center[None] - pts, axis=1) <= radius
    return pts[keep]


def create_equidistant_points_in_box(max_nr_points, max_coords, side_length) -> np.ndarray:
    """createEquidistantPointsInBox (GeometryGeneration.cpp:163-191).

    Every second voxel center within max_coords, truncated to max_nr_points
    in x-major (x outer, z inner) order.
    """
    nx = (int(max_coords[0]) - 1) // 2
    ny = (int(max_coords[1]) - 1) // 2
    nz = (int(max_coords[2]) - 1) // 2
    s = np.float32(side_length)
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    pts = np.stack(
        [
            i.ravel() * 2 * s + s / np.float32(2.0),
            j.ravel() * 2 * s + s / np.float32(2.0),
            k.ravel() * 2 * s + s / np.float32(2.0),
        ],
        axis=1,
    ).astype(np.float32)
    return pts[: int(max_nr_points)]


def create_non_overlapping_3d_checkerboard(max_nr_points, max_coords, side_length):
    """createNonOverlapping3dCheckerboard (GeometryGeneration.cpp:194-221).

    Returns (black, white) clouds that never share a voxel.
    """
    black = create_equidistant_points_in_box(max_nr_points, max_coords, side_length)
    s = np.float32(side_length)
    white = black + s  # (i*2+1)*s + s/2 == black + s, per axis
    return black, white
