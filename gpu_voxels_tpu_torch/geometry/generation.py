"""Deterministic test geometry (helpers/GeometryGeneration.{h,cpp}).

Counterpart of gpu_voxels_tpu/geometry/generation.py: the same numpy code,
so generated scenes are identical in both packages. Points are host numpy
float32 arrays of shape [N, 3]; maps move them to their device on insert.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import transforms


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


def create_cylinder_of_points(center, radius, length_along_z, delta) -> np.ndarray:
    """createCylinderOfPoints (GeometryGeneration.cpp:136-161)."""
    center = np.asarray(center, dtype=np.float32)
    half = np.array([radius, radius, length_along_z / 2.0], dtype=np.float32)
    pts = create_box_of_points(center - half, center + half, delta)
    keep = np.sqrt((center[0] - pts[:, 0]) ** 2 + (center[1] - pts[:, 1]) ** 2) <= radius
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


@dataclass
class OrientedBoxParams:
    """cuda_datatypes.h OrientedBoxParams: center, half-dims, RPY rotation."""

    center: np.ndarray
    dim: np.ndarray  # half extents
    rot: np.ndarray  # roll, pitch, yaw


def create_oriented_box(params: OrientedBoxParams, spacing) -> np.ndarray:
    """createOrientedBox (GeometryGeneration.cpp:66-89): filled box, rotated."""
    d = np.asarray(params.dim, dtype=np.float32)
    pts = create_box_of_points(-d, d, spacing)
    m = transforms.from_rpy_np(params.rot, params.center)
    return pts @ m[:3, :3].T + m[:3, 3]


def create_oriented_box_edges(params: OrientedBoxParams, spacing) -> np.ndarray:
    """createOrientedBoxEdges (GeometryGeneration.cpp:32-64): box wireframe."""
    d = np.asarray(params.dim, dtype=np.float32)
    cloud = []
    for x in _frange32(-d[0], d[0], spacing):
        for sy in (d[1], -d[1]):
            for sz in (d[2], -d[2]):
                cloud.append((x, sy, sz))
    for y in _frange32(-d[1], d[1], spacing):
        for sx in (d[0], -d[0]):
            for sz in (d[2], -d[2]):
                cloud.append((sx, y, sz))
    for z in _frange32(-d[2], d[2], spacing):
        for sx in (d[0], -d[0]):
            for sy in (d[1], -d[1]):
                cloud.append((sx, sy, z))
    pts = np.asarray(cloud, dtype=np.float32)
    m = transforms.from_rpy_np(params.rot, params.center)
    return pts @ m[:3, :3].T + m[:3, 3]
