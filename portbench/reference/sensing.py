"""The depth insert of a dense int8 log-odds map, in plain torch.

The sensor's pose is Matrix3f::createFromRPY (Rz(yaw) Ry(pitch) Rx(roll),
cuda_matrices.h:274-277) with its position, in float32.

Hits. A measurement is back-projected in float32, x = (u - cx) * z / fx,
y = (v - cy) * z / fy, as the program does, and moved by the pose in
float64. The program takes the pose's product in float32 in an order of its
own, so a point closer than `geometry.BAND` voxels to a boundary may lie
in either cell: each voxel gets the fewest and the most measurements the
program can count there (`hits_band`).

The carve is computed exactly: each float32 operation is one torch
operation, rounded on its own, in the order of the plain spec (GPU-Voxels'
exact projective carve; the program's kernel rounds each product and sum
on its own too, built with `-fmad=false`):

    w = (k + 0.5) * side - origin                 per axis
    s = (R[0, i] * wx + R[1, i] * wy) + R[2, i] * wz    (R^T w, axis i)
    u = floor(fx * sx / sz + cx)

The log-odds update is monotone in the value before it and in the number
of measurements, so a voxel's value after any number of frames lies
between the value the fewest measurements give and the value the most
give (`fuse_band`): the same byte wherever no point was near a boundary.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import emulated_tf32, voxel_band

F32 = torch.float32
UNKNOWN, MIN_P, MAX_P = -128, -127, 127
OCCUPIED_DELTA, FREE_DELTA = 72, -10  # VoxelMapOperations.h:38-39


def threshold(p: float) -> int:
    """int8 log-odds of a [0, 1] threshold (DefaultCollider.hpp:94-98):
    float tmp = p * 254 - 127, truncated toward zero."""
    return int(p * (float(MAX_P) - float(MIN_P)) + MIN_P)


def pose(sensor: dict) -> np.ndarray:
    """float32 [4, 4] sensor-to-world: Rz(yaw) @ Ry(pitch) @ Rx(roll),
    each factor and product in float32, then the position."""
    rpy = np.asarray(sensor["rpy"], np.float32)

    def rot(a, axis):
        c, s = np.cos(a), np.sin(a)
        z, o = np.zeros_like(c), np.ones_like(c)
        rows = {0: [[o, z, z], [z, c, -s], [z, s, c]],
                1: [[c, z, s], [z, o, z], [-s, z, c]],
                2: [[c, -s, z], [s, c, z], [z, z, o]]}[axis]
        return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2).astype(np.float32)

    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot(rpy[2], 2) @ rot(rpy[1], 1) @ rot(rpy[0], 0)
    m[:3, 3] = np.asarray(sensor["position_m"], np.float32)
    return m


def camera_points(depth: torch.Tensor, sensor: dict):
    """(float32 [H*W, 3] sensor-frame points, bool [H*W] valid)."""
    h, w = depth.shape
    u = torch.arange(w, dtype=F32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=F32, device=depth.device)[:, None]
    z = depth
    x = (u - sensor["cx"]) * z / sensor["fx"]
    y = (v - sensor["cy"]) * z / sensor["fy"]
    pts = torch.stack([x, y, z * torch.ones_like(x)], dim=-1).reshape(-1, 3)
    valid = (depth != sensor["invalid_value"]).reshape(-1) & torch.isfinite(pts).all(dim=-1)
    return pts, valid


def hits_band(depth: torch.Tensor, sensor: dict, side: float, dims):
    """(lo, hi) int32 [N]: the fewest and the most measurements the
    program can count in each voxel."""
    pts, valid = camera_points(depth, sensor)
    m = torch.as_tensor(pose(sensor), dtype=torch.float64, device=depth.device)
    world = pts[valid].double() @ m[:3, :3].T + m[:3, 3]
    sure, cand = voxel_band(world[None], side, dims)
    n = dims[0] * dims[1] * dims[2]
    lo = torch.bincount(sure[sure >= 0], minlength=n)
    c, _ = torch.sort(cand[0], dim=-1)
    first = torch.ones_like(c, dtype=torch.bool)
    first[:, 1:] = c[:, 1:] != c[:, :-1]
    c = c[first & (c >= 0)]
    return lo.to(torch.int32), torch.bincount(c, minlength=n).to(torch.int32)


def hits_tf32(depth: torch.Tensor, sensor: dict, side: float, dims) -> torch.Tensor:
    """int32 [N]: measurements per voxel with the pose's product taking its
    operands in TF32 and its sums in float32 (the control)."""
    pts, valid = camera_points(depth, sensor)
    m = torch.as_tensor(pose(sensor), device=depth.device)
    p, r = emulated_tf32(pts[valid]), emulated_tf32(m[:3, :3].contiguous())
    world = torch.stack([(p[:, 0] * r[i, 0] + p[:, 1] * r[i, 1]) + p[:, 2] * r[i, 2] for i in range(3)], -1)
    c = torch.floor((world + m[:3, 3]) * float(np.float32(1.0 / float(side)))).to(torch.int64)
    dx, dy, dz = dims
    inside = (c >= 0).all(dim=-1) & (c[:, 0] < dx) & (c[:, 1] < dy) & (c[:, 2] < dz)
    key = (c[:, 2] * dy + c[:, 1]) * dx + c[:, 0]
    return torch.bincount(key[inside], minlength=dx * dy * dz).to(torch.int32)


def exact_carve(depth: torch.Tensor, sensor: dict, side: float, dims, tf32: bool = False) -> torch.Tensor:
    """bool [N]: voxels seen free. A voxel is free iff its centre lies in
    front of the camera (sz > 1e-6), projects inside the image onto a valid
    pixel, and sz < d - side (one voxel of room). With `tf32` the
    rotation's products take their operands in TF32 (the control)."""
    m = pose(sensor)
    h, w = depth.shape
    dx, dy, dz = dims
    dev = depth.device
    s = float(np.float32(side))
    zi = torch.arange(dz, dtype=F32, device=dev).view(dz, 1, 1)
    yi = torch.arange(dy, dtype=F32, device=dev).view(1, dy, 1)
    xi = torch.arange(dx, dtype=F32, device=dev).view(1, 1, dx)
    wx = (xi + 0.5) * s - float(m[0, 3])
    wy = (yi + 0.5) * s - float(m[1, 3])
    wz = (zi + 0.5) * s - float(m[2, 3])
    r = torch.as_tensor(m[:3, :3], device=dev)
    if tf32:
        r, wx, wy, wz = (emulated_tf32(t.contiguous()) for t in (r, wx, wy, wz))
    r = r.tolist()
    sx, sy, sz = ((wx * r[0][i] + wy * r[1][i]) + wz * r[2][i] for i in range(3))
    front = sz > 1e-6
    safe = torch.where(front, sz, 1.0)
    u = _floor_int(sensor["fx"] * sx / safe + sensor["cx"])
    v = _floor_int(sensor["fy"] * sy / safe + sensor["cy"])
    fov = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d = depth.reshape(-1)[(v.clamp(0, h - 1).to(torch.int64) * w + u.clamp(0, w - 1).to(torch.int64))]
    eps = float(np.float32(1.0) * np.float32(side))
    return (fov & (d != sensor["invalid_value"]) & (sz < d - eps)).reshape(-1)


def _floor_int(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(torch.floor(x).clamp(-(2.0**30), 2.0**30), nan=0.0).to(torch.int32)


def update(env: torch.Tensor, n_hits: torch.Tensor, carved: torch.Tensor) -> torch.Tensor:
    """int8 [N]: one frame's update: +72 per measurement, -10 where carved
    free and not hit, saturating at -127 and 127; untouched voxels keep
    their value (UNKNOWN -128 included)."""
    free = carved & (n_hits == 0)
    delta = n_hits * OCCUPIED_DELTA + free.to(torch.int32) * FREE_DELTA
    new = (env.to(torch.int32) + delta).clamp(MIN_P, MAX_P).to(torch.int8)
    return torch.where(delta != 0, new, env)


def fuse_band(lo: torch.Tensor, hi: torch.Tensor, depth: torch.Tensor, sensor: dict, side: float, dims):
    """(lo, hi) int8 [N]: the least and the most value each voxel can hold
    after this frame, from the least and the most before it."""
    n_lo, n_hi = hits_band(depth, sensor, side, dims)
    carved = exact_carve(depth, sensor, side, dims)
    return update(lo, n_lo, carved), update(hi, n_hi, carved)


def fuse_tf32(env: torch.Tensor, depth: torch.Tensor, sensor: dict, side: float, dims) -> torch.Tensor:
    """int8 [N]: one frame's update with every product of the pose in TF32."""
    return update(env, hits_tf32(depth, sensor, side, dims), exact_carve(depth, sensor, side, dims, tf32=True))
