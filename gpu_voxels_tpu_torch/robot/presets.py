"""Ready-made robot models; counterpart of gpu_voxels_tpu/robot/presets.py,
whose numpy geometry is copied as it is, so the clouds are byte-equal.

(The reference ships UR3/5/10, HoLLiE and SVH
binvox assets under packages/gpu_voxels/models/; binary assets are not
copied, but the UR arms' kinematics are standard published DH parameters, so
the robots are constructible without files).

Each preset returns a KinematicChain whose link geometry is a procedurally
sampled cylinder per link (radius/length from the datasheet footprint) —
adequate for collision checking at centimeter voxels; swap in measured
.binvox clouds via update_point_cloud for exact hulls.
"""
from __future__ import annotations

import numpy as np

from ..geometry.pointcloud import MetaPointCloud
from .dh import DHParameters, KinematicChain

# Universal Robots standard DH parameters (d, a, alpha) in meters/radians.
_UR_DH = {
    "ur3": dict(
        d=[0.1519, 0.0, 0.0, 0.11235, 0.08535, 0.0819],
        a=[0.0, -0.24365, -0.21325, 0.0, 0.0, 0.0],
        alpha=[np.pi / 2, 0.0, 0.0, np.pi / 2, -np.pi / 2, 0.0],
        radius=0.045,
    ),
    "ur5": dict(
        d=[0.089159, 0.0, 0.0, 0.10915, 0.09465, 0.0823],
        a=[0.0, -0.425, -0.39225, 0.0, 0.0, 0.0],
        alpha=[np.pi / 2, 0.0, 0.0, np.pi / 2, -np.pi / 2, 0.0],
        radius=0.06,
    ),
    "ur10": dict(
        d=[0.1273, 0.0, 0.0, 0.163941, 0.1157, 0.0922],
        a=[0.0, -0.612, -0.5723, 0.0, 0.0, 0.0],
        alpha=[np.pi / 2, 0.0, 0.0, np.pi / 2, -np.pi / 2, 0.0],
        radius=0.075,
    ),
}

_UR_JOINTS = [
    "shoulder_pan_joint",
    "shoulder_lift_joint",
    "elbow_joint",
    "wrist_1_joint",
    "wrist_2_joint",
    "wrist_3_joint",
]


def _cylinder(axis: int, start: float, end: float, radius: float, spacing: float) -> np.ndarray:
    """Solid cylinder along one local axis from start to end."""
    lo, hi = (start, end) if end >= start else (end, start)
    ts = np.arange(lo, hi + 1e-6, spacing, dtype=np.float32)
    if len(ts) == 0:
        ts = np.array([lo], np.float32)
    ring = [np.zeros((1, 2), np.float32)]
    rr = np.arange(spacing, radius + 1e-6, spacing, dtype=np.float32)
    for r in rr:
        n = max(int(np.ceil(2 * np.pi * r / spacing)), 4)
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False, dtype=np.float32)
        ring.append(np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1))
    ring = np.concatenate(ring, axis=0)
    other = [a for a in (0, 1, 2) if a != axis]
    pts = np.zeros((len(ts) * len(ring), 3), np.float32)
    k = 0
    for t in ts:
        pts[k : k + len(ring), axis] = t
        pts[k : k + len(ring), other[0]] = ring[:, 0]
        pts[k : k + len(ring), other[1]] = ring[:, 1]
        k += len(ring)
    return pts


def _segment_cloud(a_prev: float, d_prev: float, radius: float, spacing: float) -> np.ndarray:
    """Geometry of the body created by the PREVIOUS joint's DH translation.

    In link i's local frame, the segment from joint i-1's axis to this frame's
    origin spans [0, -a] along x and [0, -d] along z (the DH translation run
    backwards), so the body rotates rigidly with joint i-1 — which is exactly
    the chain convention (a cloud on link i transforms by DH_0..DH_{i-1})."""
    parts = []
    if abs(a_prev) > 1e-6:
        parts.append(_cylinder(0, 0.0, -a_prev, radius, spacing))
    if abs(d_prev) > 1e-6:
        parts.append(_cylinder(2, 0.0, -d_prev, radius, spacing))
    if not parts:
        parts.append(_cylinder(2, -radius, radius, radius, spacing))
    return np.concatenate(parts, axis=0)


def ur_robot(model: str = "ur10", spacing: float = 0.02, device=None) -> KinematicChain:
    """A UR3/UR5/UR10 kinematic chain with sampled link geometry.

    Joint names follow the ROS convention (shoulder_pan_joint, ...); a fixed
    `tool0` frame carries the last segment; joint limits are +-2*pi like the
    hardware. The clouds live on `device` (default: the card).
    """
    cfg = _UR_DH[model.lower()]
    params = []
    clouds = []
    names = list(_UR_JOINTS) + ["tool0"]
    for i, jn in enumerate(_UR_JOINTS):
        params.append(
            DHParameters(d=cfg["d"][i], theta=0.0, a=cfg["a"][i], alpha=cfg["alpha"][i])
        )
        a_prev = cfg["a"][i - 1] if i > 0 else 0.0
        d_prev = cfg["d"][i - 1] if i > 0 else 0.0
        clouds.append(_segment_cloud(a_prev, d_prev, cfg["radius"], spacing))
    params.append(DHParameters(d=0.0, theta=0.0, a=0.0, alpha=0.0))  # tool0
    clouds.append(_segment_cloud(cfg["a"][5], cfg["d"][5], cfg["radius"], spacing))
    limits_lo = {n: -2 * np.pi for n in _UR_JOINTS}
    limits_hi = {n: 2 * np.pi for n in _UR_JOINTS}
    return KinematicChain(
        names,
        params,
        MetaPointCloud.from_clouds(clouds, names, device=device),
        lower_limits=limits_lo,
        upper_limits=limits_hi,
    )
