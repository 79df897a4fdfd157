"""4x4 rigid transforms and DH link matrices (reference: helpers/cuda_matrices.h,
robot/dh_robot/KinematicLink.cu:24-89).

Counterpart of gpu_voxels_tpu/geometry/transforms.py, on torch tensors.

* ``from_rpy(roll, pitch, yaw) = Rz(yaw) @ Ry(pitch) @ Rx(roll)``
  (cuda_matrices.h:274-277, "acts like ROS tf setRPY").
* The DH link matrix is the standard Denavit-Hartenberg matrix with the
  joint value added to theta (revolute) or d (prismatic).
* Points are column vectors: ``p' = M[:3,:3] @ p + M[:3,3]``.

Coordinates feed floor()-based voxelization, so every product here runs in
full float32: on CUDA tensors the functions refuse to run while TF32
matmuls are allowed. Host poses that must match the reference bit for bit
(a Sensor's pose) are numpy, built by `from_rpy_np` exactly as the
reference's ``xp=np`` branch builds them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device, to_device

F32 = torch.float32
REVOLUTE = 0
PRISMATIC = 1


def _check_full_f32(t: torch.Tensor) -> None:
    if t.is_cuda and (
        torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "transforms need full-f32 matmuls: set torch.backends.cuda.matmul.allow_tf32 = False "
            "and torch.set_float32_matmul_precision('highest')"
        )


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-precision matrix multiply."""
    _check_full_f32(a)
    return torch.matmul(a, b)


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=F32, device=resolve_device(device))


def from_translation(t, device=None) -> torch.Tensor:
    m = torch.eye(4, dtype=F32, device=resolve_device(device))
    m[:3, 3] = to_device(t, F32, m.device)
    return m


def _angle(a, device=None) -> torch.Tensor:
    return to_device(a, F32, device)


def _mat3(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2).to(F32)


def rot_x(roll, device=None) -> torch.Tensor:
    roll = _angle(roll, device)
    c, s = torch.cos(roll), torch.sin(roll)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[o, z, z], [z, c, -s], [z, s, c]])


def rot_y(pitch, device=None) -> torch.Tensor:
    pitch = _angle(pitch, device)
    c, s = torch.cos(pitch), torch.sin(pitch)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, z, s], [z, o, z], [-s, z, c]])


def rot_z(yaw, device=None) -> torch.Tensor:
    yaw = _angle(yaw, device)
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return _mat3([[c, -s, z], [s, c, z], [z, z, o]])


def from_rpy(rpy, translation=None, device=None) -> torch.Tensor:
    """Matrix4f::createFromRotationAndTranslation(Matrix3f::createFromRPY(rpy), t).

    Rotation = Rz(yaw) @ Ry(pitch) @ Rx(roll) (cuda_matrices.h:274-277).
    """
    rpy = to_device(rpy, F32, device)
    r3 = matmul(matmul(rot_z(rpy[..., 2]), rot_y(rpy[..., 1])), rot_x(rpy[..., 0]))
    return compose(r3, translation)


def compose(rot3, translation=None) -> torch.Tensor:
    """Build a 4x4 from a 3x3 rotation and a translation."""
    rot3 = torch.as_tensor(rot3, dtype=F32)
    m = torch.zeros(rot3.shape[:-2] + (4, 4), dtype=F32, device=rot3.device)
    m[..., :3, :3] = rot3
    if translation is not None:
        m[..., :3, 3] = to_device(translation, F32, rot3.device)
    m[..., 3, 3].fill_(1.0)  # a scalar setitem would sync with the device
    return m


def dh_matrix(d, theta, a, alpha, value, joint_type=REVOLUTE, device=None) -> torch.Tensor:
    """DHParameters::convertDHtoM (KinematicLink.cu:24-89), b == 0.

    d, theta, a, alpha are host floats, rounded to f32 as the reference's
    ``xp.asarray(.., float32)`` does; `value` may be a tensor of joint
    values, which gives a [..., 4, 4] batch on its device.
    """
    v = to_device(value, F32, device)

    def f32(x):
        return torch.full_like(v, float(x))

    d, theta, a, alpha = f32(d), f32(theta), f32(a), f32(alpha)
    if joint_type == PRISMATIC:
        d_c, th_c = d + v, theta
    else:
        d_c, th_c = d, theta + v
    ca, sa = torch.cos(alpha), torch.sin(alpha)
    ct, st = torch.cos(th_c), torch.sin(th_c)
    z, o = torch.zeros_like(ct), torch.ones_like(ct)
    rows = [
        [ct, -st * ca, st * sa, a * ct],
        [st, ct * ca, -ct * sa, a * st],
        [z, sa, ca, d_c],
        [z, z, z, o],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def transform_points(matrix, points, device=None) -> torch.Tensor:
    """Apply a 4x4 (or a batch of per-point 4x4s) to [N,3] points
    (kernelTransformCloud, helpers/kernels/MetaPointCloudOperations.h:36-53).
    Host points go to `device` (default: the card)."""
    points = to_device(points, F32, device)
    matrix = to_device(matrix, F32, points.device)
    rot = matrix[..., :3, :3]
    t = matrix[..., :3, 3]
    if matrix.ndim == 2:
        return matmul(points, rot.T) + t
    return matmul(rot, points[..., None])[..., 0] + t


def invert(matrix: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse (rotation transpose + back-rotated translation)."""
    rt = matrix[..., :3, :3].transpose(-1, -2)
    ti = -matmul(rt, matrix[..., :3, 3:4])[..., 0]
    return compose(rt, ti)


def from_rpy_np(rpy, translation=None) -> np.ndarray:
    """Host float32 pose, computed as the reference's ``from_rpy(..., xp=np)``."""
    rpy = np.asarray(rpy, dtype=np.float32)

    def mat3(rows):
        return np.stack([np.stack(r, axis=-1) for r in rows], axis=-2).astype(np.float32)

    def rot(a, axis):
        c, s = np.cos(a), np.sin(a)
        z, o = np.zeros_like(c), np.ones_like(c)
        if axis == 0:
            return mat3([[o, z, z], [z, c, -s], [z, s, c]])
        if axis == 1:
            return mat3([[c, z, s], [z, o, z], [-s, z, c]])
        return mat3([[c, -s, z], [s, c, z], [z, z, o]])

    r3 = rot(rpy[..., 2], 2) @ rot(rpy[..., 1], 1) @ rot(rpy[..., 0], 0)
    return compose_np(r3, translation)


def compose_np(rot3, translation=None) -> np.ndarray:
    """Host float32 4x4 from a 3x3 rotation and a translation (the
    reference's ``compose(..., xp=np)``)."""
    rot3 = np.asarray(rot3, dtype=np.float32)
    m = np.zeros(rot3.shape[:-2] + (4, 4), dtype=np.float32)
    m[..., :3, :3] = rot3
    if translation is not None:
        m[..., :3, 3] = np.asarray(translation, dtype=np.float32)
    m[..., 3, 3] = 1.0
    return m


def from_translation_np(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = np.asarray(t, dtype=np.float32)
    return m


def axis_angle_np(axis, angle) -> np.ndarray:
    """Host float32 3x3 rotation about a (normalized) axis by angle
    (Rodrigues), computed as the reference's ``axis_angle(..., xp=np)``."""
    axis = np.asarray(axis, dtype=np.float32)
    axis = axis / np.sqrt(np.sum(axis * axis) + np.float32(1e-30))
    x, y, z = axis[0], axis[1], axis[2]
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    rows = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return np.stack([np.stack([np.asarray(e, dtype=np.float32) for e in r], axis=-1) for r in rows], axis=-2)


def to_rpy_np(matrix, solution: int = 1) -> np.ndarray:
    """Matrix3f::toRPY (cuda_matrices.h:285-326) on the host: a 3x3 or 4x4
    rotation (batched) -> float32 (roll, pitch, yaw), computed as the
    reference's ``to_rpy(..., xp=np)``. `solution` 1 or 2 picks the branch;
    where ``1 - |a31| < 1e-5`` (gimbal lock) both give yaw 0 and pitch
    +-pi/2."""
    r = np.asarray(matrix, dtype=np.float32)[..., :3, :3]
    a11, a12, a13 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    a21 = r[..., 1, 0]
    a31, a32, a33 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]

    singular = (1.0 - np.abs(a31)) < np.float32(1e-5)
    y1 = -np.arcsin(np.clip(a31, -1.0, 1.0))
    y = y1 if solution == 1 else np.float32(np.pi) - y1
    cy = np.cos(y)
    safe = np.where(singular, np.ones_like(cy), cy)
    x = np.arctan2(a32 / safe, a33 / safe)
    z = np.arctan2(a21 / safe, a11 / safe)

    locked_down = a31 < 0  # pitch = +pi/2 (cuda_matrices.h:297-304)
    xs = np.where(locked_down, np.arctan2(a12, a13), np.arctan2(-a12, -a13))
    ys = np.where(locked_down, np.float32(np.pi / 2), np.float32(-np.pi / 2))

    roll = np.where(singular, xs, x)
    pitch = np.where(singular, ys, y)
    yaw = np.where(singular, np.zeros_like(z), z)
    return np.stack([roll, pitch, yaw], axis=-1).astype(np.float32)


def invert_np(matrix: np.ndarray) -> np.ndarray:
    """Host rigid-transform inverse (the reference's ``invert(..., xp=np)``)."""
    rt = np.swapaxes(matrix[..., :3, :3], -1, -2)
    ti = -(rt @ matrix[..., :3, 3][..., None])[..., 0]
    return compose_np(rt, ti)
