"""Peaks of one NVIDIA H100 SXM (data sheet, dense rates) and the
operations and bytes of the kernels whose roofline share a metric reads.

Frozen copy of chip_smoke.py:419-422 (HBM_BYTES_PER_S, ALU_OPS_PER_S) and
:4045-4048 (K3's count: per voxel 33 float32 operations, the centre, the
rotation, the projection with two IEEE divisions counted as one operation
each, two floors and the depth test; it reads the frame and the pose once
and writes one byte of mask a voxel). The card's power limit is printed
beside every run; the peaks assume 700 W.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12  # float32 outside the tensor cores
K3_OPS_PER_VOXEL = 33
POSE_BYTES = 64


def least_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take, and which peak bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_least_s(voxels: int, pixels: int) -> tuple[float, str]:
    """The exact carve of one frame of `pixels` float32 depths over `voxels`."""
    return least_s(voxels + 4 * pixels + POSE_BYTES, K3_OPS_PER_VOXEL * voxels)
