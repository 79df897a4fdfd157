"""CUDA kernel K3: the exact projective free-space carve.

Counterpart of gpu_voxels_tpu/ops/raycast_pallas.py
(`projective_free_space_exact_tpu`); the kernel is csrc/carve_exact.cu. The
wrapper

* on a CPU depth image returns the plain torch version
  (`projective_free_space_plain`, the spec in ops/raycast.py);
* on a CUDA depth image launches the kernel on the current stream, without
  synchronising, and adds one to `launches[name]`; an input the kernel does
  not take raises. There is no fallback.

The pose is a [4, 4] float32 tensor on the image's device, read by the
kernel; the host never reads it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels, to_device
from . import raycast

projective_free_space_plain = raycast.projective_free_space

# kernel launches since the last reset, by wrapper name
launches = {"projective_free_space_exact": 0}


def projective_free_space_exact(
    depth: torch.Tensor,
    pose,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims,
    invalid_value: float = 0.0,
    eps_vox: float = 1.0,
) -> torch.Tensor:
    """bool[dz*dy*dx] exact free-space mask, bit-identical to
    `projective_free_space` (K3 on CUDA)."""
    if depth.device.type == "cpu":
        return projective_free_space_plain(
            depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value, eps_vox
        )
    if not depth.is_cuda:
        raise ValueError(f"the carve kernel needs a CUDA depth image, got {depth.device}")
    if depth.dtype != torch.float32 or depth.ndim != 2 or not depth.is_contiguous():
        raise ValueError(f"depth must be a contiguous float32 [H, W] image, got {depth.dtype} {tuple(depth.shape)}")
    pose = to_device(pose, torch.float32, depth.device).contiguous()
    if pose.shape != (4, 4):
        raise ValueError(f"pose must be [4, 4], got {tuple(pose.shape)}")
    dx, dy, dz = (int(d) for d in dims)
    if dx * dy * dz >= 2**31:
        raise ValueError(f"the carve kernel indexes voxels in int32; {dims} is too large")
    h, w = depth.shape
    # the spec's threshold is f32(eps_vox) * f32(side), rounded in f32
    eps = float(np.float32(eps_vox) * np.float32(side_length))
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = kernels.library().gv_carve_exact(
            depth.data_ptr(), h, w, pose.data_ptr(), fx, fy, cx, cy, side_length, eps,
            invalid_value, dx, dy, dz, out.data_ptr(), stream,
        )
    kernels.check(err, "projective_free_space_exact")
    launches["projective_free_space_exact"] += 1
    return out
