"""CUDA kernels K3 and K6: the exact and the pooled projective free-space
carves.

Counterpart of gpu_voxels_tpu/ops/raycast_pallas.py
(`projective_free_space_exact_tpu`, `projective_free_space_tpu`); the
kernels are csrc/carve_exact.cu and csrc/carve_pooled.cu. Each wrapper

* on a CPU depth image returns the plain torch version (`*_plain`, the
  specs in ops/raycast.py);
* on a CUDA depth image launches its kernel on the current stream, without
  synchronising, and adds one to `launches[name]`; an input the kernel does
  not take raises. There is no fallback.

The pose is a [4, 4] float32 tensor on the image's device, read by the
kernel; the host never reads it. The pooled carve's min-pooled depth table
is built in plain torch (`raycast.min_pool_depth`), as the reference builds
it outside its kernel.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels, to_device
from . import raycast

projective_free_space_plain = raycast.projective_free_space
projective_free_space_pooled_plain = raycast.projective_free_space_pooled

# kernel launches since the last reset, by wrapper name
launches = {"projective_free_space_exact": 0, "projective_free_space_pooled": 0}


def _checked(depth: torch.Tensor, pose, dims, name: str):
    """The pose on the image's device, the dims as ints, the f32 threshold;
    raises on what the carve kernels do not take."""
    if not depth.is_cuda:
        raise ValueError(f"the {name} kernel needs a CUDA depth image, got {depth.device}")
    if depth.dtype != torch.float32 or depth.ndim != 2 or not depth.is_contiguous():
        raise ValueError(f"depth must be a contiguous float32 [H, W] image, got {depth.dtype} {tuple(depth.shape)}")
    pose = to_device(pose, torch.float32, depth.device).contiguous()
    if pose.shape != (4, 4):
        raise ValueError(f"pose must be [4, 4], got {tuple(pose.shape)}")
    dx, dy, dz = (int(d) for d in dims)
    if dx * dy * dz >= 2**31:
        raise ValueError(f"the {name} kernel indexes voxels in int32; {dims} is too large")
    return pose, (dx, dy, dz)


def _eps(eps_vox: float, side_length: float) -> float:
    """The spec's threshold f32(eps_vox) * f32(side), rounded in f32."""
    return float(np.float32(eps_vox) * np.float32(side_length))


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
    pose, (dx, dy, dz) = _checked(depth, pose, dims, "carve")
    h, w = depth.shape
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = kernels.library().gv_carve_exact(
            depth.data_ptr(), h, w, pose.data_ptr(), fx, fy, cx, cy, side_length, _eps(eps_vox, side_length),
            invalid_value, dx, dy, dz, out.data_ptr(), stream,
        )
    kernels.check(err, "projective_free_space_exact")
    launches["projective_free_space_exact"] += 1
    return out


def projective_free_space_pooled(
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
    pool: int = 4,
) -> torch.Tensor:
    """bool[dz*dy*dx] pooled conservative free-space mask, bit-identical to
    `projective_free_space_pooled` (K6 on CUDA)."""
    if depth.device.type == "cpu":
        return projective_free_space_pooled_plain(
            depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value, eps_vox, pool
        )
    pose, (dx, dy, dz) = _checked(depth, pose, dims, "pooled carve")
    if int(pool) < 1:
        raise ValueError(f"the pool must be >= 1, got {pool}")
    h, w = depth.shape
    pm = raycast.min_pool_depth(depth, int(pool), invalid_value).contiguous()
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = kernels.library().gv_carve_pooled(
            pm.data_ptr(), pm.shape[0], pm.shape[1], int(pool), h, w, pose.data_ptr(), fx, fy, cx, cy,
            side_length, _eps(eps_vox, side_length), dx, dy, dz, out.data_ptr(), stream,
        )
    kernels.check(err, "projective_free_space_pooled")
    launches["projective_free_space_pooled"] += 1
    return out
