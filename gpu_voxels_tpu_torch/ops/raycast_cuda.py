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
kernel; the host never reads it. The pooled carve is two kernels of
csrc/carve_pooled.cu, launched one after the other on the same stream: the
P x P min-pool of the frame (`min_pool_depth`, spec `raycast.min_pool_depth`;
the reference builds its table outside its kernel too) and the carve against
that table (`carve_against_pooled`, spec `raycast.carve_against_pooled`).
Each counts its own launches; the carve's count is kept under its wrapper's
name, `projective_free_space_pooled`, one per call of the wrapper.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import kernels, to_device
from . import raycast

projective_free_space_plain = raycast.projective_free_space
projective_free_space_pooled_plain = raycast.projective_free_space_pooled
min_pool_depth_plain = raycast.min_pool_depth
carve_against_pooled_plain = raycast.carve_against_pooled

# kernel launches since the last reset, by wrapper name
launches = {"projective_free_space_exact": 0, "projective_free_space_pooled": 0, "min_pool_depth": 0}


def _checked_image(image: torch.Tensor, name: str) -> None:
    """Raises on an image (a depth frame or a pooled table) the kernels do not take."""
    if not image.is_cuda:
        raise ValueError(f"the {name} kernel needs a CUDA depth image, got {image.device}")
    if image.dtype != torch.float32 or image.ndim != 2 or not image.is_contiguous():
        raise ValueError(f"depth must be a contiguous float32 [H, W] image, got {image.dtype} {tuple(image.shape)}")


def _checked(depth: torch.Tensor, pose, dims, name: str):
    """The pose on the image's device, the dims as ints; raises on what the
    carve kernels do not take."""
    _checked_image(depth, name)
    pose = to_device(pose, torch.float32, depth.device).contiguous()
    if pose.shape != (4, 4):
        raise ValueError(f"pose must be [4, 4], got {tuple(pose.shape)}")
    dx, dy, dz = (int(d) for d in dims)
    if dx * dy * dz >= 2**31:
        raise ValueError(f"the {name} kernel indexes voxels in int32; {dims} is too large")
    return pose, (dx, dy, dz)


def _checked_z0(z_index_offset: int, dz: int) -> int:
    """The slab's first global row; raises where a global z index would
    leave +-2^24, the range f32 holds exactly."""
    z0 = int(z_index_offset)
    if abs(z0) + dz > 2**24:
        raise ValueError(f"the carve's global z indices must stay within +-2^24 (exact in f32), got {z0} + {dz}")
    return z0


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
    z_index_offset: int = 0,
) -> torch.Tensor:
    """bool[dz*dy*dx] exact free-space mask, bit-identical to
    `projective_free_space` (K3 on CUDA). With `z_index_offset` z0 the grid
    is the z-slab [z0, z0 + dz) of a larger one, carved in the global frame."""
    if depth.device.type == "cpu":
        return projective_free_space_plain(
            depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value, eps_vox, z_index_offset
        )
    pose, (dx, dy, dz) = _checked(depth, pose, dims, "carve")
    z0 = _checked_z0(z_index_offset, dz)
    h, w = depth.shape
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = kernels.library().gv_carve_exact(
            depth.data_ptr(), h, w, pose.data_ptr(), fx, fy, cx, cy, side_length, _eps(eps_vox, side_length),
            invalid_value, dx, dy, dz, z0, out.data_ptr(), stream,
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
    z_index_offset: int = 0,
) -> torch.Tensor:
    """bool[dz*dy*dx] pooled conservative free-space mask, bit-identical to
    `projective_free_space_pooled` (K6 on CUDA: the pool kernel, then the
    carve kernel). With `z_index_offset` z0 the grid is the z-slab
    [z0, z0 + dz) of a larger one, carved in the global frame."""
    if depth.device.type == "cpu":
        return projective_free_space_pooled_plain(
            depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value, eps_vox, pool, z_index_offset
        )
    pm = min_pool_depth(depth, pool, invalid_value)
    return carve_against_pooled(pm, pool, depth.shape, pose, fx, fy, cx, cy, side_length, dims, eps_vox,
                                z_index_offset)


def _pooled_shape(h: int, w: int, pool) -> tuple[int, int]:
    if int(pool) < 1:
        raise ValueError(f"the pool must be >= 1, got {pool}")
    return -(-h // int(pool)), -(-w // int(pool))


def min_pool_depth(depth: torch.Tensor, pool: int, invalid_value: float = 0.0) -> torch.Tensor:
    """f32[ceil(h/P), ceil(w/P)] conservative P x P min-pool of a depth
    image, bit-identical to `raycast.min_pool_depth` (NaN included; the pool
    kernel of K6 on CUDA)."""
    if depth.device.type == "cpu":
        return min_pool_depth_plain(depth, pool, invalid_value)
    _checked_image(depth, "min-pool")
    h, w = depth.shape
    ph, pw = _pooled_shape(h, w, pool)
    out = torch.empty((ph, pw), dtype=torch.float32, device=depth.device)
    stream = torch.cuda.current_stream(depth.device).cuda_stream
    with torch.cuda.device(depth.device):
        err = kernels.library().gv_min_pool_depth(
            depth.data_ptr(), h, w, int(pool), invalid_value, out.data_ptr(), stream
        )
    kernels.check(err, "min_pool_depth")
    launches["min_pool_depth"] += 1
    return out


def carve_against_pooled(
    pm: torch.Tensor,
    pool: int,
    image_shape,
    pose,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims,
    eps_vox: float = 1.0,
    z_index_offset: int = 0,
) -> torch.Tensor:
    """bool[dz*dy*dx]: the pooled carve against a prebuilt table pm of an
    image of `image_shape` (h, w), bit-identical to
    `raycast.carve_against_pooled` (K6's carve kernel on CUDA), of the
    z-slab [z0, z0 + dz) of a larger grid with `z_index_offset` z0. The
    slabs of one frame share its table: the pool runs once a frame."""
    if pm.device.type == "cpu":
        return carve_against_pooled_plain(pm, pool, image_shape, pose, fx, fy, cx, cy, side_length, dims, eps_vox,
                                          z_index_offset)
    pose, (dx, dy, dz) = _checked(pm, pose, dims, "pooled carve")
    z0 = _checked_z0(z_index_offset, dz)
    h, w = (int(s) for s in image_shape)
    if tuple(pm.shape) != _pooled_shape(h, w, pool):
        raise ValueError(f"a {h}x{w} image pools to {_pooled_shape(h, w, pool)} at P = {pool}, got {tuple(pm.shape)}")
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=pm.device)
    stream = torch.cuda.current_stream(pm.device).cuda_stream
    with torch.cuda.device(pm.device):
        err = kernels.library().gv_carve_pooled(
            pm.data_ptr(), pm.shape[0], pm.shape[1], int(pool), h, w, pose.data_ptr(), fx, fy, cx, cy,
            side_length, _eps(eps_vox, side_length), dx, dy, dz, z0, out.data_ptr(), stream,
        )
    kernels.check(err, "projective_free_space_pooled")
    launches["projective_free_space_pooled"] += 1
    return out
