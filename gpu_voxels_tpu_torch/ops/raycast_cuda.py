"""CUDA kernels K3 and K6: the exact and the pooled projective free-space
carves.

Counterpart of gpu_voxels_tpu/ops/raycast_pallas.py
(`projective_free_space_exact_tpu`, `projective_free_space_tpu`); the
kernels are csrc/carve_exact.cu and csrc/carve_pooled.cu. Each wrapper

* on a CPU depth image returns the plain torch version (`*_plain`, the
  specs in ops/raycast.py);
* on a CUDA depth image launches its kernel on the current stream with
  `kernels.launch`, without synchronising; an input the kernel does not
  take raises. There is no fallback.

The pose is a [4, 4] float32 tensor on the image's device, read by the
kernel; the host never reads it. The pooled carve is two kernels of
csrc/carve_pooled.cu, launched one after the other on the same stream: the
P x P min-pool of the frame (`min_pool_depth`, spec `raycast.min_pool_depth`;
the reference builds its table outside its kernel too) and the carve against
that table (`carve_against_pooled`, spec `raycast.carve_against_pooled`).

Around the carve, a depth frame's update of a log-odds map is two launches
of csrc/depth_insert.cu, which replace no TPU kernel (the reference's frame
update is jnp that XLA fuses): the frame's hit counts (`depth_hits`, S1,
spec `raycast.depth_hits`; the memset that zeroes them is in the same call)
and the log-odds update (`log_odds_update`, S2, spec
`raycast.log_odds_update`). S2 equals its spec byte for byte; S1's counts
agree with the plain version's wherever no measurement lies within a few
float32 ulps of a cell boundary (csrc/depth_insert.cu, Rounding). A pose on
the host travels in S1's launch arguments; a pose on the card is read there.
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
depth_hits_plain = raycast.depth_hits
log_odds_update_plain = raycast.log_odds_update


def _checked(image: torch.Tensor, image_name: str, pose, dims, name: str):
    """The pose on the image's device, the dims as ints; raises on what the
    carve kernels do not take (the image: a depth frame or a pooled table)."""
    device = image.device
    kernels.check_input(image, image_name, torch.float32, ("H", "W"), device)
    pose = to_device(pose, torch.float32, device).contiguous()
    kernels.check_input(pose, "pose", torch.float32, (4, 4), device)
    return pose, _checked_dims(dims, name)


def _checked_dims(dims, name: str) -> tuple[int, int, int]:
    dx, dy, dz = (int(d) for d in dims)
    if dx * dy * dz >= 2**31:
        raise ValueError(f"the {name} kernel indexes voxels in int32; {dims} is too large")
    return dx, dy, dz


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
    pose, (dx, dy, dz) = _checked(depth, "depth", pose, dims, "carve")
    z0 = _checked_z0(z_index_offset, dz)
    h, w = depth.shape
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=depth.device)
    kernels.launch("gv_carve_exact", depth.device, depth.data_ptr(), h, w, pose.data_ptr(), fx, fy, cx, cy, side_length,
                   _eps(eps_vox, side_length), invalid_value, dx, dy, dz, z0, out.data_ptr())
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
    kernels.check_input(depth, "depth", torch.float32, ("H", "W"), depth.device)
    h, w = depth.shape
    ph, pw = _pooled_shape(h, w, pool)
    out = torch.empty((ph, pw), dtype=torch.float32, device=depth.device)
    kernels.launch("gv_min_pool_depth", depth.device, depth.data_ptr(), h, w, int(pool), invalid_value, out.data_ptr())
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
    pose, (dx, dy, dz) = _checked(pm, "pm", pose, dims, "pooled carve")
    z0 = _checked_z0(z_index_offset, dz)
    h, w = (int(s) for s in image_shape)
    if tuple(pm.shape) != _pooled_shape(h, w, pool):
        raise ValueError(f"a {h}x{w} image pools to {_pooled_shape(h, w, pool)} at P = {pool}, got {tuple(pm.shape)}")
    out = torch.empty(dx * dy * dz, dtype=torch.bool, device=pm.device)
    kernels.launch("gv_carve_pooled", pm.device, pm.data_ptr(), pm.shape[0], pm.shape[1], int(pool), h, w,
                   pose.data_ptr(), fx, fy, cx, cy, side_length, _eps(eps_vox, side_length), dx, dy, dz, z0,
                   out.data_ptr())
    return out


def _pose_pointers(pose, device: torch.device) -> tuple:
    """(device pose, host pose) for S1, one of them NULL, and the host array
    the host pointer points into: a CUDA pose is read on its card, anything
    else is a host [4, 4] rounded to float32, as `to_device` rounds it."""
    if isinstance(pose, torch.Tensor) and pose.device.type != "cpu":
        kernels.check_input(pose, "pose", torch.float32, (4, 4), device)
        return pose.data_ptr(), None, None
    host = np.ascontiguousarray(np.asarray(pose, dtype=np.float32))
    if host.shape != (4, 4):
        raise ValueError(f"pose must be [4, 4], got {host.shape}")
    return None, host.ctypes.data, host


def depth_hits(
    depth: torch.Tensor,
    pose,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims,
    invalid_value: float = 0.0,
    z_index_offset: int = 0,
) -> torch.Tensor:
    """int32[dz*dy*dx]: the number of a depth frame's measurements in each
    voxel, `raycast.depth_hits` (S1 on CUDA: the memset and one launch).
    With `z_index_offset` z0 the grid is the z-slab [z0, z0 + dz) of a
    larger one, voxelized in the global frame. The pose may be on the host
    (it travels in the launch's arguments) or a float32 [4, 4] on the
    image's card."""
    if depth.device.type == "cpu":
        return depth_hits_plain(depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value, z_index_offset)
    kernels.check_input(depth, "depth", torch.float32, ("H", "W"), depth.device)
    dx, dy, dz = _checked_dims(dims, "depth-hits")
    z0 = _checked_z0(z_index_offset, dz)
    on_card, on_host, _host = _pose_pointers(pose, depth.device)  # _host lives past the call
    h, w = depth.shape
    out = torch.empty(dx * dy * dz, dtype=torch.int32, device=depth.device)
    kernels.launch("gv_depth_hits", depth.device, depth.data_ptr(), h, w, on_card, on_host, fx, fy, cx, cy,
                   invalid_value, float(np.float32(1.0 / float(side_length))), dx, dy, dz, z0, out.data_ptr())
    return out


def log_odds_update(data: torch.Tensor, hit_counts: torch.Tensor, free: torch.Tensor,
                    robot_occupied_mask=None) -> torch.Tensor:
    """int8[N]: the log-odds map `data` updated by a frame's hit counts and
    carve mask, `raycast.log_odds_update` byte for byte (S2 on CUDA, one
    launch); voxels of `robot_occupied_mask` (bool[N], or None) take no
    hits."""
    if data.device.type == "cpu":
        return log_odds_update_plain(data, hit_counts, free, robot_occupied_mask)
    n = data.numel()
    kernels.check_input(data, "data", torch.int8, (n,), data.device)
    kernels.check_input(hit_counts, "hit_counts", torch.int32, (n,), data.device)
    kernels.check_input(free, "free", torch.bool, (n,), data.device)
    robot = None
    if robot_occupied_mask is not None:
        kernels.check_input(robot_occupied_mask, "robot_occupied_mask", torch.bool, (n,), data.device)
        robot = robot_occupied_mask.data_ptr()
    out = torch.empty_like(data)
    kernels.launch("gv_log_odds_update", data.device, data.data_ptr(), hit_counts.data_ptr(), free.data_ptr(), robot,
                   out.data_ptr(), n)
    return out
