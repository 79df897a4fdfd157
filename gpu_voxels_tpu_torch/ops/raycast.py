"""Depth-camera fusion: occupied hits plus projective free-space carving.

Counterpart of gpu_voxels_tpu/ops/raycast.py for the dense-map slice:
`projective_free_space` is the plain spec of the exact carve (CUDA kernel
K3 in ops/raycast_cuda.py), `projective_free_space_pooled` with
`min_pool_depth` the spec of the pooled carve (kernel K6; the reference
keeps both in gpu_voxels_tpu/ops/raycast_pallas.py:79-137),
`depth_image_to_point_cloud` the pinhole back-projection and
`insert_depth_image` the full frame update (ProbVoxelMap::insertSensorData
semantics with visibility carving), whose hits (`depth_hits`) and log-odds
update (`log_odds_update`) are the specs of kernels S1 and S2 in
ops/raycast_cuda.py.

`insert_sensor_data` is ProbVoxelMap::insertSensorData (ProbVoxelMap.hpp:52-102)
for sparse or arbitrary point sets, with the Bresenham RayCaster
(VoxelMapOperations.h:199-334) reformulated as in the reference: every ray
takes the same `max_steps` dominant-axis steps, masked past its own length,
each step one scatter-add of ray-crossing counts (`ray_crossing_counts`).
The loop runs on the device without a host read.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import probability
from ..constants import SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED
from ..geometry import transforms
from ..utils import perfmon, to_device
from .insert import floor_to_int32, in_map, linear_index, map_to_voxels, shifted

Dims = Tuple[int, int, int]
F32 = torch.float32


def _project(dev, pose, fx, fy, cx, cy, side_length: float, dims: Dims, h: int, w: int, z_index_offset: int = 0):
    """Per voxel of a [Z, Y, X] grid, its centre's camera-frame depth sz,
    its pixel (u, v) and whether it lies in front and inside the h x w
    image: the carves' shared projection (csrc/carve_projection.cuh).
    Voxel z index k of the grid is global index k + z_index_offset, added
    as an integer and then converted to f32 (exact below 2^24)."""
    pose = to_device(pose, F32, dev)
    rot_t = pose[:3, :3].T
    origin = pose[:3, 3]

    dx, dy, dz = dims
    side = float(np.float32(side_length))
    zi = (torch.arange(dz, dtype=torch.int32, device=dev) + int(z_index_offset)).to(F32).view(dz, 1, 1)
    yi = torch.arange(dy, dtype=F32, device=dev).view(1, dy, 1)
    xi = torch.arange(dx, dtype=F32, device=dev).view(1, 1, dx)
    wx = (xi + 0.5) * side - origin[0]
    wy = (yi + 0.5) * side - origin[1]
    wz = (zi + 0.5) * side - origin[2]
    sx = rot_t[0, 0] * wx + rot_t[0, 1] * wy + rot_t[0, 2] * wz
    sy = rot_t[1, 0] * wx + rot_t[1, 1] * wy + rot_t[1, 2] * wz
    sz = rot_t[2, 0] * wx + rot_t[2, 1] * wy + rot_t[2, 2] * wz

    in_front = sz > 1e-6
    safe_z = torch.where(in_front, sz, 1.0)
    u = floor_to_int32(fx * sx / safe_z + cx)  # the kernel's floor_to_int
    v = floor_to_int32(fy * sy / safe_z + cy)
    return sz, u, v, in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)


def projective_free_space(
    depth: torch.Tensor,
    pose: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims: Dims,
    invalid_value: float = 0.0,
    eps_vox: float = 1.0,
    z_index_offset: int = 0,
) -> torch.Tensor:
    """bool[N]: voxels observed free by a depth camera (visibility carving).

    A voxel is free iff its centre projects inside the image, lies in front
    of the camera (sz > 1e-6), its pixel is valid, and it sits at least
    eps_vox voxels closer than the measurement: sz < d - eps_vox * side.
    Every f32 operation is one torch op, rounded on its own, in the order of
    the reference expression (gpu_voxels_tpu/ops/raycast.py:109-139).

    `z_index_offset` carves a z-slab of a larger grid in the global frame:
    the grid's z index k is global index k + z_index_offset, and the pose is
    the global one (a slab never translates the pose: see
    parallel/sharded.py).
    """
    h, w = depth.shape
    sz, u, v, in_fov = _project(depth.device, pose, fx, fy, cx, cy, side_length, dims, h, w, z_index_offset)
    ui = u.clamp(0, w - 1).to(torch.int64)
    vi = v.clamp(0, h - 1).to(torch.int64)
    d = depth.reshape(-1)[vi * w + ui]
    valid = d != invalid_value
    eps = float(np.float32(eps_vox) * np.float32(side_length))
    free = in_fov & valid & (sz < d - eps)
    return free.reshape(-1)


_NEG_INF = -3.0e38  # an invalid pixel's pooled depth: it carves nothing


def min_pool_depth(depth: torch.Tensor, pool: int, invalid_value: float = 0.0) -> torch.Tensor:
    """Conservative PxP min-pool of a depth image: invalid pixels -> -3e38
    (carve nothing); edge tiles are padded with +3e38, min-neutral, since
    out-of-image pixels are never indexed."""
    h, w = depth.shape
    d = torch.where(depth == invalid_value, _NEG_INF, depth)
    ph, pw = -(-h // pool), -(-w // pool)
    if ph * pool != h or pw * pool != w:
        d = torch.nn.functional.pad(d, (0, pw * pool - w, 0, ph * pool - h), value=3.0e38)
    return d.reshape(ph, pool, pw, pool).amin(dim=(1, 3))


def projective_free_space_pooled(
    depth: torch.Tensor,
    pose: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims: Dims,
    invalid_value: float = 0.0,
    eps_vox: float = 1.0,
    pool: int = 4,
    z_index_offset: int = 0,
) -> torch.Tensor:
    """bool[N]: the pooled conservative carve (gpu_voxels_tpu/ops/
    raycast_pallas.py:97-137): free iff the voxel's centre lies in front,
    projects inside the image and sz < pooled_min[v // P, u // P] - eps.
    Never frees a voxel the exact carve keeps; P = 1 is the exact carve.
    The projection is `projective_free_space`'s, op for op, and takes its
    `z_index_offset` the same way."""
    pm = min_pool_depth(depth, pool, invalid_value)
    return carve_against_pooled(pm, pool, depth.shape, pose, fx, fy, cx, cy, side_length, dims, eps_vox,
                                z_index_offset)


def carve_against_pooled(
    pm: torch.Tensor,
    pool: int,
    image_shape: Tuple[int, int],
    pose: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims: Dims,
    eps_vox: float = 1.0,
    z_index_offset: int = 0,
) -> torch.Tensor:
    """bool[N]: `projective_free_space_pooled` against its prebuilt table
    pm = min_pool_depth(depth, pool, invalid_value) of an image of
    `image_shape` (h, w)."""
    h, w = image_shape
    sz, u, v, in_fov = _project(pm.device, pose, fx, fy, cx, cy, side_length, dims, h, w, z_index_offset)
    ui = torch.div(u, pool, rounding_mode="floor").clamp(0, pm.shape[1] - 1).to(torch.int64)
    vi = torch.div(v, pool, rounding_mode="floor").clamp(0, pm.shape[0] - 1).to(torch.int64)
    d = pm.reshape(-1)[vi * pm.shape[1] + ui]
    eps = float(np.float32(eps_vox) * np.float32(side_length))
    return (in_fov & (sz < d - eps)).reshape(-1)


def depth_image_to_point_cloud(depth: torch.Tensor, fx, fy, cx, cy, invalid_value=0.0) -> torch.Tensor:
    """Pinhole back-projection: depth image -> sensor-frame points [H*W, 3].

    Invalid measurements become NaN points, dropped by insert_depth_image.
    """
    depth = torch.as_tensor(depth, dtype=F32)
    h, w = depth.shape
    u = torch.arange(w, dtype=F32, device=depth.device)[None, :]
    v = torch.arange(h, dtype=F32, device=depth.device)[:, None]
    z = depth
    x = (u - cx) * z / fx
    y = (v - cy) * z / fy
    pts = torch.stack([x, y, z * torch.ones_like(x)], dim=-1).reshape(-1, 3)
    valid = (depth != invalid_value).reshape(-1)
    return torch.where(valid[:, None], pts, torch.nan)


def carve(depth: torch.Tensor, pose: torch.Tensor, fx: float, fy: float, cx: float, cy: float, side_length: float,
          dims: Dims, invalid_value: float = 0.0, carve_pool: int = 1, z_index_offset: int = 0,
          pooled_depth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bool[N]: the depth insert's free-space carve of the (slab of the)
    grid: carve_pool = 1 the exact carve (`raycast_cuda.projective_free_space_exact`,
    kernel K3), P > 1 the P x P pooled carve (`raycast_cuda.projective_free_space_pooled`,
    kernel K6), against `pooled_depth` when the frame's table is prebuilt.
    Each takes its plain spec on CPU tensors."""
    from . import raycast_cuda

    if carve_pool > 1 and pooled_depth is not None:
        return raycast_cuda.carve_against_pooled(pooled_depth, carve_pool, depth.shape, pose, fx, fy, cx, cy,
                                                 side_length, dims, z_index_offset=z_index_offset)
    if carve_pool > 1:
        return raycast_cuda.projective_free_space_pooled(depth, pose, fx, fy, cx, cy, side_length, dims,
                                                         invalid_value, pool=carve_pool,
                                                         z_index_offset=z_index_offset)
    return raycast_cuda.projective_free_space_exact(depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value,
                                                    z_index_offset=z_index_offset)


def insert_depth_image(
    data: torch.Tensor,
    depth: torch.Tensor,
    pose: torch.Tensor,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    side_length: float,
    dims: Dims,
    invalid_value: float = 0.0,
    cut_real_robot: bool = False,
    robot_occupied_mask=None,
    carve_pool: int = 1,
    z_index_offset: int = 0,
    pooled_depth: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full projective sensor update of an int8 log-odds map: every
    measurement adds SENSOR_MODEL_OCCUPIED (+72) to its voxel, and every voxel
    carved free (and not hit) adds SENSOR_MODEL_FREE (-10), clamped.

    carve_pool = 1 carves exactly per pixel (`raycast_cuda.projective_free_space_exact`,
    kernel K3); carve_pool = P > 1 carves against the PxP min-pooled image
    (`raycast_cuda.projective_free_space_pooled`, kernel K6): conservative,
    it never frees a voxel the exact carve keeps. The hits and the update
    are one launch each (`raycast_cuda.depth_hits`, `raycast_cuda.log_odds_update`).
    Each takes its plain spec on CPU tensors.

    With `z_index_offset` z0, `data` is the z-slab [z0, z0 + dims[2]) of a
    larger grid: hits are voxelized in the global frame and shifted by z0
    as integers, and either carve takes the same offset. `pooled_depth`,
    the frame's min_pool_depth table at `carve_pool` built once for every
    slab of a frame, spares the pool.
    """
    from . import raycast_cuda

    with perfmon.span("sense.upload"):
        depth = to_device(depth, F32, data.device)
        pose_on_device = to_device(pose, F32, data.device)
    with perfmon.span("sense.hits"):
        # a host pose travels in the hits kernel's arguments; the carve reads the device copy
        hit_counts = raycast_cuda.depth_hits(depth, pose, fx, fy, cx, cy, side_length, dims, invalid_value,
                                             z_index_offset)
    with perfmon.span("sense.carve"):
        free = carve(depth, pose_on_device, fx, fy, cx, cy, side_length, dims, invalid_value, carve_pool,
                     z_index_offset, pooled_depth)
    with perfmon.span("sense.update"):
        robot = robot_occupied_mask if cut_real_robot else None
        return raycast_cuda.log_odds_update(data, hit_counts, free, robot)


def depth_hits(depth: torch.Tensor, pose, fx: float, fy: float, cx: float, cy: float, side_length: float,
               dims: Dims, invalid_value: float = 0.0, z_index_offset: int = 0) -> torch.Tensor:
    """int32[N]: the number of a depth frame's measurements in each voxel
    (the hits of `insert_depth_image`; the spec of
    `raycast_cuda.depth_hits`). With `z_index_offset` z0 the grid is the
    z-slab [z0, z0 + dims[2]) of a larger one: hits are voxelized in the
    global frame and shifted by z0 as integers."""
    pts = depth_image_to_point_cloud(depth, fx, fy, cx, cy, invalid_value)
    world = transforms.transform_points(pose, pts)
    n = dims[0] * dims[1] * dims[2]
    finite = torch.all(torch.isfinite(world), dim=-1)
    coords = map_to_voxels(torch.where(finite[:, None], world, -1.0), side_length)
    if z_index_offset:
        coords = shifted(coords, (0, 0, z_index_offset), -1)
    inside = finite & in_map(coords, dims)
    idx = torch.where(inside, linear_index(coords, dims), n)
    hit_counts = torch.zeros(n + 1, dtype=torch.int32, device=depth.device)
    return hit_counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:n]


def log_odds_update(data: torch.Tensor, hit_counts: torch.Tensor, free: torch.Tensor,
                    robot_occupied_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8[N]: `insert_depth_image`'s update of a log-odds map by a frame's
    hit counts and carve mask (the spec of `raycast_cuda.log_odds_update`):
    +72 a hit and -10 where carved free and not hit, clamped; voxels of the
    robot mask (cut_real_robot) take no hits."""
    if robot_occupied_mask is not None:
        hit_counts = torch.where(robot_occupied_mask, 0, hit_counts)
    carved = (free & (hit_counts == 0)).to(torch.int32)
    delta = hit_counts * SENSOR_MODEL_OCCUPIED + carved * SENSOR_MODEL_FREE
    return torch.where(delta != 0, probability.update_occupancy(data, delta), data)


def ray_crossing_counts(origin, points: torch.Tensor, side_length: float, dims: Dims,
                        max_steps: int = 256) -> torch.Tensor:
    """int32[N]: per-voxel count of rays origin -> point crossing it.

    Steps are sized so the dominant axis advances one voxel per step
    (Bresenham's visiting rule); the hit voxel itself is excluded, like the
    reference, which stops the ray one cell before the measurement. Step
    k = 0 samples the sensor's own voxel.

    Every f32 operation is one torch op in the reference's order
    (gpu_voxels_tpu/ops/raycast.py:49-65): `start_v + step_vec * k` rounds
    the product and the sum on their own (a fused multiply-add can move a
    sample across a cell boundary). The voxel index goes through
    `floor_to_int32`, and every scatter has N + 1 slots, slot N taking the
    samples that are past their ray's end or outside the map.
    """
    n = dims[0] * dims[1] * dims[2]
    points = to_device(points, F32)
    counts = torch.zeros(n + 1, dtype=torch.int32, device=points.device)
    ones = torch.ones(points.shape[0], dtype=torch.int32, device=points.device)
    for coords, alive in _ray_samples(origin, points, side_length, max_steps):
        live = alive & in_map(coords, dims)
        counts.index_add_(0, torch.where(live, linear_index(coords, dims), n), ones)
    return counts[:n]


def _ray_samples(origin, points: torch.Tensor, side_length: float, max_steps: int):
    """The rays' samples step by step, k = 0 .. max_steps - 1: (int32 voxel
    coords [M, 3] of sample k of every ray, bool[M] whether the ray is
    still short of its end), with ray_crossing_counts' roundings."""
    dev = points.device
    origin = to_device(origin, F32, dev)
    # the host-computed reciprocal of insert.map_to_voxels, so that ray
    # endpoints land in exactly the voxel the hit insert writes
    recip = float(np.float32(1.0 / float(side_length)))

    start_v = origin * recip
    end_v = points * recip
    delta = end_v - start_v[None, :]
    dominant = delta.abs().amax(dim=-1)  # in voxel units
    n_steps = floor_to_int32(torch.ceil(dominant))  # cells to visit per ray
    inv = torch.where(n_steps > 0, 1.0 / n_steps.to(F32).clamp(min=1.0), 0.0)
    step_vec = delta * inv[:, None]  # one dominant-axis voxel per step
    for k in range(int(max_steps)):
        pos = start_v + step_vec * float(k)
        yield floor_to_int32(pos), n_steps > k


_SPARE = 4096  # a slab's slots for the samples it drops


def ray_crossing_counts_slabs(origin, points: torch.Tensor, side_length: float, dims: Dims, devices,
                              max_steps: int = 256) -> list:
    """ray_crossing_counts of a grid cut into len(devices) equal z-slabs:
    int32[slab voxels] per slab, on its device, each equal to its piece of
    the whole grid's counts. The rays are walked once: every step's global
    indices go to the slab that owns them, one scatter-add per slab. A slab
    drops most of a step's samples (those of the other slabs); ray r drops
    its into spare slot r % _SPARE, so the drops do not all add to one
    address."""
    n = dims[0] * dims[1] * dims[2]
    s = n // len(devices)
    points = to_device(points, F32)
    counts = [torch.zeros(s + _SPARE, dtype=torch.int32, device=d) for d in devices]
    ones = [torch.ones(points.shape[0], dtype=torch.int32, device=d) for d in devices]
    spare = s + torch.arange(points.shape[0], device=points.device) % _SPARE
    for coords, alive in _ray_samples(origin, points, side_length, max_steps):
        live = alive & in_map(coords, dims)
        idx = torch.where(live, linear_index(coords, dims), n)
        slab = idx // s  # len(devices) past the map: no slab's
        local = idx - slab * s
        for k, (c, o, d) in enumerate(zip(counts, ones, devices)):
            c.index_add_(0, torch.where(slab == k, local, spare).to(d), o)
    return [c[:s] for c in counts]


def insert_sensor_data(
    data: torch.Tensor,
    sensor_origin,
    points: torch.Tensor,
    side_length: float,
    dims: Dims,
    enable_raycasting: bool = True,
    cut_real_robot: bool = False,
    robot_occupied_mask: Optional[torch.Tensor] = None,
    max_steps: int = 256,
    z_index_offset: int = 0,
    free_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ProbVoxelMap::insertSensorData on a flat int8 log-odds grid.

    `points` are world-frame measurement endpoints (already transformed by
    the sensor pose, cf. transformSensorData TemplateVoxelMap.hpp:894).
    Every measurement adds SENSOR_MODEL_OCCUPIED (+72) to its voxel
    (several in one cell accumulate); with raycasting every ray adds
    SENSOR_MODEL_FREE (-10) to each cell it crosses, with the reference's
    multiplicity. NaN endpoints hit nothing. With `cut_real_robot`, hits
    inside `robot_occupied_mask` are skipped: the robot is no obstacle.

    With `z_index_offset` z0, `data` is the z-slab [z0, z0 + dims[2]) of a
    larger grid: hits are voxelized in the global frame and shifted by z0
    as integers, and `free_counts` must bring the slab's ray counts
    (ray_crossing_counts_slabs).
    """
    n = dims[0] * dims[1] * dims[2]
    points = to_device(points, F32, data.device)
    finite = torch.all(torch.isfinite(points), dim=-1)
    coords = map_to_voxels(torch.where(finite[:, None], points, -1.0), side_length)
    if z_index_offset:
        coords = shifted(coords, (0, 0, z_index_offset), -1)
    inside = finite & in_map(coords, dims)
    idx = torch.where(inside, linear_index(coords, dims), n)

    hit_counts = torch.zeros(n + 1, dtype=torch.int32, device=data.device)
    hit_counts = hit_counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))[:n]
    if cut_real_robot and robot_occupied_mask is not None:
        hit_counts = torch.where(robot_occupied_mask, 0, hit_counts)

    delta = hit_counts * SENSOR_MODEL_OCCUPIED
    if enable_raycasting:
        if free_counts is None:
            if z_index_offset:
                raise ValueError("a slab's ray counts come from ray_crossing_counts_slabs (free_counts)")
            free_counts = ray_crossing_counts(sensor_origin, points, side_length, dims, max_steps)
        delta = delta + free_counts * SENSOR_MODEL_FREE

    # only touched voxels update: the clamp floor (-127) must not lift
    # untouched UNKNOWN (-128) voxels
    return torch.where(delta != 0, probability.update_occupancy(data, delta), data)
