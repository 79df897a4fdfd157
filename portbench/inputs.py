"""Every input of a run, made from the seed: depth frames (rendered on the
card), the UR10's link clouds, joint trajectories, workcell box points and
random joint states. The port and the reference are handed the same arrays.

Frozen copies (later edits of their originals do not move the yardstick):
the cylinder sampler of `gpu_voxels_tpu_torch/robot/presets.py:53-91`
(`_cylinder`, `_segment_cloud`) and the link layout of `ur_robot`
(presets.py:94-122).
"""
from __future__ import annotations

import numpy as np

import torch

from .reference import sensing
from .reference.workcell import box_voxels

# stream ids of np.random.default_rng((seed, stream)): one per kind of input
_FRAMES, _TRAJECTORY, _SOLVES, _STATES = 1, 2, 3, 4


def rng(seed: int, stream: int, *more: int) -> np.random.Generator:
    """The generator of one kind of input; any whole seed, negative ones too."""
    return np.random.default_rng((int(seed) % 2**64, stream, *more))


# -- the UR10's link clouds ----------------------------------------------------
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
    """The body made by the previous joint's DH translation, in this link's frame."""
    parts = []
    if abs(a_prev) > 1e-6:
        parts.append(_cylinder(0, 0.0, -a_prev, radius, spacing))
    if abs(d_prev) > 1e-6:
        parts.append(_cylinder(2, 0.0, -d_prev, radius, spacing))
    if not parts:
        parts.append(_cylinder(2, -radius, radius, radius, spacing))
    return np.concatenate(parts, axis=0)


def link_clouds(robot: dict) -> list[np.ndarray]:
    """float32 [P_i, 3] per link: the six joints' links, then tool0's."""
    d, a, radius, spacing = robot["dh_d_m"], robot["dh_a_m"], robot["link_radius_m"], robot["cloud_spacing_m"]
    clouds = [_segment_cloud(a[i - 1] if i else 0.0, d[i - 1] if i else 0.0, radius, spacing) for i in range(6)]
    clouds.append(_segment_cloud(a[5], d[5], radius, spacing))
    return clouds


def link_names(robot: dict) -> list[str]:
    return list(robot["joints"]) + ["tool0"]


# -- depth frames ----------------------------------------------------------------
def depth_frames(cfg: dict, scene: dict, count: int, seed: int, device) -> list[np.ndarray]:
    """`count` float32 [h, w] frames of the workcell as the configuration's
    camera sees it, rendered on `device`: the depth along the camera's z
    axis of the nearest of the configuration's boxes and its moving box,
    which slides along `moving_box.axis` by `m_per_frame` a frame and back
    within `range_m`, from a start drawn from the seed; the Kinect's axial
    noise, drawn from the seed; 0 (invalid) where no surface lies within
    the sensor's range. Pixel (u, v) looks along ((u - cx) / fx,
    (v - cy) / fy, 1), as the back-projection reads it."""
    s, mb, nz = cfg["sensor"], scene["moving_box"], scene["noise"]
    dev, f64 = torch.device(device), torch.float64
    h, w = s["height"], s["width"]
    m = torch.as_tensor(sensing.pose(s), dtype=f64, device=dev)
    u = torch.arange(w, dtype=f64, device=dev)[None, :].expand(h, w)
    v = torch.arange(h, dtype=f64, device=dev)[:, None].expand(h, w)
    ray = torch.stack([(u - s["cx"]) / s["fx"], (v - s["cy"]) / s["fy"], torch.ones_like(u)], -1).reshape(-1, 3)
    ray, origin = ray @ m[:3, :3].T, m[:3, 3]
    static = torch.stack([_box_depth(origin, ray, lo, hi) for lo, hi in cfg["boxes_m"]]).amin(0)
    g = rng(seed, _FRAMES)
    axis, (r0, r1) = mb["axis"], mb["range_m"]
    box = np.asarray(cfg["moving_box_m"], np.float64)
    size = box[1, axis] - box[0, axis]
    travel = r1 - r0 - size
    start = g.uniform(0.0, 2.0 * travel)
    noise = torch.Generator(device=dev)
    noise.manual_seed(int(g.integers(0, 2**62)))
    near, far = s["range_m"]
    frames = []
    for i in range(count):
        p = (start + i * mb["m_per_frame"]) % (2.0 * travel)
        lo, hi = box.copy()
        lo[axis] = hi[axis] = r0 + (p if p <= travel else 2.0 * travel - p)
        hi[axis] += size
        z = torch.minimum(static, _box_depth(origin, ray, lo, hi))
        sigma = nz["sigma_m"] + nz["quadratic_m"] * (z - nz["z0_m"]) ** 2
        z = z + sigma * torch.randn(z.shape, generator=noise, dtype=f64, device=dev)
        z = torch.where(torch.isfinite(z) & (z >= near) & (z <= far), z, 0.0)
        frames.append(z.reshape(h, w).to(torch.float32).cpu().numpy())
    return frames


def _box_depth(origin: torch.Tensor, ray: torch.Tensor, lo, hi) -> torch.Tensor:
    """float64 [P]: where each ray origin + t * ray first meets the box
    [lo, hi] in front of the origin, t; inf where it misses (slab test)."""
    lo, hi = (torch.as_tensor(np.asarray(b, np.float64), device=ray.device) for b in (lo, hi))
    inv = 1.0 / ray
    t1, t2 = (lo - origin) * inv, (hi - origin) * inv
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return torch.where((far >= near) & (near > 0), near, torch.inf)


# -- joint states ------------------------------------------------------------------
def trajectory(spec: dict, seed: int) -> np.ndarray:
    """float32 [states, 7]: a closed loop through `waypoints` joint states
    drawn from the ranges, interpolated linearly, tool0 at 0."""
    g = rng(seed, _TRAJECTORY)
    lo, hi = np.asarray(spec["joint_ranges_rad"], np.float64).T
    way = g.uniform(lo, hi, size=(spec["waypoints"], 6))
    n, k = spec["states"], spec["waypoints"]
    t = np.arange(n) * k / n
    i = np.floor(t).astype(int)
    f = (t - i)[:, None]
    states = way[i] * (1 - f) + way[(i + 1) % k] * f
    return np.concatenate([states, np.zeros((n, 1))], axis=1).astype(np.float32)


def solve_seeds(seed: int, count: int) -> list[int]:
    return [int(s) for s in rng(seed, _SOLVES).integers(0, 2**31 - 1, size=count)]


def uniform_states(cfg: dict, count: int, seed: int, offset: int = 0) -> np.ndarray:
    """float32 [count, 6] states uniform in the joint bounds; batch
    `offset` of the seed's stream (every batch its own generator, so a
    sample of batches is made again without the rest)."""
    g = rng(seed, _STATES, int(offset))
    return g.uniform(cfg["joint_lower_rad"], cfg["joint_upper_rad"], size=(count, 6)).astype(np.float32)


# -- the workcell ----------------------------------------------------------------
def box_points(cfg: dict) -> np.ndarray:
    """float32 [n, 3]: the centre of every box voxel."""
    side = cfg["map"]["side_m"]
    pts = []
    for (x0, x1), (y0, y1), (z0, z1) in box_voxels(cfg):
        g = np.stack(np.meshgrid(np.arange(x0, x1), np.arange(y0, y1), np.arange(z0, z1), indexing="ij"), -1)
        pts.append(((g.reshape(-1, 3) + 0.5) * side).astype(np.float32))
    return np.concatenate(pts)
