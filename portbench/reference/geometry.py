"""Robot forward kinematics and the voxels of its points.

The reference FK runs in float64 from the published DH table, the link
clouds and the joint values. The program's float32 FK differs from it by
ulps, and a voxel boundary can lie between the two (hazard H4: every UR10
state has points within 1e-3 voxel of a boundary, as the base link's
points lie on the 0.02 m grid). So a point closer than `BAND` voxels to a
boundary on some axis may lie in either cell on that axis: the reference
gives each state a set of sure voxels (points clear of every boundary) and
a set of candidate voxels (every cell each point may lie in). The
program's answer is held to that band: its robot voxels lie between the
two sets, its count of colliding voxels between the two sets' counts.

`emulated_tf32` and `fk_points_tf32` compute the same FK in float32 with
every matrix product's operands rounded to TF32 (10 mantissa bits, as the
tensor cores take them): the precision one step below the configuration's,
which the control runs.
"""
from __future__ import annotations

import numpy as np
import torch

# The program's float32 FK of this arm, and its float32 pose product of a
# depth point, lie within about 2e-5 voxel of float64 at 0.02 m (the card's
# readings, `python -m portbench.readings`); the control's TF32 lies
# hundreds of times farther. 1e-3 voxel keeps fifty times the first's room.
# A point this close to a boundary on some axis may lie in either cell on
# that axis.
BAND = 1e-3


def dh_matrices(robot: dict, values: torch.Tensor) -> torch.Tensor:
    """[T, 7, 4, 4]: per link, the product of the DH matrices of the links
    before it (a link's cloud moves with the joints before it; the first
    link's cloud does not move). `values` is [T, 7] joint values, tool0's
    last; the dtype and device are those of `values`."""
    d = list(robot["dh_d_m"]) + [0.0]
    a = list(robot["dh_a_m"]) + [0.0]
    alpha = list(robot["dh_alpha_rad"]) + [0.0]
    t = values.shape[0]
    acc = torch.eye(4, dtype=values.dtype, device=values.device).expand(t, 4, 4)
    out = []
    for i in range(7):
        out.append(acc)
        acc = acc @ _dh(d[i], a[i], alpha[i], values[:, i])
    return torch.stack(out, dim=1)


def _dh(d: float, a: float, alpha: float, theta: torch.Tensor) -> torch.Tensor:
    """The DH convention of KinematicLink::convertDHtoM (revolute, theta
    offset 0): Rz(theta) Tz(d) Tx(a) Rx(alpha)."""
    ct, st = torch.cos(theta), torch.sin(theta)
    ca, sa = np.cos(alpha), np.sin(alpha)
    z, o = torch.zeros_like(ct), torch.ones_like(ct)
    rows = [
        [ct, -st * ca, st * sa, a * ct],
        [st, ct * ca, -ct * sa, a * st],
        [z, z + sa, z + ca, z + d],
        [z, z, z, o],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def fk_points(robot: dict, clouds: list, base, values: np.ndarray, device) -> torch.Tensor:
    """float64 [T, P, 3] world points of every link cloud, links in order,
    for joint values [T, 7] (or [T, 6], tool0 then 0)."""
    v = _values(values, torch.float64, device)
    mats = dh_matrices(robot, v)
    base = torch.as_tensor(np.asarray(base, np.float32), dtype=torch.float64, device=device)
    parts = []
    for i, cloud in enumerate(clouds):
        p = torch.as_tensor(cloud, dtype=torch.float64, device=device)
        parts.append(torch.einsum("tij,pj->tpi", mats[:, i, :3, :3], p) + mats[:, i, None, :3, 3])
    return torch.cat(parts, dim=1) + base


def _values(values, dtype, device) -> torch.Tensor:
    v = torch.as_tensor(np.asarray(values, np.float32), dtype=dtype, device=device)
    v = v.reshape(-1, v.shape[-1])
    if v.shape[1] == 6:
        v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
    return v


def emulated_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest, ties away
    from zero (the tensor cores' conversion)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def fk_points_tf32(robot: dict, clouds: list, base, values: np.ndarray, device) -> torch.Tensor:
    """float32 [T, P, 3]: `fk_points` in float32 with every matrix
    product's operands rounded to TF32 and its sums kept in float32."""
    tf = emulated_tf32
    v = _values(values, torch.float32, device)
    d = list(robot["dh_d_m"]) + [0.0]
    a = list(robot["dh_a_m"]) + [0.0]
    alpha = list(robot["dh_alpha_rad"]) + [0.0]
    acc = torch.eye(4, dtype=torch.float32, device=device).expand(v.shape[0], 4, 4)
    base = torch.as_tensor(np.asarray(base, np.float32), device=device)
    parts = []
    for i, cloud in enumerate(clouds):
        p = torch.as_tensor(cloud, dtype=torch.float32, device=device)
        parts.append(torch.einsum("tij,pj->tpi", tf(acc[:, :3, :3]), tf(p)) + acc[:, None, :3, 3])
        acc = tf(acc) @ tf(_dh(d[i], a[i], alpha[i], v[:, i]).to(torch.float32))
    return torch.cat(parts, dim=1) + base


def voxel_band(points: torch.Tensor, side: float, dims, band: float = BAND):
    """(sure, cand): int64 linear voxel keys, -1 where none. sure [T, P] is
    the voxel of each point clear of every boundary by `band` voxels (-1
    for the others and for points outside the map); cand [T, P, 8] every
    cell each point may lie in, inside the map. A point exactly computed
    lies in floor(point / side) on each axis."""
    f = points.to(torch.float64) / side
    r = torch.round(f)
    near = (f - r).abs() < band
    fl = torch.floor(f)
    lo = torch.where(near, r - 1, fl).to(torch.int64)
    hi = torch.where(near, r, fl).to(torch.int64)
    dx, dy, dz = (int(v) for v in dims)
    x = torch.stack([lo[..., 0], hi[..., 0]], -1)[..., :, None, None]
    y = torch.stack([lo[..., 1], hi[..., 1]], -1)[..., None, :, None]
    z = torch.stack([lo[..., 2], hi[..., 2]], -1)[..., None, None, :]
    inside = (x >= 0) & (x < dx) & (y >= 0) & (y < dy) & (z >= 0) & (z < dz)
    cand = torch.where(inside, (z * dy + y) * dx + x, -1).reshape(*points.shape[:-1], 8)
    sure = torch.where(near.any(dim=-1), -1, cand[..., 0])
    return sure, cand


def distinct_hits(keys: torch.Tensor, occupied: torch.Tensor) -> torch.Tensor:
    """[T]: distinct keys >= 0 per row whose voxel is occupied (bool[N])."""
    keys = keys.reshape(keys.shape[0], -1)
    hit = (keys >= 0) & occupied[keys.clamp(min=0)]
    k, _ = torch.sort(torch.where(hit, keys, -1), dim=-1)
    first = torch.ones_like(k, dtype=torch.bool)
    first[:, 1:] = k[:, 1:] != k[:, :-1]
    return (first & (k >= 0)).sum(dim=-1)


def count_band(sure: torch.Tensor, cand: torch.Tensor, occupied: torch.Tensor, possibly=None):
    """(lo, hi) [T]: the fewest and the most distinct occupied voxels the
    robot can touch in each state. `occupied` holds the voxels surely
    occupied, `possibly` (where given) those that may be."""
    return distinct_hits(sure, occupied), distinct_hits(cand, occupied if possibly is None else possibly)
