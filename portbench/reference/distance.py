"""The exact squared Euclidean distance transform of a voxel grid, and the
band of a robot's clearance, in plain torch.

`squared_edt` is the transform over the whole grid: three brute-force
min-plus passes in int64, along z, then y, then x,

    g'[.., i, ..] = min_q ((i - q)^2 + g[.., q, ..])

each over every pair of positions of a line, in blocks of lines. It is an
integer transform, exact: the squared distance in voxels from each voxel to
its nearest obstacle voxel, `MAX` (the program's "no obstacle", 2^31 - 1)
where the grid holds none. `squared_edt_at` gives the same numbers at some
voxels only, by brute force over every obstacle voxel (in float64, exact
for these integers: every sum stays below 2^53).

`clearance_band` follows hazard H4's method (geometry.py): the program's
float32 FK may put a point near a voxel boundary in either cell, and its
obstacles may be any set between the sure ones and the candidate ones that
`sensing.fuse_band` gives. So its clearance, the least distance from a
robot point's voxel to an obstacle, lies between

    lower: the least EDT of the candidate obstacles over every candidate
           voxel of every point;
    upper: the least, over points, of the largest EDT of the sure
           obstacles over that point's candidate voxels (`MAX` for a cell
           outside the map, which the program reads as no obstacle).

Both bounds are turned into metres as the program turns its squared
distance into metres, sqrt in float32 times the side: a function that
never decreases, so the program's answer lies between them exactly.
"""
from __future__ import annotations

import torch

MAX = 2**31 - 1
_FAR = 2**40  # a line's "no obstacle yet", above any sum of three squared coordinates below 1024


def squared_edt(obstacles: torch.Tensor, dims, dtype: torch.dtype = torch.int64,
                block: int = 2**26) -> torch.Tensor:
    """int64 [dz, dy, dx]: the squared distance of each voxel to the nearest
    voxel of `obstacles` (bool, [N] or [dz, dy, dx]), MAX where there is
    none. `dtype` holds the distances between the passes (the control holds
    them in bfloat16); `block` bounds the elements of one block's sums."""
    dx, dy, dz = (int(d) for d in dims)
    g = torch.where(obstacles.reshape(dz, dy, dx), 0, _FAR).to(dtype)
    for axis in (0, 1, 2):  # z, y, x
        g = _min_plus(g, axis, block)
    return torch.where(g >= _FAR, MAX, g.to(torch.int64))


def _min_plus(g: torch.Tensor, axis: int, block: int) -> torch.Tensor:
    """One pass: min over q of (i - q)^2 + g at q, along `axis`."""
    n = g.shape[axis]
    lines = g.movedim(axis, -1)
    shape = lines.shape
    lines = lines.reshape(-1, n)
    i = torch.arange(n, device=g.device)
    d = ((i[:, None] - i[None, :]) ** 2).to(g.dtype)  # [i, q]
    out = torch.empty_like(lines)
    step = max(block // (n * n), 1)
    for s in range(0, lines.shape[0], step):
        out[s:s + step] = (lines[s:s + step, None, :] + d).amin(-1)
    return out.reshape(shape).movedim(-1, axis)


def _coords(keys: torch.Tensor, dims) -> torch.Tensor:
    dx, dy = int(dims[0]), int(dims[1])
    return torch.stack([keys % dx, (keys // dx) % dy, keys // (dx * dy)], -1).to(torch.float64)


def squared_edt_at(obstacles: torch.Tensor, keys: torch.Tensor, dims, block: int = 2**27) -> torch.Tensor:
    """int64 [K]: `squared_edt(obstacles)` at the voxels `keys` (int64
    linear keys inside the map) only, by brute force over every obstacle."""
    obs = torch.nonzero(obstacles.reshape(-1)).reshape(-1)
    if obs.numel() == 0 or keys.numel() == 0:
        return torch.full(keys.shape, MAX, dtype=torch.int64, device=keys.device)
    a, b = _coords(keys, dims), _coords(obs, dims)
    b2 = (b * b).sum(-1)
    best = torch.full(keys.shape, float("inf"), dtype=torch.float64, device=keys.device)
    step = max(block // keys.numel(), 1)
    for s in range(0, obs.numel(), step):  # |b|^2 - 2 a.b, then |a|^2 once
        best = torch.minimum(best, torch.addmm(b2[None, s:s + step], a, b[s:s + step].T, alpha=-2).amin(1))
    return (best + (a * a).sum(-1)).round().to(torch.int64)


def metres(d2: torch.Tensor, side: float) -> torch.Tensor:
    """float32: a squared distance in voxels as a distance in metres."""
    return torch.sqrt(d2.to(torch.float32)) * side


def clearance_band(sure_obstacles: torch.Tensor, cand_obstacles: torch.Tensor, cand: torch.Tensor, side: float,
                   dims):
    """(lower, upper) float32 0-d: the band of the clearance of points whose
    candidate voxels are `cand` ([P, 8] int64 keys, -1 outside the map, as
    geometry.voxel_band gives them), between obstacle sets `sure_obstacles`
    and `cand_obstacles` (bool [N])."""
    keys = torch.unique(cand[cand >= 0])
    near = squared_edt_at(cand_obstacles, keys, dims)
    far = near if torch.equal(sure_obstacles, cand_obstacles) else squared_edt_at(sure_obstacles, keys, dims)
    lower = near.min() if keys.numel() else torch.tensor(MAX, device=cand.device)
    at = far[torch.searchsorted(keys, cand.clamp(min=0))] if keys.numel() else torch.zeros_like(cand)
    upper = torch.where(cand >= 0, at, MAX).amax(-1).min()
    return metres(lower, side), metres(upper, side)
