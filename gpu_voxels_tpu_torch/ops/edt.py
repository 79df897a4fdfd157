"""Euclidean distance transforms on dense voxel grids.

Counterpart of gpu_voxels_tpu/ops/edt.py (DistanceVoxelMap's algorithms,
voxelmap/DistanceVoxelMap.{h,hpp}):

  * exact_distances: brute force against an explicit obstacle list, the
    oracle (kernelExactDistances3D), chunked over 4096 voxels like the
    reference's lax.map.
  * jump_flood: 3D JFA over the packed grid, log2(maxdim) rounds of
    26-neighbour min-merges plus step-1 refinements and a fixpoint repair;
    jump_flood_multires runs the long rounds on a 1/c^3 grid first.
  * exact_separable: the PBA math as Z scans plus Meijster's all-integer
    lower envelope along Y and X (the same algorithm and tie rule as the
    reference, so payloads compare, not only distances).
  * manhattan_distance: the exact separable L1 transform.

Grids hold DistanceVoxel-packed coordinates x | y<<10 | z<<20, with
1023 per field for "uninitialised" (DistanceVoxel.hpp:31-101). The
reference stores them as uint32; packed values never set bit 31
(PBA_UNINITIALISED_PACKED = 2^30 - 1), so here they are int32 tensors with
the same value. Distances to uninitialised voxels are MAX_OBSTACLE_DISTANCE.

Scans are torch's scan primitives (cummax / cummin). The loops that stay
in Python are the reference's own sequential loops: JFA rounds, the
fixpoint repair (which reads a changed-flag each round, as the reference's
while_loop does on its device) and Meijster's scan over positions.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..constants import MAX_OBSTACLE_DISTANCE, PBA_UNINITIALISED_COORD, PBA_UNINITIALISED_PACKED
from . import insert as insert_ops

Dims = Tuple[int, int, int]
I32 = torch.int32

# The JFAs' policy, shared by the single-device calls and their slab form
# (parallel/sharded_edt.jump_flood_slabs): the multires coarse factor, its
# short-range fine rounds, and the cap on the step-1 repair's rounds (the
# reference's, gpu_voxels_tpu/ops/edt.py:189-203).
MULTIRES_COARSE_FACTOR = 4
MULTIRES_FINE_STEPS = (8, 4, 2, 1, 1, 1)
REPAIR_MAX_ROUNDS = 64


def pack(x, y, z) -> torch.Tensor:
    """Packed int32 coordinates x | y<<10 | z<<20 (each field < 1024)."""
    x, y, z = (torch.as_tensor(v).to(I32) for v in (x, y, z))
    return x | (y << 10) | (z << 20)


def unpack(packed) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    p = torch.as_tensor(packed).to(I32)
    return p & 0x3FF, (p >> 10) & 0x3FF, p >> 20


def _position_grids(dims: Dims, device, z_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x, y, z index grids of a [Z, Y, X] grid as broadcasting int32 views;
    with `z_offset` z0 the grid is the z-slab [z0, z0 + Z) of a larger one
    and z holds global rows."""
    dx, dy, dz = dims
    x = torch.arange(dx, dtype=I32, device=device).view(1, 1, dx)
    y = torch.arange(dy, dtype=I32, device=device).view(1, dy, 1)
    z = torch.arange(int(z_offset), int(z_offset) + dz, dtype=I32, device=device).view(dz, 1, 1)
    return x, y, z


def _uninit(cx, cy, cz) -> torch.Tensor:
    """Any coordinate == 1023 marks uninitialised, as in the reference
    (DistanceVoxel.hpp:39-54; a 1024-wide grid loses coordinate 1023)."""
    u = PBA_UNINITIALISED_COORD
    return (cx == u) | (cy == u) | (cz == u)


def _sq_dist(cand: torch.Tensor, px, py, pz) -> torch.Tensor:
    """Squared distance from positions (px, py, pz) to the packed sites
    `cand`; MAX_OBSTACLE_DISTANCE where the site is uninitialised."""
    cx, cy, cz = unpack(cand)
    ddx, ddy, ddz = px - cx, py - cy, pz - cz
    d = ddx * ddx + ddy * ddy + ddz * ddz
    return torch.where(_uninit(cx, cy, cz), MAX_OBSTACLE_DISTANCE, d)


def squared_distance_grid(packed_grid: torch.Tensor, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """int32[Z, Y, X]: squared distance to the stored obstacle; uninitialised
    voxels give MAX_OBSTACLE_DISTANCE (DistanceVoxel::squaredObstacleDistance).
    With `z_offset` z0 the grid is the z-slab [z0, z0 + Z) of a larger one."""
    dx, dy, dz = dims
    px, py, pz = _position_grids(dims, packed_grid.device, z_offset)
    return _sq_dist(packed_grid.reshape(dz, dy, dx), px, py, pz)


def squared_distance_at(packed_flat: torch.Tensor, idx: torch.Tensor, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """Squared obstacle distances of the voxels with linear indices `idx`
    (int64, each < N): squared_distance_grid at those voxels only. A gather
    (`take`), so a 0-d index on the card is not read on the host. With
    `z_offset` z0 the grid is the z-slab [z0, z0 + Z) of a larger one."""
    dx, dy, _ = dims
    return _sq_dist(torch.take(packed_flat, idx), (idx % dx).to(I32), ((idx // dx) % dy).to(I32),
                    (idx // (dx * dy) + int(z_offset)).to(I32))


def init_from_obstacle_mask(mask_flat: torch.Tensor, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """int32[N]: obstacle voxels hold their own coordinates, others uninit.
    With `z_offset` z0 the grid is the z-slab [z0, z0 + Z) of a larger one:
    an obstacle holds its global coordinates."""
    px, py, pz = _position_grids(dims, mask_flat.device, z_offset)
    own = (px | (py << 10) | (pz << 20)).reshape(-1)
    return torch.where(mask_flat.reshape(-1), own, PBA_UNINITIALISED_PACKED)


def with_obstacles(packed_flat: torch.Tensor, mask_flat: torch.Tensor, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """int32[N]: the packed grid with every `mask` voxel made an obstacle
    holding its own coordinates (DistanceVoxel::insert), the rest kept.
    With `z_offset` z0 the grid is the z-slab [z0, z0 + Z) of a larger one."""
    return torch.where(mask_flat, init_from_obstacle_mask(mask_flat, dims, z_offset), packed_flat)


def merge_occupied(packed_flat: torch.Tensor, prob: torch.Tensor, threshold: int, dims: Dims,
                   z_offset: int = 0) -> torch.Tensor:
    """int32[N]: the packed grid with every voxel whose int8 log-odds `prob`
    is >= `threshold` made an obstacle (mergeOccupied, DistanceVoxelMap.h:86-122),
    the rest kept. The spec of the merge kernel (ops/edt_cuda.py)."""
    return with_obstacles(packed_flat, prob.to(I32) >= threshold, dims, z_offset)


def min_squared_distance_at(packed_flat: torch.Tensor, idx: torch.Tensor, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """The least squared obstacle distance over the voxels `idx` (int64, as
    voxelize gives them: an index >= N, its spare slot, counts as
    MAX_OBSTACLE_DISTANCE), a 0-d int32 tensor. With `z_offset` z0 the grid
    is the z-slab [z0, z0 + Z) of a larger one."""
    n = dims[0] * dims[1] * dims[2]
    d2 = squared_distance_at(packed_flat, idx.clamp(max=n - 1), dims, z_offset)
    return torch.where(idx < n, d2, MAX_OBSTACLE_DISTANCE).min()


def min_distance_to(packed_flat: torch.Tensor, points: torch.Tensor, side_length: float, dims: Dims) -> torch.Tensor:
    """The least metric distance from any of the float32 [P, 3] query
    points to its nearest obstacle, a 0-d float32 tensor; points outside the
    map count as MAX_OBSTACLE_DISTANCE. Reads the EDT at the query voxels
    only. The spec of the query kernel (ops/edt_cuda.py)."""
    idx, _ = insert_ops.voxelize(points, side_length, dims)
    d2 = min_squared_distance_at(packed_flat, idx, dims)
    return torch.sqrt(d2.to(torch.float32)) * side_length


def exact_distances(obstacle_coords, dims: Dims, chunk: int = 4096, z_offset: int = 0) -> torch.Tensor:
    """Brute-force oracle: nearest of M obstacle coordinates per voxel.

    obstacle_coords: int[M, 3] (x, y, z) on the device of the result; rows
    with x == 1023 are invalid. Ties go to the first obstacle in the list
    (argmin). Returns packed int32[N]. O(N*M): small scenes and tests only,
    like the reference's exactDistances3D. With `z_offset` z0 the grid is
    the z-slab [z0, z0 + Z) of a larger one.
    """
    obs = torch.as_tensor(obstacle_coords).to(I32)
    dev = obs.device
    dx, dy, dz = dims
    n = dx * dy * dz
    valid = obs[:, 0] != PBA_UNINITIALISED_COORD
    packed_obs = pack(obs[:, 0], obs[:, 1], obs[:, 2])
    out = torch.empty(n, dtype=I32, device=dev)
    for start in range(0, n, chunk):
        i = torch.arange(start, min(start + chunk, n), dtype=torch.int64, device=dev)
        pos = torch.stack([i % dx, (i // dx) % dy, i // (dx * dy) + int(z_offset)], dim=1).to(I32)
        diff = obs[None, :, :] - pos[:, None, :]
        d = (diff * diff).sum(dim=-1, dtype=I32)
        d = torch.where(valid[None, :], d, MAX_OBSTACLE_DISTANCE)
        best = torch.argmin(d, dim=1)  # the first minimum
        hit = d.gather(1, best[:, None])[:, 0] < MAX_OBSTACLE_DISTANCE
        out[start : start + i.shape[0]] = torch.where(hit, packed_obs[best], PBA_UNINITIALISED_PACKED)
    return out


def _merge(best_packed, best_d2, cand_packed, dims: Dims):
    """Keep the closer of the current best and the candidate (strictly
    closer wins, like updateMinVoxel)."""
    px, py, pz = _position_grids(dims, cand_packed.device)
    d2 = _sq_dist(cand_packed, px, py, pz)
    take = d2 < best_d2
    return torch.where(take, cand_packed, best_packed), torch.where(take, d2, best_d2)


_NEIGHBORS = [
    (ox, oy, oz)
    for ox in (-1, 0, 1)
    for oy in (-1, 0, 1)
    for oz in (-1, 0, 1)
    if (ox, oy, oz) != (0, 0, 0)
]


def _shift3d(grid: torch.Tensor, off, fill: int) -> torch.Tensor:
    """grid shifted so result[p] = grid[p + off], `fill` where p + off lies
    outside (off is (ox, oy, oz) on a [Z, Y, X] grid): a roll, then the
    wrapped slice filled, as the reference does it. An offset beyond an
    axis's size wraps part of the axis back in, in both packages (F8)."""
    g = grid
    for axis, o in ((0, off[2]), (1, off[1]), (2, off[0])):
        if o == 0:
            continue
        g = torch.roll(g, -o, dims=axis)
        idx = [slice(None)] * 3
        idx[axis] = slice(g.shape[axis] - o, None) if o > 0 else slice(0, -o)
        g[tuple(idx)] = fill
    return g


def _jfa_round(grid: torch.Tensor, best_d2: torch.Tensor, s: int, dims: Dims):
    """One JFA round: merge all 26 neighbours at step s, in the reference's
    neighbour order (the grid is padded once with uninitialised sites, so
    every neighbour is a slice of one tensor)."""
    dz, dy, dx = grid.shape
    p = torch.full((dz + 2 * s, dy + 2 * s, dx + 2 * s), PBA_UNINITIALISED_PACKED, dtype=I32, device=grid.device)
    p[s : s + dz, s : s + dy, s : s + dx] = grid
    px, py, pz = _position_grids(dims, grid.device)
    for ox, oy, oz in _NEIGHBORS:
        z0, y0, x0 = s + oz * s, s + oy * s, s + ox * s
        cand = p[z0 : z0 + dz, y0 : y0 + dy, x0 : x0 + dx]
        d2 = _sq_dist(cand, px, py, pz)
        take = d2 < best_d2
        grid = torch.where(take, cand, grid)
        best_d2 = torch.where(take, d2, best_d2)
    return grid, best_d2


def _converge_step1(grid, best_d2, dims: Dims, max_iters: int = REPAIR_MAX_ROUNDS):
    """Iterate step-1 rounds to a fixpoint: every cell's result becomes a
    local optimum over its 26 neighbours' sites, which repairs the rare
    isolated errors of JFA and its multiresolution variant (Voronoi cells
    of point sites are connected). Capped at max_iters; returns
    (grid, d2, iterations_used). Each round reads one changed-flag on the
    host, as the reference's while_loop does on its device."""
    iters = 0
    while iters < max_iters:
        g2, d2 = _jfa_round(grid, best_d2, 1, dims)
        changed = bool(torch.any(d2 != best_d2))
        grid, best_d2 = g2, d2
        iters += 1
        if not changed:
            break
    return grid, best_d2, iters


def _jfa_steps(dims: Dims, extra_rounds: int):
    """The JFA step schedule: a power-of-two ramp down from max(dims)/2
    plus extra_rounds step-1 refinement passes."""
    step = 1
    while step * 2 < max(dims):
        step *= 2
    steps = []
    s = step
    while s >= 1:
        steps.append(s)
        s //= 2
    steps.extend([1] * int(extra_rounds))
    return steps


def jump_flood(packed_flat: torch.Tensor, dims: Dims, extra_rounds: int = 1, converge: bool = True) -> torch.Tensor:
    """3D jump flooding over the packed grid (jumpFlood3D,
    DistanceVoxelMap.hpp:136); converge=True iterates step-1 rounds to a
    fixpoint afterwards."""
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx)
    best_d2 = squared_distance_grid(packed_flat, dims)
    for s in _jfa_steps(dims, extra_rounds):
        grid, best_d2 = _jfa_round(grid, best_d2, s, dims)
    if converge:
        grid, best_d2, _ = _converge_step1(grid, best_d2, dims)
    return grid.reshape(-1)


def jump_flood_with_stats(packed_flat: torch.Tensor, dims: Dims, extra_rounds: int = 1,
                          max_iters: int = REPAIR_MAX_ROUNDS):
    """jump_flood plus the repair's telemetry: (packed, repair_iters), where
    repair_iters == max_iters means the repair hit its cap unconverged."""
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx)
    best_d2 = squared_distance_grid(packed_flat, dims)
    for s in _jfa_steps(dims, extra_rounds):
        grid, best_d2 = _jfa_round(grid, best_d2, s, dims)
    grid, best_d2, iters = _converge_step1(grid, best_d2, dims, max_iters)
    return grid.reshape(-1), iters


def _halve_min(sites: torch.Tensor, d: torch.Tensor, axis: int):
    """Pairwise strided min-merge along `axis` (odd wins only if strictly closer)."""
    sl0, sl1 = [slice(None)] * 3, [slice(None)] * 3
    sl0[axis], sl1[axis] = slice(0, None, 2), slice(1, None, 2)
    s0, s1 = sites[tuple(sl0)], sites[tuple(sl1)]
    d0, d1 = d[tuple(sl0)], d[tuple(sl1)]
    take = d1 < d0
    return torch.where(take, s1, s0), torch.where(take, d1, d0)


def jump_flood_multires(packed_flat: torch.Tensor, dims: Dims, coarse_factor: int = MULTIRES_COARSE_FACTOR,
                        fine_steps=MULTIRES_FINE_STEPS) -> torch.Tensor:
    """Multi-resolution jump flooding: a full JFA on a 1/c^3 grid whose
    cells keep the site closest to their block centre seeds the fine grid,
    which then runs only short-range rounds and the fixpoint repair (capped
    at 64 rounds, as the reference's). Grids not divisible by c take the
    flat `jump_flood`."""
    return jump_flood_multires_with_stats(packed_flat, dims, coarse_factor, fine_steps)[0]


def jump_flood_multires_with_stats(packed_flat: torch.Tensor, dims: Dims,
                                   coarse_factor: int = MULTIRES_COARSE_FACTOR, fine_steps=MULTIRES_FINE_STEPS,
                                   max_iters: int = REPAIR_MAX_ROUNDS):
    """jump_flood_multires plus the repair's telemetry: (packed,
    repair_iters), where repair_iters == max_iters means the repair hit its
    cap unconverged; a cap it does not reach gives the repair's fixpoint."""
    dx, dy, dz = dims
    c = coarse_factor
    if dx % c or dy % c or dz % c:
        return jump_flood_with_stats(packed_flat, dims, max_iters=max_iters)
    dev = packed_flat.device
    grid = packed_flat.reshape(dz, dy, dx)
    d2 = squared_distance_grid(packed_flat, dims)

    # coarsen: per c^3 block keep the site closest to the block centre, in
    # doubled coordinates (2 * centre = 2 * (voxel // c) * c + (c - 1))
    cxg, cyg, czg = unpack(grid)
    px, py, pz = _position_grids(dims, dev)
    bx, by, bz = ((p // c) * (2 * c) + (c - 1) for p in (px, py, pz))
    ex, ey, ez = 2 * cxg - bx, 2 * cyg - by, 2 * czg - bz
    dd = torch.where(_uninit(cxg, cyg, czg), MAX_OBSTACLE_DISTANCE, ex * ex + ey * ey + ez * ez)
    coarse_sites, dd_c = grid, dd
    halvings = c.bit_length() - 1
    for axis in (2, 1, 0):
        for _ in range(halvings):
            coarse_sites, dd_c = _halve_min(coarse_sites, dd_c, axis)

    cg = coarse_flood(coarse_sites, c)

    # upsample: every fine voxel adopts its block's coarse site
    up = cg.repeat_interleave(c, 0).repeat_interleave(c, 1).repeat_interleave(c, 2)
    grid, d2 = _merge(grid, d2, up, dims)

    # short-range fine refinement and the fixpoint repair
    for s in fine_steps:
        grid, d2 = _jfa_round(grid, d2, s, dims)
    grid, d2, iters = _converge_step1(grid, d2, dims, max_iters)
    return grid.reshape(-1), iters


def coarse_flood(cg: torch.Tensor, c: int) -> torch.Tensor:
    """The full JFA of jump_flood_multires' coarse [Z/c, Y/c, X/c] grid:
    sites keep fine coordinates, positions are block centres (doubled
    coordinates), neighbours come from `_shift3d`, whose offsets beyond an
    axis wrap part of it back in (F8)."""
    czs, cys, cxs = cg.shape
    cdims = (cxs, cys, czs)
    cpx, cpy, cpz = ((p * (2 * c) + (c - 1)) for p in _position_grids(cdims, cg.device))

    def coarse_d2(cand):
        sx, sy, sz = unpack(cand)
        ex, ey, ez = 2 * sx - cpx, 2 * sy - cpy, 2 * sz - cpz
        return torch.where(_uninit(sx, sy, sz), MAX_OBSTACLE_DISTANCE, ex * ex + ey * ey + ez * ez)

    cbest = coarse_d2(cg)
    step = 1
    while step * 2 < max(cdims):
        step *= 2
    s = step
    while s >= 1:
        for ox, oy, oz in _NEIGHBORS:
            cand = _shift3d(cg, (ox * s, oy * s, oz * s), PBA_UNINITIALISED_PACKED)
            nd = coarse_d2(cand)
            take = nd < cbest
            cg = torch.where(take, cand, cg)
            cbest = torch.where(take, nd, cbest)
        s //= 2
    return cg


def _floor_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _envelope_pass_1d(g2: torch.Tensor, sites: torch.Tensor):
    """Exact 1D distance transform with parabolic costs, batched over lines:
    out[x] = min_q ((x - q)^2 + g2[q]) plus the argmin's payload, by
    Meijster's all-integer lower-envelope algorithm, as the reference runs
    it (a scan over positions, vectorized across lines, with masked pops).

    g2 int32[L, n] (MAX_OBSTACLE_DISTANCE marks "no site"), sites int32[L, n].
    Returns (out_d2 int32[L, n], out_sites int32[L, n]).
    """
    L, n = g2.shape
    dev = g2.device
    miss = 1 << 27  # finite "no site" stand-in; n^2 + MISS stays in int32
    g2l = torch.where(g2 >= miss, miss, g2.to(I32))
    lines = torch.arange(L, device=dev)

    def f(x, i, g):  # parabola with centre i and offset g, at x
        d = x - i
        return d * d + g

    def g_at(pos):
        return g2l.gather(1, pos.to(torch.int64)[:, None])[:, 0]

    s = torch.zeros((L, n), dtype=I32, device=dev)  # stack of parabola centres
    t = torch.zeros((L, n), dtype=I32, device=dev)  # first winning x per entry
    q = torch.zeros((L,), dtype=torch.int64, device=dev)  # top index
    for u in range(1, n):  # u = 0 seeds the stack (s, t zeros)
        gu = g2l[:, u]
        active = q >= 0
        while bool(active.any()):
            qs = q.clamp(min=0)[:, None]
            sq, tq = s.gather(1, qs)[:, 0], t.gather(1, qs)[:, 0]
            worse = f(tq, sq, g_at(sq)) > f(tq, u, gu)
            do_pop = active & worse & (q >= 0)
            q = torch.where(do_pop, q - 1, q)
            active = do_pop & (q >= 0)
        restart = q < 0
        q_safe = q.clamp(min=0)[:, None]
        sq = s.gather(1, q_safe)[:, 0]
        gi = g_at(sq)
        w = 1 + _floor_div(u * u - sq * sq + gu - gi, 2 * (u - sq))
        push = ~restart & (w < n)
        newq = torch.where(restart, 0, torch.where(push, q + 1, q))
        at_new = newq[:, None]
        newval_s = torch.where(restart | push, u, s.gather(1, at_new)[:, 0])
        newval_t = torch.where(restart, 0, torch.where(push, w, t.gather(1, at_new)[:, 0]))
        s[lines, newq] = newval_s.to(I32)
        t[lines, newq] = newval_t.to(I32)
        q = newq

    # evaluation: k(x) = the last stack entry with t[k] <= x
    xs = torch.arange(n, dtype=I32, device=dev)
    idx_k = torch.arange(n, device=dev)[None, :]
    t_masked = torch.where(idx_k <= q[:, None], t, 2**31 - 1)
    k = torch.searchsorted(t_masked, xs.expand(L, n).contiguous(), right=True) - 1
    centers = s.gather(1, k.clamp(0, n - 1))
    gv = g2l.gather(1, centers.to(torch.int64))
    dxc = xs[None, :] - centers
    d2 = dxc * dxc + gv
    d2 = torch.where(d2 >= miss, MAX_OBSTACLE_DISTANCE, d2)
    return d2, sites.gather(1, centers.to(torch.int64))


def exact_separable(packed_flat: torch.Tensor, dims: Dims) -> torch.Tensor:
    """Exact 3D EDT via three separable passes (the PBA algorithm's math:
    phase 1 = two Z scans, phases 2/3 = batched Meijster envelopes).
    Returns packed nearest-obstacle coordinates, like the PBA kernels."""
    from .edt_envelope import _nearest_scan

    is_site = squared_distance_grid(packed_flat, dims) == 0

    # phase 1: nearest site along Z per (y, x) column; a column without one
    # gives MISS, which the envelope treats as the reference's
    # MAX_OBSTACLE_DISTANCE (both clamp to MISS)
    g2, near_z = _nearest_scan(is_site)
    # carry packed (x, y, near_z) as the site payload
    px, py, _ = _position_grids(dims, packed_flat.device)
    site1 = px | (py << 10) | (near_z.clamp(0, PBA_UNINITIALISED_COORD) << 20)
    return separable_yx(g2, site1).reshape(-1)


def separable_yx(g2: torch.Tensor, site1: torch.Tensor) -> torch.Tensor:
    """Phases 2 and 3 of exact_separable on int32 [Z, Y, X] grids (the Z
    scans' squared distances, MISS where a column has no site, and their
    packed sites): Meijster's envelopes along Y, then X. Returns the packed
    nearest-obstacle grid [Z, Y, X]."""
    dz, dy, dx = g2.shape
    # phase 2: envelope along Y (lines are (z, x) pairs)
    g2_y = g2.permute(0, 2, 1).reshape(dz * dx, dy)
    s_y = site1.permute(0, 2, 1).reshape(dz * dx, dy)
    d2_y, s2_y = _envelope_pass_1d(g2_y, s_y)
    d2 = d2_y.reshape(dz, dx, dy).permute(0, 2, 1)
    s2 = s2_y.reshape(dz, dx, dy).permute(0, 2, 1)

    # phase 3: envelope along X (lines are (z, y) pairs)
    d3, s3 = _envelope_pass_1d(d2.reshape(dz * dy, dx), s2.reshape(dz * dy, dx))
    # the payload already carries (x*, y*, z*): its x is the winning column
    return torch.where(d3 >= MAX_OBSTACLE_DISTANCE, PBA_UNINITIALISED_PACKED, s3).reshape(dz, dy, dx)


def differences(packed_a: torch.Tensor, packed_b: torch.Tensor, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """differences3D (DistanceVoxelMap.hpp:723): the number of voxels whose
    squared obstacle distances disagree, a 0-d int64 tensor. With `z_offset`
    z0 the grids are the z-slab [z0, z0 + Z) of larger ones."""
    return (squared_distance_grid(packed_a, dims, z_offset) != squared_distance_grid(packed_b, dims, z_offset)).sum()


def extract_byte_distances(packed_flat: torch.Tensor, dims: Dims, robot_radius: int = 0,
                           z_offset: int = 0) -> torch.Tensor:
    """extract_distances functor (DistanceVoxel.h:154-205): int8 free space
    per voxel = clamp(floor(sqrt(d2)) - robot_radius, 0, 127); uninitialised
    voxels count as 127. With `z_offset` z0 the grid is the z-slab
    [z0, z0 + Z) of a larger one."""
    d2 = squared_distance_grid(packed_flat, dims, z_offset)
    free = floor_sqrt(torch.where(d2 >= MAX_OBSTACLE_DISTANCE, 127 * 127, d2))
    return torch.clamp(free - robot_radius, 0, 127).to(torch.int8).reshape(-1)


def floor_sqrt(d2: torch.Tensor) -> torch.Tensor:
    """int64 floor(sqrt(d2)) of non-negative integers below 2^31, exact by
    construction: the f32 root floors to within one of it, and the integer
    tests r * r > d2 and (r + 1)^2 <= d2 correct it."""
    d2 = d2.to(torch.int64)
    r = torch.floor(torch.sqrt(d2.to(torch.float32))).to(torch.int64)
    r = r - (r * r > d2).to(torch.int64)
    return r + ((r + 1) * (r + 1) <= d2).to(torch.int64)


def manhattan_distance(obstacle_mask_flat: torch.Tensor, dims: Dims, cap: int = 32767) -> torch.Tensor:
    """Exact separable L1 distance transform (init_floodfill analogue,
    DistanceVoxelMap.h getManhattanDistances): per axis a forward and a
    backward sweep. The reference's sweep carry = min(carry + 1, d[i]) from
    carry = cap is f[i] = i + cummin_{j <= i}(d[j] - j), since d <= cap."""
    dx, dy, dz = dims
    d = torch.where(obstacle_mask_flat.reshape(dz, dy, dx), 0, cap).to(I32)
    for axis in (0, 1, 2):
        d = l1_pass(d, axis)
    return torch.clamp(d, max=cap).reshape(-1)


def l1_pass(d: torch.Tensor, axis: int) -> torch.Tensor:
    """One axis of manhattan_distance on an int32 [Z, Y, X] grid: the
    forward sweep's prefix min of d - i plus i, the backward sweep's suffix
    min of d + i minus i, the smaller of the two."""
    n = d.shape[axis]
    shape = [1, 1, 1]
    shape[axis] = n
    i = torch.arange(n, dtype=I32, device=d.device).view(shape)
    fwd = torch.cummin(d - i, dim=axis).values + i
    # the backward sweep is the same on the flipped axis: a suffix min
    bwd = torch.flip(torch.cummin(torch.flip(d + i, [axis]), dim=axis).values, [axis]) - i
    return torch.minimum(fwd, bwd)
