"""Multi-device EDT: jump flooding on a z-slab grid with halo exchange.

Counterpart of gpu_voxels_tpu/parallel/sharded_edt.py, in plain torch (the
reference has no kernel here). The grid lives as contiguous z-slabs, one
per mesh device (parallel/sharded.py), and the multiresolution structure
maps onto them:

  * the coarse grid is small (1/c^3): each slab coarsens its own rows, the
    coarse slabs are gathered onto the mesh's first device, flooded there
    once (the reference floods it on every chip), and each slab takes back
    its rows;
  * a fine round at step s <= slab depth needs an s-deep halo from each z
    neighbour: their boundary rows moved with `.to(device)` (the
    reference's ppermute pair); the grid's edge slabs get uninitialised
    halos, never zeros (a zero decodes as a site at the origin);
  * the step-1 fixpoint repair runs until the changed flags, summed over
    the slabs, are zero: one host read a round. It has no cap, as the
    reference's while_loop has none; the single-device repair
    (ops/edt._converge_step1) stops after 64 rounds, so where that cap binds
    the two differ.

The squared distances equal those of `ops.edt.jump_flood_multires_with_stats`
run to its fixpoint (a `max_iters` the repair does not reach) with the same
fine steps; a payload may differ on a tie, as in the reference, whose own
check compares distances.

A second form, `jump_flood_slabs`, keeps the single-device rules instead
(ops/edt.jump_flood and jump_flood_multires): the coarse flood wraps an
offset beyond an axis back in (F8), the repair stops after 64 rounds (F21),
and a halo deeper than a slab reads the rows of every slab it covers. Its
packed grid equals the single-device call's, slab for slab, payloads
included: a sharded DistanceVoxelMap's `jump_flood` takes it where the
single-device call takes a JFA.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..constants import MAX_OBSTACLE_DISTANCE, PBA_UNINITIALISED_PACKED
from ..ops import edt
from .sharded import GridMesh, gather_rows, psum, split_slabs

Dims = Tuple[int, int, int]
I32 = torch.int32


def _halo_exchange_z(slabs, s: int) -> list:
    """Each [zl, Y, X] slab as [zl + 2s, Y, X] with the s rows below and
    above it (from as many slabs as they cover); the grid's edges get
    uninitialised rows."""
    zl = slabs[0].shape[0]
    return [gather_rows(slabs, k * zl - s, (k + 1) * zl + s, local.device, PBA_UNINITIALISED_PACKED)
            for k, local in enumerate(slabs)]


def _positions(local: torch.Tensor, z0: int):
    zl, dy, dx = local.shape
    dev = local.device
    return (torch.arange(dx, dtype=I32, device=dev).view(1, 1, dx),
            torch.arange(dy, dtype=I32, device=dev).view(1, dy, 1),
            (torch.arange(zl, dtype=I32, device=dev) + z0).view(zl, 1, 1))


def _sharded_round(slabs, best, s: int, z0s):
    """One 26-neighbour JFA round on every slab, the halos taken from the
    state before the round."""
    haloed = _halo_exchange_z(slabs, s)
    new_slabs, new_best = [], []
    for local, best_d2, h, z0 in zip(slabs, best, haloed, z0s):
        zl, dy, dx = local.shape
        p = torch.full((zl + 2 * s, dy + 2 * s, dx + 2 * s), PBA_UNINITIALISED_PACKED, dtype=I32, device=local.device)
        p[:, s:s + dy, s:s + dx] = h
        px, py, pz = _positions(local, z0)
        for ox, oy, oz in edt._NEIGHBORS:
            zs, ys, xs = s + oz * s, s + oy * s, s + ox * s
            cand = p[zs:zs + zl, ys:ys + dy, xs:xs + dx]
            d2 = edt._sq_dist(cand, px, py, pz)
            take = d2 < best_d2
            local = torch.where(take, cand, local)
            best_d2 = torch.where(take, d2, best_d2)
        new_slabs.append(local)
        new_best.append(best_d2)
    return new_slabs, new_best


def _coarsen(local: torch.Tensor, z0: int, c: int) -> torch.Tensor:
    """Per c^3 block of a slab, the site closest to the block centre (in
    doubled coordinates), as jump_flood_multires coarsens."""
    px, py, pz = _positions(local, z0)
    cx, cy, cz = edt.unpack(local)
    bx, by, bz = ((p // c) * (2 * c) + (c - 1) for p in (px, py, pz))
    ex, ey, ez = 2 * cx - bx, 2 * cy - by, 2 * cz - bz
    dd = torch.where(edt._uninit(cx, cy, cz), MAX_OBSTACLE_DISTANCE, ex * ex + ey * ey + ez * ez)
    sites = local
    for axis in (2, 1, 0):
        for _ in range(c.bit_length() - 1):
            sites, dd = edt._halve_min(sites, dd, axis)
    return sites


def _coarse_flood(cg: torch.Tensor, c: int) -> torch.Tensor:
    """The full JFA of the gathered coarse grid: sites keep fine
    coordinates, positions are block centres; neighbours come from a padded
    copy (no wrap-around)."""
    czs, cys, cxs = cg.shape
    qx, qy, qz = ((p * (2 * c) + (c - 1)) for p in edt._position_grids((cxs, cys, czs), cg.device))

    def coarse_d2(cand):
        sx, sy, sz = edt.unpack(cand)
        ex, ey, ez = 2 * sx - qx, 2 * sy - qy, 2 * sz - qz
        return torch.where(edt._uninit(sx, sy, sz), MAX_OBSTACLE_DISTANCE, ex * ex + ey * ey + ez * ez)

    cbest = coarse_d2(cg)
    step = 1
    while step * 2 < max(cxs, cys, czs):
        step *= 2
    s = step
    while s >= 1:
        p = torch.full((czs + 2 * s, cys + 2 * s, cxs + 2 * s), PBA_UNINITIALISED_PACKED, dtype=I32, device=cg.device)
        p[s:s + czs, s:s + cys, s:s + cxs] = cg
        for ox, oy, oz in edt._NEIGHBORS:
            zs, ys, xs = s + oz * s, s + oy * s, s + ox * s
            cand = p[zs:zs + czs, ys:ys + cys, xs:xs + cxs]
            nd = coarse_d2(cand)
            take = nd < cbest
            cg = torch.where(take, cand, cg)
            cbest = torch.where(take, nd, cbest)
        s //= 2
    return cg


def _repair(slabs, best, z0s, first, max_iters=None):
    """Step-1 rounds until no slab changes (one host read of the summed
    flags a round), at most `max_iters` rounds where one is given:
    ops/edt._converge_step1 over the slabs. Returns (slabs, best, rounds)."""
    rounds = 0
    while max_iters is None or rounds < max_iters:
        new_slabs, new_best = _sharded_round(slabs, best, 1, z0s)
        flags = [torch.any(nb != b).to(torch.int64) for nb, b in zip(new_best, best)]
        slabs, best = new_slabs, new_best
        rounds += 1
        if not bool(psum(flags, first)):
            break
    return slabs, best, rounds


def jump_flood_slabs(slabs, dims: Dims, devices, extra_rounds: int = 1, multires: bool = False) -> list:
    """ops/edt.jump_flood (or, with `multires`, jump_flood_multires) of a
    packed grid held as equal flat z-slabs, slab k on devices[k]: the
    single-device rounds and rules (ops/edt's MULTIRES_COARSE_FACTOR,
    MULTIRES_FINE_STEPS and REPAIR_MAX_ROUNDS), the slabs' packed grids
    equal to the whole call's pieces. The coarse grid of the multires form
    is coarsened block by block (a block crossing a slab reads the next
    slab's rows), joined on devices[0] and flooded there with
    ops/edt.coarse_flood."""
    dx, dy, dz = (int(d) for d in dims)
    nz = len(devices)
    zl = dz // nz
    z0s = [k * zl for k in range(nz)]
    grids = [p.reshape(zl, dy, dx) for p in split_slabs(slabs, devices)]
    best = [edt.squared_distance_grid(g, (dx, dy, zl), z0) for g, z0 in zip(grids, z0s)]
    first = devices[0]
    if multires:
        c = edt.MULTIRES_COARSE_FACTOR
        if dx % c or dy % c or dz % c:
            raise ValueError(f"dims {dims} must divide the coarse factor {c}")
        coarse = []
        for k, (dev, z0) in enumerate(zip(devices, z0s)):
            lo, hi = -(-z0 // c), -(-(z0 + zl) // c)  # the blocks whose first row lies in slab k
            if lo < hi:
                coarse.append(_coarsen(gather_rows(grids, lo * c, hi * c, dev, PBA_UNINITIALISED_PACKED), lo * c, c)
                              .to(first))
        cg = edt.coarse_flood(torch.cat(coarse), c)
        for k, (dev, z0) in enumerate(zip(devices, z0s)):
            lo = z0 // c
            mine = cg[lo:(z0 + zl - 1) // c + 1].to(dev)
            up = mine.repeat_interleave(c, 0).repeat_interleave(c, 1).repeat_interleave(c, 2)[z0 - lo * c:][:zl]
            px, py, pz = _positions(grids[k], z0)
            up_d2 = edt._sq_dist(up, px, py, pz)
            take = up_d2 < best[k]
            grids[k] = torch.where(take, up, grids[k])
            best[k] = torch.where(take, up_d2, best[k])
        steps = edt.MULTIRES_FINE_STEPS
    else:
        steps = edt._jfa_steps(dims, extra_rounds)
    for s in steps:
        grids, best = _sharded_round(grids, best, s, z0s)
    grids, _, _ = _repair(grids, best, z0s, first, edt.REPAIR_MAX_ROUNDS)
    return [g.reshape(-1) for g in grids]


def build_sharded_edt(mesh: GridMesh, dims: Dims, coarse_factor: int = 4, fine_steps=(8, 4, 2, 1, 1)):
    """fn(packed_flat int32[N] or its z slabs) -> the z slabs (flat int32,
    each on its slab's device) of the multiresolution jump flood over the
    mesh's z axis, its step-1 repair run to its fixpoint. Its squared
    distances equal edt.jump_flood_multires_with_stats' at that fixpoint."""
    dx, dy, dz = (int(d) for d in dims)
    nz = mesh.shape["z"]
    if dz % nz:
        raise ValueError("dimz must divide the z mesh")
    zl = dz // nz
    c = int(coarse_factor)
    if zl % c or dy % c or dx % c:
        raise ValueError("dims must divide the coarse factor per slab")
    if max(fine_steps) > zl:
        raise ValueError("fine steps must not exceed the slab thickness")
    devices = mesh.z_devices()
    z0s = [k * zl for k in range(nz)]

    def fn(packed):
        slabs = [p.reshape(zl, dy, dx) for p in split_slabs(packed, devices)]
        # the coarse grid: coarsened per slab, gathered, flooded once
        cg = _coarse_flood(torch.cat([_coarsen(s, z0, c).to(mesh.first) for s, z0 in zip(slabs, z0s)]), c)
        czl = zl // c
        best = []
        for k, (local, z0) in enumerate(zip(slabs, z0s)):
            mine = cg[k * czl:(k + 1) * czl].to(local.device)
            up = mine.repeat_interleave(c, 0).repeat_interleave(c, 1).repeat_interleave(c, 2)
            px, py, pz = _positions(local, z0)
            d2 = edt._sq_dist(local, px, py, pz)
            up_d2 = edt._sq_dist(up, px, py, pz)
            take = up_d2 < d2
            slabs[k] = torch.where(take, up, local)
            best.append(torch.where(take, up_d2, d2))
        for s in fine_steps:
            slabs, best = _sharded_round(slabs, best, s, z0s)
        slabs, _, _ = _repair(slabs, best, z0s, mesh.first)
        return [s.reshape(-1) for s in slabs]

    return fn
