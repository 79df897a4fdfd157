"""Multi-device exact EDT: z-slab sharded parallel_banding.

Counterpart of gpu_voxels_tpu/parallel/sharded_edt_exact.py. The exact EDT
(ops/edt_envelope.parallel_banding, the parallelBanding3D replacement,
DistanceVoxelMap.hpp:251-345) over z-slabs, bit-identical to the
single-device call:

  * phase 1 (Z flood): each slab runs the local up / down nearest-site scans
    in global z indices, then ONE gather of the per-slab boundary summaries
    ([nz, dy, dx] "last / first marked z") gives every slab the exact carry
    entering from the slabs below and above it: the halo exchange SURVEY
    §7.11 prescribes, as one collective instead of nz neighbour passes;
  * phases 2 / 3 (Y / X envelopes) are independent per z-slice, so each
    slab runs K5 (ops/edt_cuda.envelope_pass) along Y and then X on its own
    rows, with no communication.

The selection and tie rules are the single-device ones (`dd <= du` keeps
the lower z site; the envelope's ties go to the smallest q). The
reference's coarse ring bounds (`_block_any`, `_bound_from_d2`,
`_max_x_blocks`, the coarse EDTs, `transpose_out`) are not ported: K5 and
the single-device parallel_banding take none, and a bound never changes
the output. `bound_c` stays an argument, with the reference's checks, so
the same calls fail the same way.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..constants import PBA_UNINITIALISED_COORD, PBA_UNINITIALISED_PACKED
from ..ops.edt_envelope import MISS, envelope_pass
from .sharded import GridMesh, split_slabs

Dims = Tuple[int, int, int]
I32 = torch.int32
_BIG = 2**30  # "no marked z"


def _local_scans(flag: torch.Tensor, gidx: torch.Tensor):
    """(down, up) of a slab's site mask [dzl, dy, dx] whose global z indices
    are gidx [dzl, 1, 1]: per voxel the latest marked z at or below it (-1
    if none) and the earliest at or above it (_BIG if none), in the slab."""
    down = torch.cummax(torch.where(flag, gidx, -1), dim=0).values
    up = torch.flip(torch.cummin(torch.flip(torch.where(flag, gidx, _BIG), [0]), dim=0).values, [0])
    return down, up


def _carries(lasts, firsts, device):
    """Per slab s, the latest marked z of the slabs below it (-1 if none) and
    the earliest of the slabs above it (_BIG if none), from one gather of the
    [dy, dx] boundary rows onto `device`."""
    all_last = torch.stack([t.to(device) for t in lasts])  # [nz, dy, dx]
    all_first = torch.stack([t.to(device) for t in firsts])
    below = torch.cummax(all_last, dim=0).values
    above = torch.flip(torch.cummin(torch.flip(all_first, [0]), dim=0).values, [0])
    none_below = torch.full_like(all_last[:1], -1)
    none_above = torch.full_like(all_first[:1], _BIG)
    return torch.cat([none_below, below[:-1]]), torch.cat([above[1:], none_above])


def _flood_z_slab(down_local, up_local, gidx, carry_down, carry_up, px, py):
    """PBA phase 1 on a slab with its cross-slab carries: (g1, payload), as
    edt_envelope.flood_z computes them on the whole column."""
    down = torch.where(down_local >= 0, down_local, carry_down)
    up = torch.minimum(up_local, carry_up)
    has_down, has_up = down >= 0, up < _BIG
    down = torch.where(has_down, down, _BIG)
    dd_ = torch.where(has_down, gidx - down, 0)
    du_ = torch.where(has_up, up - gidx, 0)
    dd = torch.where(has_down, dd_ * dd_, MISS)
    du = torch.where(has_up, du_ * du_, MISS)
    near = torch.where(dd <= du, down, up)
    g1 = torch.minimum(dd, du).clamp_(max=MISS)
    return g1, px | (py << 10) | (near.clamp(0, PBA_UNINITIALISED_COORD) << 20)


def build_sharded_parallel_banding(mesh: GridMesh, dims: Dims, bound_c: int = 8):
    """fn(packed_flat int32[N] or its z slabs) -> the z slabs (flat int32,
    each on its slab's device) of the exact EDT, bit-identical slab for slab
    to `ops.edt_envelope.parallel_banding(packed_flat, dims)`.

    Constraints, as in the reference: dz must divide over the mesh's z axis
    and each slab's z extent must be a multiple of bound_c."""
    dx, dy, dz = (int(d) for d in dims)
    nz = mesh.shape["z"]
    if dz % nz:
        raise ValueError(f"dimz {dz} must divide the z mesh ({nz})")
    dzl = dz // nz
    if dzl % bound_c:
        raise ValueError(f"slab z extent {dzl} must be a multiple of bound_c {bound_c}")
    devices = mesh.z_devices()

    def fn(packed):
        sites = []
        for k, (dev, part) in enumerate(zip(devices, split_slabs(packed, devices))):
            grid = part.reshape(dzl, dy, dx)
            ox, oy, oz = grid & 0x3FF, (grid >> 10) & 0x3FF, grid >> 20
            px, py, gidx = _slab_positions(dev, (dx, dy, dzl), k * dzl)
            sites.append((ox == px) & (oy == py) & (oz == gidx) & (ox != PBA_UNINITIALISED_COORD))
        out = []
        for g1, pay1 in flood_z_slabs(sites, mesh.first):
            d2, pay2 = envelope_pass(g1, pay1, 1)
            d3, pay3 = envelope_pass(d2, pay2, 2)
            out.append(torch.where(d3 >= MISS, PBA_UNINITIALISED_PACKED, pay3).reshape(-1))
        return out

    return fn


def _slab_positions(dev, local_dims: Dims, z0: int):
    """x, y and global z index grids of a [dzl, dy, dx] slab whose first row
    is global row z0, as broadcasting int32 views."""
    dx, dy, dzl = local_dims
    px = torch.arange(dx, dtype=I32, device=dev).view(1, 1, dx)
    py = torch.arange(dy, dtype=I32, device=dev).view(1, dy, 1)
    gidx = (torch.arange(dzl, dtype=I32, device=dev) + z0).view(dzl, 1, 1)
    return px, py, gidx


def flood_z_slabs(sites, first) -> list:
    """PBA phase 1 over equal z-slabs of a site mask ([dzl, dy, dx] bools,
    each on its device, slab k holding global rows k * dzl on): per slab
    (g1, payload) as edt_envelope.flood_z and edt._nearest_scan give them
    on the whole columns, the carries from one gather of the slabs'
    boundary rows onto `first`."""
    dzl, dy, dx = sites[0].shape
    scans = []
    for k, flag in enumerate(sites):
        px, py, gidx = _slab_positions(flag.device, (dx, dy, dzl), k * dzl)
        scans.append(_local_scans(flag, gidx) + (gidx, px, py))
    carry_down, carry_up = _carries([s[0][-1] for s in scans], [s[1][0] for s in scans], first)
    return [_flood_z_slab(down, up, gidx, carry_down[k].to(gidx.device), carry_up[k].to(gidx.device), px, py)
            for k, (down, up, gidx, px, py) in enumerate(scans)]


def l1_z_slabs(grids, first) -> list:
    """ops/edt.l1_pass along z of an int32 grid held as equal [dzl, Y, X]
    z-slabs: each slab's prefix min of d - z and suffix min of d + z (z
    global), the slabs below's and above's carried in as a prefix min over
    the slabs' boundary rows, gathered once onto `first`."""
    dzl = grids[0].shape[0]
    fwd, bwd = [], []
    for k, d in enumerate(grids):
        z = (torch.arange(dzl, dtype=I32, device=d.device) + k * dzl).view(dzl, 1, 1)
        fwd.append((torch.cummin(d - z, dim=0).values, z))
        bwd.append(torch.flip(torch.cummin(torch.flip(d + z, [0]), dim=0).values, [0]))
    lasts = torch.stack([f[-1].to(first) for f, _ in fwd])  # [nz, Y, X]
    firsts = torch.stack([b[0].to(first) for b in bwd])
    none = torch.full_like(lasts[:1], _BIG)
    below = torch.cat([none, torch.cummin(lasts, dim=0).values[:-1]])
    above = torch.cat([torch.flip(torch.cummin(torch.flip(firsts, [0]), dim=0).values, [0])[1:], none])
    out = []
    for k, ((f, z), b) in enumerate(zip(fwd, bwd)):
        dev = f.device
        f = torch.minimum(f, below[k].to(dev)) + z
        b = torch.minimum(b, above[k].to(dev)) - z
        out.append(torch.minimum(f, b))
    return out
