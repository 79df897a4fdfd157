"""The exact EDT as min-plus envelope sweeps (the PBA replacement).

Counterpart of gpu_voxels_tpu/ops/edt_envelope.py. The reference's
parallelBanding3D (voxelmap/DistanceVoxelMap.hpp:251-345) is a Z flood
followed by two per-axis lower-envelope phases; each phase here is the
dense min-plus sweep

    out[z, y, x] = min_q ((y - q)^2 + g[z, q, x])       (one pass per axis)

carrying the winning site's packed payload. `envelope_plain` is the spec:
the port of the reference's `_envelope_xla`, a full ascending scan over the
candidate rows with a strict `<`, so on a tie the smallest q wins.
`envelope_pass` runs CUDA kernel K5 (ops/edt_cuda.py, csrc/edt_envelope.cu)
on CUDA tensors and the spec on CPU tensors.

The reference's f32 distance math is exact for its inputs (finite values
stay below 2^24); here every value is int32, exact for any g < MISS:
(y - q)^2 + g < 1023^2 + 2^27. A candidate with g >= MISS is no site, and
an output with no candidate is MISS with payload PBA_UNINITIALISED_PACKED.

K5 needs no coarse ring bounds (its linear-time envelope visits each
position of a line once), so the reference's bound helpers (`_block_any`, `_bound_from_d2`,
`_max_x_blocks`, `_ring_order`) and its measured dead-end knobs (`bound_c`,
`fuse_transposes`, `tx_max`, `transpose_out`) are not ported. The passes
scan the grid in place along the axis given, so no transposes are needed.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..constants import PBA_UNINITIALISED_COORD, PBA_UNINITIALISED_PACKED

Dims = Tuple[int, int, int]
I32 = torch.int32

MISS = 1 << 27  # "no site" squared distance
_INF = 2**31 - 1  # "no candidate yet"; every candidate is below it


def envelope_plain(g2: torch.Tensor, payload: torch.Tensor, axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The spec of K5: the lower envelope along `axis` (1 or 2) of int32
    [dz, dy, dx] grids, by a full scan over the candidate rows in ascending
    order with a strict `<` (ties to the smallest q). Returns (d2, payload),
    int32 [dz, dy, dx]."""
    if axis == 2:
        d, p = envelope_plain(g2.transpose(1, 2), payload.transpose(1, 2), 1)
        return d.transpose(1, 2).contiguous(), p.transpose(1, 2).contiguous()
    if axis != 1:
        raise ValueError(f"the envelope scans axis 1 or 2, got {axis}")
    dz, dy, dx = g2.shape
    yrow = torch.arange(dy, dtype=I32, device=g2.device).view(1, dy, 1)
    bd = torch.full((dz, dy, dx), _INF, dtype=I32, device=g2.device)
    bp = torch.full((dz, dy, dx), PBA_UNINITIALISED_PACKED, dtype=I32, device=g2.device)
    for q in range(dy):
        grow = g2[:, q : q + 1, :]
        dq = yrow - q
        cand = torch.where(grow >= MISS, _INF, dq * dq + grow)
        take = cand < bd
        bd = torch.where(take, cand, bd)
        bp = torch.where(take, payload[:, q : q + 1, :], bp)
    valid = bd < MISS
    return torch.where(valid, bd, MISS), torch.where(valid, bp, PBA_UNINITIALISED_PACKED)


def envelope_pass(g2: torch.Tensor, payload: torch.Tensor, axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower envelope along `axis` (1: Y, 2: X) of int32 [dz, dy, dx] grids:
    g2 with the MISS convention, payload the packed sites. Kernel K5 on
    CUDA tensors, the spec on CPU tensors."""
    from . import edt_cuda

    return edt_cuda.envelope_pass(g2, payload, axis)


def _nearest_scan(flag: torch.Tensor):
    """For a [S, ...] bool tensor: per position s, the squared distance along
    axis 0 to the nearest True (MISS if none) and its index (PBA phase 1,
    kernelPBAphase1FloodZ). The last True at or before s is a cummax of
    where(flag, s, -1), the first at or after s a flipped cummin; on equal
    distance the lower index wins."""
    big = 2**30
    s = flag.shape[0]
    sidx = torch.arange(s, dtype=I32, device=flag.device).view((s,) + (1,) * (flag.ndim - 1))
    down = torch.cummax(torch.where(flag, sidx, -1), dim=0).values
    up = torch.flip(torch.cummin(torch.flip(torch.where(flag, sidx, big), [0]), dim=0).values, [0])
    has_down, has_up = down >= 0, up < big
    down = torch.where(has_down, down, big)
    dd_ = torch.where(has_down, sidx - down, 0)
    du_ = torch.where(has_up, up - sidx, 0)
    dd = torch.where(has_down, dd_ * dd_, MISS)
    du = torch.where(has_up, du_ * du_, MISS)
    take_down = dd <= du
    near = torch.where(take_down, down, up)
    return torch.minimum(dd, du).clamp_(max=MISS), near


def flood_z(packed_flat: torch.Tensor, dims: Dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """PBA phase 1 (kernelPBAphase1FloodZ): per voxel, the squared distance
    along Z to the nearest site of its (y, x) column (MISS if none) and the
    packed payload (x, y, z of that site): the Y pass's input. A site is a
    voxel that holds its own coordinates."""
    dx, dy, dz = dims
    grid = packed_flat.reshape(dz, dy, dx)
    ox, oy, oz = grid & 0x3FF, (grid >> 10) & 0x3FF, grid >> 20
    dev = grid.device
    px = torch.arange(dx, dtype=I32, device=dev).view(1, 1, dx)
    py = torch.arange(dy, dtype=I32, device=dev).view(1, dy, 1)
    pz = torch.arange(dz, dtype=I32, device=dev).view(dz, 1, 1)
    is_site = (ox == px) & (oy == py) & (oz == pz) & (ox != PBA_UNINITIALISED_COORD)
    g1, near_z = _nearest_scan(is_site)
    return g1, px | (py << 10) | (near_z.clamp(0, PBA_UNINITIALISED_COORD) << 20)


def parallel_banding(packed_flat: torch.Tensor, dims: Dims) -> torch.Tensor:
    """Exact 3D EDT: PBA phase 1 as Z scans, phases 2/3 as min-plus envelope
    passes along Y and then X (replaces parallelBanding3D,
    DistanceVoxelMap.hpp:279). Returns packed int32[N]; voxels with no site
    anywhere stay uninitialised."""
    g1, pay1 = flood_z(packed_flat, dims)
    d2, pay2 = envelope_pass(g1, pay1, 1)
    d3, pay3 = envelope_pass(d2, pay2, 2)
    return torch.where(d3 >= MISS, PBA_UNINITIALISED_PACKED, pay3).reshape(-1)
