"""Point -> voxel scatter pipelines for dense maps.

Counterpart of gpu_voxels_tpu/ops/insert.py. Points are voxelized with the
reference's floor(p / side_length) rule (VoxelMapOperations.h:123-133) as a
multiply by one host-computed f32 reciprocal, mapped to linear indices
z*dimx*dimy + y*dimx + x (VoxelMapOperations.h:44-74) and scattered
deterministically: a same-value set for probabilistic voxels, a one-hot set
plus OR for bit voxels.

Out-of-map points get index N, as in the reference. torch scatters raise on
an out-of-range index instead of dropping it, so every scatter here writes
into N + 1 slots and returns the first N (slot N collects the dropped
points). Nothing syncs with the host: the out-of-map flag stays a device
bool.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..bitops import as_int32, bit_plane, bit_word
from ..constants import meaning_to_probability
from ..utils import ROBOTS, SENSING, not_ported

Dims = Tuple[int, int, int]


def floor_to_int32(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as int32, clamped to +-2^30, NaN -> 0: the reference's
    saturating XLA cast. The clamp keeps far-out values out of range (a
    float -> int32 cast past int32 is undefined in torch)."""
    v = torch.floor(x).clamp_(-(2.0**30), 2.0**30)
    return torch.nan_to_num_(v, nan=0.0).to(torch.int32)


def map_to_voxels(points: torch.Tensor, side_length: float) -> torch.Tensor:
    """float coords -> int32 voxel coords (VoxelMapOperations.h:123-133).

    Multiplies by the f32 reciprocal of the side length, as the reference
    does, so both packages put a boundary point in the same cell. A NaN
    coordinate becomes 0, as in the reference.
    """
    return floor_to_int32(points * float(np.float32(1.0 / float(side_length))))


def linear_index(coords: torch.Tensor, dims: Dims) -> torch.Tensor:
    """Voxel coords -> int64 linear index (VoxelMapOperations.h:44-52)."""
    dx, dy, _ = dims
    c = coords.to(torch.int64)
    return c[..., 2] * (dx * dy) + c[..., 1] * dx + c[..., 0]


def linear_offset(offset: Tuple[int, int, int], dims: Dims) -> int:
    """Signed voxel offset -> signed linear offset (getVoxelIndexSigned)."""
    dx, dy, _ = dims
    return int(offset[2]) * dx * dy + int(offset[1]) * dx + int(offset[0])


def voxelize(points: torch.Tensor, side_length: float, dims: Dims):
    """Returns (int64 linear idx with out-of-map points sent to N, any_outside)."""
    coords = map_to_voxels(points, side_length)
    valid = in_map(coords, dims)
    n = dims[0] * dims[1] * dims[2]
    idx = torch.where(valid, linear_index(coords, dims), n)
    return idx, ~torch.all(valid)


def in_map(coords: torch.Tensor, dims: Dims) -> torch.Tensor:
    """bool[...]: integer voxel coords inside [0, dims) on every axis (the
    bounds stay Python ints: a device tensor made from them would sync)."""
    inside = torch.all(coords >= 0, dim=-1)
    for axis, d in enumerate(dims):
        inside &= coords[..., axis] < d
    return inside


def insert_prob(data: torch.Tensor, points: torch.Tensor, side_length: float, dims: Dims, meaning):
    """ProbVoxelMap point insert: voxel occupancy SET to the meaning's value
    (ProbabilisticVoxel::insert, a store not an update). Returns (new, outside)."""
    idx, outside = voxelize(points, side_length, dims)
    out = data.new_empty(data.shape[0] + 1)  # slot N takes the dropped points
    out[:-1] = data
    out.index_fill_(0, idx, meaning_to_probability(meaning))
    return out[:-1], outside


def occupancy_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int8[n] one-hot of hit voxels (duplicates collapse)."""
    hits = torch.zeros(n + 1, dtype=torch.int8, device=idx.device)
    return hits.index_fill_(0, idx, 1)[:n]


def insert_bit(planes: torch.Tensor, points: torch.Tensor, side_length: float, dims: Dims, meaning: int):
    """BitVoxelMap point insert: set bit `meaning` in every hit voxel.

    A one-hot set builds the hit word, then one OR merges it into the target
    plane. Returns (planes, any_outside, occ_delta): occ_delta is uint8[N],
    1 for voxels this insert made !noneButEmpty. Inserting eBVM_FREE (bit 0,
    masked out of noneButEmpty) contributes nothing to it.
    """
    idx, outside = voxelize(points, side_length, dims)
    n = planes.shape[1]
    delta = torch.zeros(n + 1, dtype=planes.dtype, device=planes.device)
    delta = delta.index_fill_(0, idx, as_int32(bit_word(meaning)))[:n]
    p = bit_plane(meaning)
    occ_word = delta & as_int32(0xFFFFFFFE) if p == 0 else delta
    out = planes.clone()
    out[p] |= delta
    return out, outside, (occ_word != 0).to(torch.uint8)


scatter_bits_multi = not_ported("scatter_bits_multi", ROBOTS)
self_collision_clash = not_ported("self_collision_clash", ROBOTS)
insert_count = not_ported("insert_count", SENSING)
