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

from .. import probability
from ..bitops import as_int32, bit_plane, bit_word
from ..constants import meaning_to_probability
from ..utils import to_device

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


def voxelize(points: torch.Tensor, side_length: float, dims: Dims, z_offset: int = 0):
    """Returns (int64 linear idx with out-of-map points sent to N, any_outside).
    With `z_offset` z0 the grid is the z-slab [z0, z0 + dims[2]) of a larger
    one: points are voxelized in the global frame and shifted by z0 as
    integers, so the slab takes exactly its cells of the global decision."""
    coords = map_to_voxels(points, side_length)
    if z_offset:
        coords = shifted(coords, (0, 0, z_offset), -1)
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


def shifted(coords: torch.Tensor, offset, sign: int = 1) -> torch.Tensor:
    """int32 coords + sign * offset, the offset a Python triple (no device copy)."""
    return torch.stack([coords[..., i] + sign * int(offset[i]) for i in range(3)], dim=-1)


def clamp_coords(coords: torch.Tensor, dims: Dims) -> torch.Tensor:
    """int coords clamped into [0, dims) per axis."""
    return torch.stack([coords[..., i].clamp(0, int(dims[i]) - 1) for i in range(3)], dim=-1)


def insert_prob(data: torch.Tensor, points: torch.Tensor, side_length: float, dims: Dims, meaning,
                z_offset: int = 0):
    """ProbVoxelMap point insert: voxel occupancy SET to the meaning's value
    (ProbabilisticVoxel::insert, a store not an update). Returns (new, outside)."""
    idx, outside = voxelize(points, side_length, dims, z_offset)
    out = data.new_empty(data.shape[0] + 1)  # slot N takes the dropped points
    out[:-1] = data
    out.index_fill_(0, idx, meaning_to_probability(meaning))
    return out[:-1], outside


def occupancy_mask(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int8[n] one-hot of hit voxels (duplicates collapse)."""
    hits = torch.zeros(n + 1, dtype=torch.int8, device=idx.device)
    return hits.index_fill_(0, idx, 1)[:n]


def insert_bit(planes: torch.Tensor, points: torch.Tensor, side_length: float, dims: Dims, meaning: int,
               z_offset: int = 0):
    """BitVoxelMap point insert: set bit `meaning` in every hit voxel.

    A one-hot set builds the hit word, then one OR merges it into the target
    plane. Returns (planes, any_outside, occ_delta): occ_delta is uint8[N],
    1 for voxels this insert made !noneButEmpty. Inserting eBVM_FREE (bit 0,
    masked out of noneButEmpty) contributes nothing to it.
    """
    idx, outside = voxelize(points, side_length, dims, z_offset)
    n = planes.shape[1]
    delta = torch.zeros(n + 1, dtype=planes.dtype, device=planes.device)
    delta = delta.index_fill_(0, idx, as_int32(bit_word(meaning)))[:n]
    p = bit_plane(meaning)
    occ_word = delta & as_int32(0xFFFFFFFE) if p == 0 else delta
    out = planes.clone()
    out[p] |= delta
    return out, outside, (occ_word != 0).to(torch.uint8)


def scatter_bits_multi(planes: torch.Tensor, occ: torch.Tensor, idx: torch.Tensor, meanings_np):
    """Fused multi-meaning bit scatter: set bit ``meanings_np[i]`` (a host
    numpy array, one per point) at voxel ``idx[i]`` (N for out-of-map
    points), in one pass: the kernelInsertMetaPointCloud analogue behind the
    batched swept-volume insert and the per-subcloud meta insert.

    Only the planes the meanings touch (K of 8, known on the host) take
    scatter traffic. One int64 key ``(idx*K + slot)*32 + bit`` names each
    (voxel, bit) pair; a sort puts duplicates side by side and only the
    first of each run carries its one-hot word, so an ``index_add_`` of
    distinct powers of two is an OR. Duplicate points therefore cannot
    race (H7), and int64 cannot overflow here, so the reference's two-pass
    branch for large maps has no counterpart. Out-of-map pairs go to a
    spare slot K*N (F2). Nothing syncs with the host.

    Returns (new_planes, new_occ): new_occ is the maintained !noneButEmpty
    summary (None in, None out), with bit 0 (eBVM_FREE) masked out of plane 0
    (BitVector.h:184-198).
    """
    meanings_np = np.asarray(meanings_np, np.int64)
    if meanings_np.size == 0:
        return planes, occ
    touched = np.flatnonzero(np.bincount(meanings_np >> 5, minlength=planes.shape[0])).tolist()
    slot_of_plane = np.full(planes.shape[0], -1, np.int64)
    slot_of_plane[touched] = np.arange(len(touched))
    k = len(touched)
    n = planes.shape[1]
    # per point: slot * 32 + bit, made on the host and uploaded once
    slot_bit = to_device(slot_of_plane[meanings_np >> 5] * 32 + (meanings_np & 31), torch.int64, planes.device)
    key, _ = torch.sort(idx.reshape(-1).to(torch.int64) * (k * 32) + slot_bit)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    vox, slot, bit = key // (k * 32), (key // 32) % k, key % 32
    # the one-hot uint32 word as the int32 holding its bits (bit 31 is -2^31)
    one_hot = torch.where(bit == 31, -(2**31), torch.ones_like(bit) << bit)
    word = torch.where(first, one_hot, 0).to(torch.int32)
    tgt = torch.where(first & (vox < n), slot * n + vox, k * n)
    delta = torch.zeros(k * n + 1, dtype=torch.int32, device=planes.device)
    delta = delta.index_add_(0, tgt, word)[: k * n].reshape(k, n)

    out = planes.clone()
    for p in touched:
        out[p] |= delta[slot_of_plane[p]]
    if occ is None:
        return out, None
    occ_words = delta.clone()
    if slot_of_plane[0] >= 0:
        occ_words[slot_of_plane[0]] &= as_int32(0xFFFFFFFE)
    return out, occ | torch.any(occ_words != 0, dim=0).to(torch.uint8)


def insert_meta_prob(data: torch.Tensor, meta, meanings, side_length: float, dims: Dims, z_offset: int = 0):
    """ProbVoxelMap's per-subcloud meta insert: each point SETS its
    subcloud's meaning's probability, and on a voxel several points hit the
    later point wins. An int64 scatter-max of (rank + 1) * 256 + (value +
    128) picks it, the rank the point's place in the whole cloud (uint32
    amax does not exist in torch, H1; int64 never overflows). With
    `z_offset` z0, `data` is the z-slab [z0, z0 + dims[2]) of a larger grid
    (voxelize's rule), and the ranks stay the whole cloud's."""
    dev = data.device
    values = to_device([meaning_to_probability(m) for m in meanings], torch.int64, dev)
    rank = torch.arange(1, meta.accumulated_size + 1, dtype=torch.int64, device=dev)
    enc = rank * 256 + (values[to_device(meta.cloud_ids, torch.int64, dev)] + 128)
    idx, _ = voxelize(to_device(meta.points, torch.float32, dev), side_length, dims, z_offset)
    won = torch.zeros(data.shape[0] + 1, dtype=torch.int64, device=dev)
    won = won.scatter_reduce_(0, idx, enc, "amax")[:-1]
    new_val = ((won & 255) - 128).to(torch.int8)
    return torch.where(won > 0, new_val, data)


def insert_meta_bits(planes: torch.Tensor, occ, meta, meanings, side_length: float, dims: Dims, z_offset: int = 0):
    """BitVectorVoxelMap's per-subcloud meta insert, the one-pass
    kernelInsertMetaPointCloud analogue: every point sets its subcloud's
    meaning (scatter_bits_multi). Returns (planes, occ). With `z_offset` z0
    the planes are the z-slab [z0, z0 + dims[2]) of a larger grid
    (voxelize's rule)."""
    sizes = [meta.cloud_size(i) for i in range(meta.num_clouds)]
    meanings_np = np.repeat(np.asarray([int(m) for m in meanings], np.int64), sizes)
    idx, _ = voxelize(to_device(meta.points, torch.float32, planes.device), side_length, dims, z_offset)
    return scatter_bits_multi(planes, occ, idx, meanings_np)


def update_occupancy(data: torch.Tensor, points, delta, side_length: float, dims: Dims, z_offset: int = 0):
    """ProbVoxelMap.update_occupancy: the log-odds `delta` added once to
    every voxel a point hits (probability.update_occupancy). With
    `z_offset` z0, `data` is the z-slab [z0, z0 + dims[2]) of a larger grid
    (voxelize's rule)."""
    idx, _ = voxelize(to_device(points, torch.float32, data.device), side_length, dims, z_offset)
    hits = occupancy_mask(idx, data.shape[0])
    return probability.update_occupancy(data, hits.to(torch.int32) * int(delta))


def self_collision_clash(robot_links, side_length: float, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """Pairwise sub-cloud self-collision predicate of every map's
    insert_robot_configuration: True iff two DIFFERENT sub-clouds of the
    MetaPointCloud voxelize into the same cell (the clash test of
    insertMetaPointCloudWithSelfcollisionCheck, ProbVoxelMap.h:61-77).
    Duplicate points within one sub-cloud do not clash. A device bool.
    With `z_offset` z0 only the cells of the z-slab [z0, z0 + dims[2]) of a
    larger grid count (voxelize's rule): the OR over the slabs is the
    whole grid's clash."""
    n = dims[0] * dims[1] * dims[2]
    union = torch.zeros(n, dtype=torch.int8, device=robot_links.device)
    clash = torch.zeros((), dtype=torch.bool, device=robot_links.device)
    for i in range(robot_links.num_clouds):
        idx, _ = voxelize(robot_links.get_cloud(i), side_length, dims, z_offset)
        hits = occupancy_mask(idx, n)
        clash = clash | torch.any((hits > 0) & (union > 0))
        union = torch.maximum(union, hits)
    return clash


def insert_count(data: torch.Tensor, points: torch.Tensor, side_length: float, dims: Dims, z_offset: int = 0):
    """CountingVoxel insert: +1 per inserted point (CountingVoxel.hpp:69-72).

    The reference counter is a raw int8 ``m_count++``: it wraps past 127
    rather than saturating. The sum runs in int32 and the cast back to int8
    truncates mod 256 (127 + 1 -> -128, 255 -> -1), as the list tier's
    wrap-add reduce does (CountingVoxel.hpp:75-80). Returns (new, outside)."""
    idx, outside = voxelize(points, side_length, dims, z_offset)
    counts = torch.zeros(data.shape[0] + 1, dtype=torch.int32, device=data.device)  # slot N: dropped points
    counts[:-1] = data
    counts.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return counts[:-1].to(data.dtype), outside
