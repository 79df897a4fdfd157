"""Sparse voxel lists (equivalents of voxellist/TemplateVoxelList + subclasses).

Counterpart of gpu_voxels_tpu/maps/voxellist.py. The reference keeps three
parallel thrust::device_vectors (id, coord, voxel) sorted and unique after
every insert (TemplateVoxelList.hpp:142-209). Here a list is a frozen
fixed-capacity value, in the style of the dense maps:

    keys:    int64[C]   sorted voxel ids; the mode's EMPTY key pads the tail
    payload  int32[8, C] bit planes (bit), int8[C] log-odds (prob) or
             int8[C] counters (count)
    count:   0-d int64  number of live entries, on the list's device

One int64 key replaces the reference's (ids_hi, ids) uint32 pair, which it
carries only because JAX runs with x64 off (H1): in linear mode the key is
the uint32 linear id; in morton mode it is ``hi << 30 | lo``, the uint64 the
reference writes to disk, whose order equals the pair's lexicographic order.
The linear EMPTY key is the reference's EMPTY_ID 0xFFFFFFFF: an
out-of-range point whose wrapped id equals it is dropped, as there. The
morton EMPTY key, 2^62 - 1, sorts after every 60-bit code; `split_keys`
maps it to the reference's (EMPTY, EMPTY) pair. So torch.sort(stable=True)
and torch.searchsorted replace the reference's two-pass argsort and its
branchless pair search, on the card and on the CPU alike.

make_unique (sort_by_key + reversed inclusive_scan(Merge) + unique_by_key)
becomes a stable sort, a segmented fold of each run of equal keys and a
compaction. The folds are the reference's merge semantics per kind: OR
for bits; the wrapping int8 add for counters (CountingVoxel.hpp:75-80,
summed in int64 and wrapped once); for log-odds the SEQUENTIAL saturating
add of the reference's reversed scan (ProbabilisticVoxel.hpp:51-57), whose
intermediate clamps are observable, as a log-step (Hillis-Steele) scan over
composed clamp maps g(x) = clamp(x + a, lo, hi). The compaction scatters
each run's last entry to its rank among the live runs: the destinations are
unique, so no duplicate-index scatter picks a winner (H7).

Inserts grow the capacity by the points inserted, as the reference's thrust
vectors do; ``grow=False`` keeps it and, on overflow, keeps the smallest
ids with ``count`` saturated at the capacity. Points are not bounds-checked
(VoxelListOperations.hpp:41-59): linear ids wrap like uint32.

Collides run in plain torch (searchsorted, gathers, reductions), except
`collide_with_bitcheck` at sv_offset 0 and margins up to 24, which feeds
the matched payloads to CUDA kernel K4 (ops/collide_cuda). Counts are 0-d
int64 tensors on the list's device; nothing syncs with the host except
`shrink_to_fit`, `screendump` and the disk writer, which read the count.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from .. import bitops
from ..constants import (MAX_PROBABILITY, MIN_PROBABILITY, NUM_BIT_PLANES, UNKNOWN_PROBABILITY, BitVoxelMeaning,
                         MapType, float_to_probability, meaning_to_probability)
from ..morton import LO30_MASK, U32_MASK, inv_morton_code60, morton_key60
from ..ops import collide as collide_ops
from ..ops import collide_cuda
from ..ops.insert import linear_offset, map_to_voxels, shifted
from ..utils import resolve_device, to_device
from ..utils.io import DiskIO

Dims = Tuple[int, int, int]

EMPTY_ID = 0xFFFFFFFF  # the reference's EMPTY_ID, the linear EMPTY key
EMPTY_MORTON = (EMPTY_ID << 30) | EMPTY_ID  # 2^62 - 1: (EMPTY, EMPTY) as hi << 30 | lo
_COARSE_EMPTY = (1 << 63) - 1  # an invalid coarse cell: after every 60-bit coarse key

KIND_BIT = "bit"
KIND_PROB = "prob"
KIND_COUNT = "count"

_MAP_TYPES = {
    (KIND_BIT, "linear"): MapType.MT_BITVECTOR_VOXELLIST,
    (KIND_BIT, "morton"): MapType.MT_BITVECTOR_MORTON_VOXELLIST,
    (KIND_PROB, "linear"): MapType.MT_PROBAB_VOXELLIST,
    (KIND_PROB, "morton"): MapType.MT_PROBAB_MORTON_VOXELLIST,
    (KIND_COUNT, "linear"): MapType.MT_COUNTING_VOXELLIST,
}


def empty_key(id_mode: str) -> int:
    return EMPTY_MORTON if id_mode == "morton" else EMPTY_ID


def split_keys(keys: torch.Tensor, id_mode: str):
    """int64 keys -> the reference's (ids_hi, ids) uint32 words, as int64:
    (0, id) in linear mode, where EMPTY pads with (EMPTY, EMPTY); (hi, lo)
    in morton mode."""
    if id_mode == "morton":
        empty = keys == EMPTY_MORTON
        return torch.where(empty, EMPTY_ID, keys >> 30), torch.where(empty, EMPTY_ID, keys & LO30_MASK)
    return torch.where(keys == EMPTY_ID, EMPTY_ID, 0), keys


def join_keys(ids_hi: torch.Tensor, ids: torch.Tensor, id_mode: str) -> torch.Tensor:
    """Inverse of split_keys."""
    if id_mode == "morton":
        empty = (ids_hi == EMPTY_ID) & (ids == EMPTY_ID)
        return torch.where(empty, EMPTY_MORTON, (ids_hi << 30) | ids)
    return ids


def _payload_init(kind: str, capacity: int, device) -> torch.Tensor:
    if kind == KIND_BIT:
        return bitops.zeros((capacity,), device=device)
    if kind == KIND_PROB:
        return torch.full((capacity,), UNKNOWN_PROBABILITY, dtype=torch.int8, device=device)
    if kind == KIND_COUNT:
        return torch.zeros((capacity,), dtype=torch.int8, device=device)
    raise ValueError(kind)


def _gather_payload(kind: str, payload: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    return payload[:, index] if kind == KIND_BIT else payload[index]


def _mul_u32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2^32 for x in [0, 2^32) held in int64, without an int64
    overflow: k is split into 16-bit halves."""
    k &= U32_MASK
    return (x * (k & 0xFFFF) + (((x * (k >> 16)) & 0xFFFF) << 16)) & U32_MASK


def _linear_ids(coords: torch.Tensor, dims: Dims) -> torch.Tensor:
    """Linear ids of int coordinates in uint32 arithmetic (wrapping for
    out-of-range points, like the reference's uint32 cast and products)."""
    dx, dy, _ = dims
    c = coords.to(torch.int64) & U32_MASK
    return (_mul_u32(c[..., 2], dx * dy) + _mul_u32(c[..., 1], dx) + c[..., 0]) & U32_MASK


def _run_starts(idx: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per position, the index of the first entry of its run."""
    return torch.cummax(torch.where(starts, idx, -1), dim=0).values


def segmented_or(starts: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented OR scan of int32[8, C] along C, restarting at each
    run start: log-step (Hillis-Steele) passes. At a run's last entry it is
    the OR of the run."""
    flags, v = starts, planes
    c, d = planes.shape[1], 1
    while d < c:
        v = torch.cat([v[:, :d], torch.where(flags[None, d:], v[:, d:], v[:, d:] | v[:, :-d])], dim=1)
        flags = torch.cat([flags[:d], flags[d:] | flags[:-d]])
        d *= 2
    return v


def segmented_wrapping_sum(starts: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per position, the int8-wrapping sum of its run up to it (inclusive):
    an int64 prefix sum less the sum before the run start, wrapped once."""
    idx = torch.arange(values.shape[0], device=values.device)
    cs = torch.cumsum(values.to(torch.int64), dim=0)
    first = _run_starts(idx, starts)
    before = torch.where(first > 0, cs[(first - 1).clamp(min=0)], 0)
    return (((cs - before + 128) & 255) - 128).to(torch.int8)


def sequential_saturating_fold(starts: torch.Tensor, is_last: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per position, the reference's reversed saturating fold of its run
    (TemplateVoxelList.hpp:178-186): seeded at the run's last entry, each
    earlier entry added with a clamp to [-127, 127] at every step
    (ProbabilisticVoxel.hpp:51-57). Each entry is the clamp map
    g(x) = clamp(x + a, lo, hi); a run's last entry is the constant map of
    its value, which seeds the fold and cuts the scan at the run's end. A
    reverse log-step scan composes the maps; at a run's start it holds the
    whole run's fold (lo == hi), which is routed to every entry of the run."""
    v = values.to(torch.int32)
    a = torch.where(is_last, 0, v)
    lo = torch.where(is_last, v, MIN_PROBABILITY)
    hi = torch.where(is_last, v, MAX_PROBABILITY)
    c, d = v.shape[0], 1
    while d < c:
        # element i covers [i, i + d); compose it after element i + d's maps:
        # g o f with f = (a, lo, hi)[i + d] applied first, g = [i]
        fa, fl, fh = a[d:], lo[d:], hi[d:]
        ga, gl, gh = a[:-d], lo[:-d], hi[:-d]
        # |a| > 255 already saturates every x in [-128, 127]; the clamp keeps
        # long runs inside int32
        a = torch.cat([(fa + ga).clamp(-512, 512), a[c - d:]])
        lo = torch.cat([torch.minimum(torch.maximum(fl + ga, gl), gh), lo[c - d:]])
        hi = torch.cat([torch.minimum(torch.maximum(fh + ga, gl), gh), hi[c - d:]])
        d *= 2
    idx = torch.arange(c, device=v.device)
    return lo[_run_starts(idx, starts)].to(torch.int8)


def compaction_destinations(keep: torch.Tensor) -> torch.Tensor:
    """Where each kept entry goes: its rank among the kept entries; the
    others go to slot C, one past the end, which the scatter then drops."""
    pos = torch.cumsum(keep, dim=0) - 1
    return torch.where(keep, pos, keep.shape[0])


def _compact_into(kind: str, keep: torch.Tensor, keys: torch.Tensor, payload: torch.Tensor, empty: int):
    """Scatter the kept entries to the front of C + 1 slots, keep the first C."""
    c = keys.shape[0]
    dest = compaction_destinations(keep)
    new_keys = torch.full((c + 1,), empty, dtype=torch.int64, device=keys.device).scatter_(0, dest, keys)[:c]
    init = _payload_init(kind, c + 1, keys.device)
    if kind == KIND_BIT:
        # contiguous planes: K4 takes them as they are
        new_payload = init.scatter_(1, dest.expand(NUM_BIT_PLANES, c), payload)[:, :c].contiguous()
    else:
        new_payload = init.scatter_(0, dest, payload)[:c]
    return new_keys, new_payload, keep.sum(dtype=torch.int64)


@dataclass(frozen=True, eq=False)
class VoxelList(DiskIO):
    keys: torch.Tensor
    payload: torch.Tensor
    count: torch.Tensor
    dims: Dims
    side_length: float
    kind: str
    id_mode: str = "linear"
    map_type: MapType = MapType.MT_BITVECTOR_VOXELLIST

    # -- construction ---------------------------------------------------------
    @staticmethod
    def create(
        dims: Dims,
        side_length: float = 1.0,
        kind: str = KIND_BIT,
        capacity: int = 0,
        id_mode: str = "linear",
        map_type: Optional[MapType] = None,
        device=None,
    ) -> "VoxelList":
        if id_mode == "linear" and int(dims[0]) * int(dims[1]) * int(dims[2]) > 2**32:
            # the reference's MapVoxelID is uint32 too: linear ids past 2^32
            # voxels would wrap; the 60-bit Morton mode covers that scale
            raise ValueError(
                f"linear voxel-list ids are uint32; dims {tuple(dims)} span "
                f"{int(dims[0]) * int(dims[1]) * int(dims[2])} voxels — use "
                "id_mode='morton' (bit_vector_morton_voxel_list) at this scale"
            )
        if map_type is None:
            map_type = _MAP_TYPES[(kind, id_mode)]
        device = resolve_device(device)
        return VoxelList(
            keys=torch.full((capacity,), empty_key(id_mode), dtype=torch.int64, device=device),
            payload=_payload_init(kind, capacity, device),
            count=torch.zeros((), dtype=torch.int64, device=device),
            dims=tuple(int(d) for d in dims),
            side_length=float(side_length),
            kind=kind,
            id_mode=id_mode,
            map_type=map_type,
        )

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device

    @property
    def empty(self) -> int:
        """This list's EMPTY key."""
        return empty_key(self.id_mode)

    def to(self, device) -> "VoxelList":
        """The same list on `device`."""
        device = resolve_device(device)
        return replace(self, keys=self.keys.to(device), payload=self.payload.to(device), count=self.count.to(device))

    # -- id <-> coordinate maps ----------------------------------------------
    def _ids_from_coords(self, coords: torch.Tensor) -> torch.Tensor:
        """int64 keys of int coordinates in this list's id mode."""
        if self.id_mode == "morton":
            return morton_key60(coords[..., 0], coords[..., 1], coords[..., 2])
        return _linear_ids(coords, self.dims)

    def coords_from_ids(self, keys: torch.Tensor) -> torch.Tensor:
        """int32[..., 3] coordinates of keys of this list's mode (padding
        decodes as the reference decodes its EMPTY ids)."""
        keys = keys.to(torch.int64)
        if self.id_mode == "morton":
            hi, lo = split_keys(keys, "morton")
            x, y, z = inv_morton_code60(torch.where(hi == EMPTY_ID, 0, hi), lo)
        else:
            dx, dy, _ = self.dims
            z = keys // (dx * dy)
            rem = keys - z * (dx * dy)
            y = rem // dx
            x = rem - y * dx
        return torch.stack([x, y, z], dim=-1).to(torch.int32)

    def entry_coords(self) -> torch.Tensor:
        """int32[C, 3] coordinates of the stored entries."""
        return self.coords_from_ids(self.keys)

    # -- make_unique ----------------------------------------------------------
    def _make_unique(self, keys: torch.Tensor, payload: torch.Tensor):
        """sort_by_key + unique_by_key(reduce_op) + compaction, fixed shape.
        Returns (keys, payload, count)."""
        keys, order = torch.sort(keys, stable=True)
        payload = _gather_payload(self.kind, payload, order)
        diff = keys[1:] != keys[:-1]
        ones = torch.ones((1,), dtype=torch.bool, device=keys.device)
        starts = torch.cat([ones, diff])
        is_last = torch.cat([diff, ones])
        if self.kind == KIND_BIT:
            merged = segmented_or(starts, payload)
        elif self.kind == KIND_PROB:
            merged = sequential_saturating_fold(starts, is_last, payload)
        elif self.kind == KIND_COUNT:
            merged = segmented_wrapping_sum(starts, payload)
        else:
            raise ValueError(self.kind)
        # the last entry of each run holds its merged payload
        return _compact_into(self.kind, is_last & (keys != self.empty), keys, merged, self.empty)

    def _with_appended(self, keys: torch.Tensor, payload: torch.Tensor, grow: bool) -> "VoxelList":
        u_keys, u_payload, count = self._make_unique(
            torch.cat([self.keys, keys]), torch.cat([self.payload, payload], dim=-1)
        )
        out = replace(self, keys=u_keys, payload=u_payload, count=count)
        return out if grow else out.with_capacity(self.capacity)

    # -- insertion --------------------------------------------------------
    def _point_keys(self, points) -> torch.Tensor:
        pts = to_device(points, torch.float32, self.device).reshape(-1, 3)
        return self._ids_from_coords(map_to_voxels(pts, self.side_length))

    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED, grow: bool = True) -> "VoxelList":
        """Append + make_unique (TemplateVoxelList.hpp:142-209).

        ``grow=True`` grows the capacity by len(points), like the
        reference's thrust vectors; ``grow=False`` keeps it, and when the
        deduplicated content exceeds it the largest ids are dropped and
        ``count`` saturates at the capacity."""
        keys = self._point_keys(points)
        m = keys.shape[0]
        if self.kind == KIND_BIT:
            payload = bitops.zeros((m,), device=self.device)
            payload[bitops.bit_plane(int(meaning))] = bitops.as_int32(bitops.bit_word(int(meaning)))
        elif self.kind == KIND_PROB:
            payload = torch.full((m,), meaning_to_probability(meaning), dtype=torch.int8, device=self.device)
        else:
            payload = torch.ones((m,), dtype=torch.int8, device=self.device)
        return self._with_appended(keys, payload, grow)

    def insert_coordinates(self, coords, meaning=BitVoxelMeaning.eBVM_OCCUPIED, grow: bool = True) -> "VoxelList":
        pts = (to_device(coords, torch.float32, self.device) + 0.5) * self.side_length
        return self.insert_point_cloud(pts, meaning, grow=grow)

    def insert_meta_point_cloud(self, meta, meanings=None, grow: bool = True) -> "VoxelList":
        if meanings is None:
            return self.insert_point_cloud(meta.points, grow=grow)
        if self.kind == KIND_BIT:
            # one pass over all sub-clouds (kernelInsertMetaPointCloudVoxelList
            # with per-subcloud meanings)
            sizes = [meta.cloud_size(i) for i in range(meta.num_clouds)]
            per_point = np.repeat(np.asarray([int(m) for m in meanings], np.int64), sizes)
            return self.insert_point_cloud_with_meanings(meta.points, per_point, grow=grow)
        lst = self
        for i, meaning in enumerate(meanings):
            lst = lst.insert_point_cloud(meta.get_cloud(i), meaning, grow=grow)
        return lst

    def insert_point_cloud_with_meanings(self, points, meanings, grow: bool = True) -> "VoxelList":
        """Per-point-meaning bit insert in one pass: the batched swept-volume
        insert for lists (the reference inserts a robot cloud per trajectory
        step with meaning eBVM_SWEPT_VOLUME_START + step in a host loop,
        gvl_ompl_planner_helper.cpp:102-137). Points sharing a voxel OR their
        meaning bits. Bit lists only."""
        if self.kind != KIND_BIT:
            raise TypeError("per-point meanings require a bit-vector voxel list")
        keys = self._point_keys(points)
        m = keys.shape[0]
        meanings = to_device(meanings, torch.int64, self.device).reshape(-1)
        word = torch.ones_like(meanings) << (meanings & 31)
        word = torch.where(word >= 2**31, word - 2**32, word).to(torch.int32)
        payload = bitops.zeros((m,), device=self.device).scatter_(0, (meanings >> 5)[None, :], word[None, :])
        return self._with_appended(keys, payload, grow)

    def with_capacity(self, capacity: int) -> "VoxelList":
        """Re-fix the capacity (truncating the sorted tail, or padding)."""
        c = self.capacity
        if capacity == c:
            return self
        if capacity > c:
            pad = torch.full((capacity - c,), self.empty, dtype=torch.int64, device=self.device)
            payload = torch.cat([self.payload, _payload_init(self.kind, capacity - c, self.device)], dim=-1)
            return replace(self, keys=torch.cat([self.keys, pad]), payload=payload)
        return replace(self, keys=self.keys[:capacity], payload=self.payload[..., :capacity].contiguous(),
                       count=self.count.clamp(max=capacity))

    # -- membership / collision -------------------------------------------
    def _find_positions(self, other: "VoxelList", queries: torch.Tensor):
        """Lower-bound positions in other and the found mask of int64 keys in
        other's key domain (thrust::binary_search)."""
        if other.capacity == 0:
            return (torch.zeros(queries.shape, dtype=torch.int64, device=queries.device),
                    torch.zeros(queries.shape, dtype=torch.bool, device=queries.device))
        pos = torch.searchsorted(other.keys, queries).clamp_(0, other.capacity - 1)
        return pos, (other.keys[pos] == queries) & (queries != other.empty)

    def _shifted_keys(self, offset, dims: Dims) -> torch.Tensor:
        """My keys with the signed linear offset added (uint32 wrap); padding
        stays EMPTY, as the reference's EMPTY high word keeps it unmatched."""
        if self.id_mode == "morton":
            raise ValueError("offset not supported for morton lists")
        shift = linear_offset(offset, dims) & U32_MASK
        return torch.where(self.keys == EMPTY_ID, EMPTY_ID, (self.keys + shift) & U32_MASK)

    def _membership(self, other: "VoxelList", offset=(0, 0, 0)) -> torch.Tensor:
        """bool[C]: my id present in other (thrust::binary_search stencil)."""
        queries = self.keys if tuple(offset) == (0, 0, 0) else self._shifted_keys(offset, self.dims)
        return self._find_positions(other, queries)[1]

    def _collide_voxellist(self, other: "VoxelList", offset=(0, 0, 0)) -> torch.Tensor:
        return self._membership(other, offset).sum(dtype=torch.int64)

    def _collide_voxellist_cross_mode(self, other: "VoxelList", offset=(0, 0, 0)) -> torch.Tensor:
        """Linear-id list x morton-id list (either direction): my entry
        coordinates re-encoded in the OTHER list's key domain (the
        reference's two list types have no cross overload,
        common_defines.h:175-182). Coordinates outside the target domain do
        not alias: they are dropped before the search."""
        coords = self.entry_coords()
        if tuple(offset) != (0, 0, 0):
            coords = shifted(coords, offset)
        bound = (1 << 20,) * 3 if other.id_mode == "morton" else other.dims
        live = (self.keys != self.empty) & torch.all(coords >= 0, dim=-1)
        for axis, b in enumerate(bound):
            live &= coords[..., axis] < b
        queries = torch.where(live, other._ids_from_coords(coords), other.empty)
        return self._find_positions(other, queries)[1].sum(dtype=torch.int64)

    def collide_with(self, other, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith dispatch: list x list counts shared voxel ids
        (collideVoxellists, TemplateVoxelList.hpp:228-275); list x dense map
        is the per-entry lookup collide (kernelCollideWithVoxelMap); list x
        octree forwards to the octree's probe at my coords + offset
        (CollidableWithBitVectorOctree, CollisionInterfaces.h:231-243: the
        reference implements it only inside GvlNTree; a sharded pyramid is
        an octree too)."""
        from ..parallel.shard_value import operand_class
        from .hierarchical import _is_sharded_pyramid, _PyramidQueries
        from .paged import PagedHierarchicalMap
        from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

        if isinstance(other, (_PyramidQueries, PagedHierarchicalMap)) or _is_sharded_pyramid(other):
            return other.collide_with(self, offset=offset)
        if issubclass(operand_class(other), (BitVectorVoxelMap, ProbVoxelMap)):
            return self.collide_with_dense(other, offset=offset)
        if isinstance(other, VoxelList):
            if other.id_mode != self.id_mode:
                return self._collide_voxellist_cross_mode(other, offset)
            return self._collide_voxellist(other, offset)
        raise TypeError(f"cannot collide a VoxelList with {type(other).__name__}")

    def _coarse_keys(self, coords: torch.Tensor, level: int, valid: torch.Tensor) -> torch.Tensor:
        """int64 sort keys of 2^level-coarse cells (20 bits per axis, the
        morton60 coordinate domain): the reference's (hi, lo) pair
        (lo = cy[0:12] << 20 | cx, hi = cz << 8 | cy[12:20]) as hi << 32 | lo;
        invalid cells sort last."""
        c = coords.to(torch.int32) >> int(level)
        in_range = valid & torch.all((c >= 0) & (c < (1 << 20)), dim=-1)
        c = c.to(torch.int64)
        cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
        key = ((cz << 8 | cy >> 12) << 32) | ((cy & 0xFFF) << 20) | cx
        return torch.where(in_range, key, _COARSE_EMPTY)

    def collide_with_resolution(self, other, coll_threshold: float = 1.0, resolution_level: int = 0,
                                offset=(0, 0, 0)) -> torch.Tensor:
        """collideWithResolution for lists (CollisionInterfaces.h:160-186):
        the number of DISTINCT 2^level-coarse cells occupied by both sides,
        against another VoxelList or a dense map. `offset` is in fine
        voxels and translates my occupied set by -offset (left[i+off] vs
        right[i])."""
        lvl = int(resolution_level)
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.capacity == 0:
            return zero
        coords_a = shifted(self.entry_coords(), offset, -1)
        valid_a = torch.arange(self.capacity, device=self.device) < self.count
        keys_a, order = torch.sort(self._coarse_keys(coords_a, lvl, valid_a), stable=True)
        ones = torch.ones((1,), dtype=torch.bool, device=self.device)
        first = torch.cat([ones, keys_a[1:] != keys_a[:-1]]) & (keys_a != _COARSE_EMPTY)

        from ..parallel.shard_value import operand_class, operand_slabs
        from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

        if isinstance(other, VoxelList):
            if other.capacity == 0:
                return zero
            valid_b = torch.arange(other.capacity, device=other.device) < other.count
            keys_b, _ = torch.sort(other._coarse_keys(other.entry_coords(), lvl, valid_b))
            pos = torch.searchsorted(keys_b, keys_a).clamp_(0, other.capacity - 1)
            return (first & (keys_b[pos] == keys_a)).sum(dtype=torch.int64)
        cls = operand_class(other)
        if not issubclass(cls, (ProbVoxelMap, BitVectorVoxelMap)):
            raise TypeError(f"cannot collide VoxelList with {cls}")
        sc = 1 << lvl
        dx, dy, dz = other.dims
        pz, py, px = -(-dz // sc), -(-dy // sc), -(-dx // sc)
        c = (coords_a >> lvl).to(torch.int64)
        in_map = valid_a & torch.all(c >= 0, dim=-1) & (c[:, 0] < px) & (c[:, 1] < py) & (c[:, 2] < pz)
        hit = torch.zeros_like(in_map)
        # the map OR-pooled slab by slab (one slab for a plain map): a slab's
        # first cube padded below it with the rows of the slabs before, so a
        # cube a slab boundary cuts is the OR of the slabs' partial cubes
        for slab, z0, dev in operand_slabs(other):
            if cls is ProbVoxelMap:
                mask = collide_ops.prob_occupied(slab.data, float_to_probability(coll_threshold))
            else:
                mask = slab.occupied_mask()
            m3 = mask.reshape(slab.dims[2], dy, dx)
            if z0 % sc:
                m3 = torch.cat([torch.zeros((z0 % sc, dy, dx), dtype=torch.bool, device=dev), m3])
            pooled = collide_ops.or_pool(m3, lvl)
            r0, nr = z0 // sc, pooled.shape[0]
            own = in_map & (c[:, 2] >= r0) & (c[:, 2] < r0 + nr)
            flat = (((c[:, 2] - r0).clamp(0, nr - 1) * py + c[:, 1].clamp(0, py - 1)) * px
                    + c[:, 0].clamp(0, px - 1))
            hit |= own & pooled.reshape(-1)[flat.to(dev)].to(hit.device)
        # distinct coarse cells: the dedup mask of the sorted keys
        return (first & hit[order]).sum(dtype=torch.int64)

    def _require_same_id_mode(self, other, op: str) -> None:
        """Raw-id comparisons across linear / morton modes would match
        nothing: refuse (plain collide_with re-encodes coordinates instead)."""
        if isinstance(other, VoxelList) and other.id_mode != self.id_mode:
            raise TypeError(
                f"{op}: id modes differ (self={self.id_mode!r}, other={other.id_mode!r}); convert one list first"
            )

    def find_matching(self, other: "VoxelList"):
        """findMatchingVoxels (BitVoxelList.hpp:397-476): (mask bool[C], the
        other list's payload gathered to my entries)."""
        self._require_same_id_mode(other, "find_matching")
        pos, mask = self._find_positions(other, self.keys)
        if other.capacity == 0:
            return mask, _payload_init(other.kind, self.capacity, self.device)
        return mask, _gather_payload(other.kind, other.payload, pos)

    def _require_bits(self, other) -> None:
        if self.kind != KIND_BIT or other.kind != KIND_BIT:
            raise TypeError(f"needs two bit-vector voxel lists, got {self.kind} and {other.kind}")

    def collide_with_types(self, other: "VoxelList"):
        """collideWithTypes (BitVoxelList.hpp:102-126): AND matched bit
        vectors, OR-reduce into the types in collision. Returns (count,
        meanings int32[8])."""
        self._require_bits(other)
        mask, otherp = self.find_matching(other)
        merged = torch.where(mask[None, :], self.payload | otherp, 0)
        return mask.sum(dtype=torch.int64), bitops.or_reduce_words(merged)

    def collide_with_bitcheck(self, other: "VoxelList", margin: int = 0, sv_offset: int = 0) -> torch.Tensor:
        """collideWithBitcheck (BitVoxelList.hpp:268-297): same-bit collision
        with a +-margin window over matched voxels. At sv_offset 0 and
        margins up to 24 my payload, the gathered partner payload and the
        match mask go to kernel K4 (count only), which counts an unmatched
        column as all-zero (an all-zero window never hits) and reads planes
        for the matched columns only; the rest of the domain runs the plain
        full-domain check."""
        self._require_bits(other)
        mask, otherp = self.find_matching(other)
        if self.capacity == 0 or other.capacity == 0:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        if sv_offset == 0 and margin <= 24:
            count, _, _ = collide_cuda.collide_types_bit_bit(self.payload.contiguous(), otherp, margin, False,
                                                             b_valid=mask)
            return count
        if sv_offset == 0:
            hit, _ = bitops.bit_margin_collision_check_packed(self.payload, otherp, margin)
        else:
            hit, _ = bitops.bit_margin_collision_check_packed_full(
                self.payload, otherp, torch.zeros_like(self.payload), margin, sv_offset
            )
        return (hit & mask).sum(dtype=torch.int64)

    def collide_counting_per_meaning(self, other: "VoxelList") -> torch.Tensor:
        """collideCountingPerMeaning (BitVoxelList.hpp:301-395): int64[256]
        collision counts per meaning."""
        self._require_bits(other)
        mask, otherp = self.find_matching(other)
        anded = torch.where(mask[None, :], self.payload & otherp, 0)
        per_bit = torch.stack([((anded >> b) & 1).sum(dim=1, dtype=torch.int64) for b in range(32)], dim=1)
        return per_bit.reshape(-1)  # plane-major: meaning 32 * p + b

    def _linear_ids_for(self, dense_dims: Dims) -> torch.Tensor:
        """Entry ids as linear indices of a dense map with dense_dims."""
        if self.id_mode == "morton":
            return _linear_ids(self.entry_coords(), dense_dims)
        return self.keys

    def _dense_lookup(self, dense_map, offset):
        """(valid bool[C], idx int64[C]): my entries' voxels in the dense map."""
        lin = self._linear_ids_for(dense_map.dims)
        if tuple(offset) != (0, 0, 0):
            lin = (lin + (linear_offset(offset, dense_map.dims) & U32_MASK)) & U32_MASK
        valid = (lin < dense_map.voxelmap_size) & (self.keys != self.empty)
        return valid, torch.where(valid, lin, 0)

    def _dense_occupied(self, dense_map, idx: torch.Tensor, coll_threshold: float) -> torch.Tensor:
        """The dense map's occupancy at flat indices `idx`, a sharded map's
        each on the slab that owns it (shard_value.take_from_slabs)."""
        from ..parallel.shard_value import operand_class, take_from_slabs
        from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

        cls = operand_class(dense_map)
        if not issubclass(cls, (ProbVoxelMap, BitVectorVoxelMap)):
            raise TypeError(cls)

        def occupied(m, i):
            if isinstance(m, ProbVoxelMap):
                return m.data[i].to(torch.int32) >= float_to_probability(coll_threshold)
            # the maintained summary (1 byte an entry) where the map keeps
            # one, the plane fold otherwise (F10)
            if m.occ is not None:
                return m.occ[i] != 0
            return bitops.occupied(m.data[:, i])

        return take_from_slabs(dense_map, idx, occupied)

    def collide_with_dense(self, dense_map, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """List x dense map lookup collide (kernelCollideWithVoxelMap,
        voxellist/kernels/VoxelListOperations.h:90-160)."""
        valid, idx = self._dense_lookup(dense_map, offset)
        occ = self._dense_occupied(dense_map, idx, coll_threshold)
        return (occ & valid & self._entry_occupied()).sum(dtype=torch.int64)

    def collide_with_type_mask(self, dense_map, types_to_check, coll_threshold: float = 1.0,
                               offset=(0, 0, 0)) -> torch.Tensor:
        """collideWithTypeMask (BitVoxelList.hpp:219-262): the dense-map
        collide over the entries whose bit vector meets `types_to_check`, a
        uint32[8] plane vector (numpy uint32, or an int32 tensor of the same
        bits)."""
        if self.kind != KIND_BIT:
            raise TypeError("collide_with_type_mask needs a bit-vector voxel list")
        if isinstance(types_to_check, torch.Tensor):
            mask = types_to_check.to(self.device, bitops.PLANE_DTYPE)
        else:
            mask = to_device(np.asarray(types_to_check, np.uint32).view(np.int32), bitops.PLANE_DTYPE, self.device)
        matches = ~bitops.is_zero(self.payload & mask.reshape(NUM_BIT_PLANES, 1))
        valid, idx = self._dense_lookup(dense_map, offset)
        occ = self._dense_occupied(dense_map, idx, coll_threshold)
        return (occ & valid & matches).sum(dtype=torch.int64)

    def _entry_occupied(self) -> torch.Tensor:
        if self.kind == KIND_BIT:
            return bitops.occupied(self.payload)
        if self.kind == KIND_PROB:
            return self.payload.to(torch.int32) >= 100  # DefaultCollider's default
        return self.payload.to(torch.int32) > 0

    # -- set operations -----------------------------------------------------
    def _voxel_offset(self, offset, metric_offset):
        """The Vector3f overload: floor(metric / side_length) per axis
        (mapToVoxelsSigned, kernels/VoxelMapOperations.h:137-145)."""
        if metric_offset is None:
            return tuple(offset)
        return tuple(int(np.floor(float(m) / self.side_length)) for m in metric_offset)

    def merge(self, other: "VoxelList", offset=(0, 0, 0), new_meaning=None, metric_offset=None) -> "VoxelList":
        """Append + make_unique (TemplateVoxelList.hpp:537-607). The appended
        entries may be shifted by a signed voxel offset (the linear id gets
        the signed linear offset, uint32 wrap; applyOffsetOperator,
        TemplateVoxelList.h:66-89) and, in bit lists, re-meaned to a single
        bit before the dedup (TemplateVoxelList.hpp:585-590)."""
        if self.kind != other.kind:
            raise TypeError(f"cannot merge a {other.kind} list into a {self.kind} list")
        self._require_same_id_mode(other, "merge")
        offset = self._voxel_offset(offset, metric_offset)
        o_keys, o_payload = other.keys, other.payload
        valid = o_keys != other.empty
        if offset != (0, 0, 0):
            o_keys = other._shifted_keys(offset, self.dims)
        if new_meaning is not None:
            if self.kind != KIND_BIT:
                raise TypeError("new_meaning applies to bit lists only")
            fill = torch.zeros_like(o_payload)
            fill[bitops.bit_plane(int(new_meaning))] = bitops.as_int32(bitops.bit_word(int(new_meaning)))
            o_payload = torch.where(valid[None, :], fill, o_payload)
        u_keys, u_payload, count = self._make_unique(torch.cat([self.keys, o_keys]),
                                                     torch.cat([self.payload, o_payload], dim=-1))
        merged = replace(self, keys=u_keys, payload=u_payload, count=count)
        return merged.with_capacity(self.capacity + other.capacity)

    def memory_usage(self) -> int:
        """getMemoryUsage (TemplateVoxelList.h): device bytes of the list; an
        8-byte key an entry, as the reference's two uint32 id words."""
        return int(self.keys.numel() * self.keys.element_size() + self.payload.numel() * self.payload.element_size())

    def subtract(self, other: "VoxelList", offset=(0, 0, 0), metric_offset=None) -> "VoxelList":
        """Remove the entries present in other (TemplateVoxelList.hpp:610-643)."""
        self._require_same_id_mode(other, "subtract")
        member = self._membership(other, self._voxel_offset(offset, metric_offset))
        return self._compact(~member & (self.keys != self.empty))

    def shrink_to_fit(self) -> "VoxelList":
        """shrinkToFit (TemplateVoxelList.h:153): capacity = the live count
        (a host read of the count)."""
        return self.with_capacity(max(int(self.count), 1))

    def resize(self, new_size: int) -> "VoxelList":
        """resize (TemplateVoxelList.h:151): growing pads EMPTY entries,
        shrinking truncates the sorted tail."""
        return self.with_capacity(int(new_size))

    def needs_rebuild(self) -> bool:
        """The list is kept sorted and compact after every insert
        (AbstractVoxelList returns false)."""
        return False

    def rebuild(self) -> "VoxelList":
        return self

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (unsupported in the reference's lists).
        Returns (new_list, ok device bool); ok is False when two sub-clouds
        share a voxel."""
        clash = torch.zeros((), dtype=torch.bool, device=self.device)
        if with_self_collision_test:
            seen = None
            for i in range(robot_links.num_clouds):
                # scratch lists in my own id mode: a linear one would refuse
                # morton-scale dims
                cur = VoxelList.create(self.dims, self.side_length, KIND_BIT, id_mode=self.id_mode,
                                       device=self.device).insert_point_cloud(robot_links.get_cloud(i))
                if seen is None:
                    seen = cur
                else:
                    clash = clash | (seen.collide_with(cur) > 0)
                    seen = seen.merge(cur)
        return self.insert_meta_point_cloud(robot_links), ~clash

    def clear_voxel_meaning(self, meaning) -> "VoxelList":
        """clearBitVoxelMeaning (stubbed NOT_YET_SUPPORTED on the reference's
        lists, BitVoxelList.hpp:65-68): clear the bit in every entry and drop
        the entries left empty."""
        if self.kind != KIND_BIT:
            raise TypeError("clear_voxel_meaning needs a bit-vector voxel list")
        newp = bitops.clear_bit(self.payload, int(meaning))
        live = torch.any(newp != 0, dim=0) & (self.keys != self.empty)
        return replace(self, payload=newp)._compact(live)

    def remove_underpopulated(self, threshold: int) -> "VoxelList":
        """CountingVoxelList::remove_underpopulated (CountingVoxelList.h:58)."""
        if self.kind != KIND_COUNT:
            raise TypeError("remove_underpopulated needs a counting voxel list")
        keep = (self.payload.to(torch.int32) >= int(threshold)) & (self.keys != self.empty)
        return self._compact(keep)

    def _compact(self, keep: torch.Tensor) -> "VoxelList":
        keys, payload, count = _compact_into(self.kind, keep, self.keys, self.payload, self.empty)
        return replace(self, keys=keys, payload=payload, count=count)

    def equals(self, other: "VoxelList") -> torch.Tensor:
        """Same ids, payloads and count (a device bool); lists of different
        capacities compare over the smaller one."""
        self._require_same_id_mode(other, "equals")
        if self.capacity != other.capacity:
            common = min(self.capacity, other.capacity)
            return self.with_capacity(common).equals(other.with_capacity(common))
        return torch.all(self.keys == other.keys) & torch.all(self.payload == other.payload) & (self.count == other.count)

    # -- maintenance ----------------------------------------------------------
    def clear_map(self) -> "VoxelList":
        return replace(
            self,
            keys=torch.full_like(self.keys, self.empty),
            payload=_payload_init(self.kind, self.capacity, self.device),
            count=torch.zeros_like(self.count),
        )

    def shift_left_swept_volume_ids(self, shift_size: int) -> "VoxelList":
        if self.kind != KIND_BIT:
            raise TypeError("shift_left_swept_volume_ids needs a bit-vector voxel list")
        return replace(self, payload=bitops.perform_left_shift(self.payload, shift_size))

    def screendump(self, max_entries: int = 32) -> str:
        n = int(self.count)
        keys = self.keys[:max_entries]
        coords = self.coords_from_ids(keys).cpu().numpy()
        ids = split_keys(keys, self.id_mode)[1].cpu().numpy()
        lines = [f"VoxelList(kind={self.kind}, count={n}, capacity={self.capacity})"]
        for i in range(min(n, max_entries)):
            lines.append(f"  id={int(ids[i])} xyz={coords[i].tolist()}")
        return "\n".join(lines)


def bit_vector_voxel_list(dims, side_length=1.0, capacity=0, device=None) -> VoxelList:
    return VoxelList.create(dims, side_length, KIND_BIT, capacity, "linear", device=device)


def bit_vector_morton_voxel_list(dims, side_length=1.0, capacity=0, device=None) -> VoxelList:
    return VoxelList.create(dims, side_length, KIND_BIT, capacity, "morton", device=device)


def prob_voxel_list(dims, side_length=1.0, capacity=0, device=None) -> VoxelList:
    return VoxelList.create(dims, side_length, KIND_PROB, capacity, "linear", device=device)


def counting_voxel_list(dims, side_length=1.0, capacity=0, device=None) -> VoxelList:
    return VoxelList.create(dims, side_length, KIND_COUNT, capacity, "linear", device=device)
