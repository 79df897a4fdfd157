"""Slab-sharded values of existing maps.

Counterpart of gpu_voxels_tpu/parallel/shard_value.py. The reference lays an
already-built map pytree over a device mesh with NamedSharding and lets
XLA's SPMD partitioner run the map's own public ops distributed. torch has
no transparent SPMD, so `shard_map_value` returns a slab-sharded value
instead: one map of the same class per z-slab, with dims (dx, dy, dz / nz),
each on its mesh device, and the ops routed slab by slab:

  * `insert_point_cloud` (and the counting map's): each slab voxelizes the
    replicated points in the global frame, shifts z by its first row as an
    integer and drops the points outside it;
  * `collide_with`: each slab runs the single-device count (K1 for prob x
    prob, K7 for bit maps without an occupancy summary, the plain summary
    counts otherwise) and the counts sum. An offset pairs a[i + off] with
    b[i] over the global flat grid, as the single-device call does, so a
    slab reads the rows it needs from its neighbour slab;
  * `collide_with_types` (K4 per slab; the meanings OR over the slabs, the
    marked map stays sharded), `collide_with_bitcheck` and `merge`: voxel by
    voxel, so slab by slab;
  * `clear_map` and the other voxel-wise clears;
  * the hierarchical pyramids: levels whose z extent divides over the mesh
    are split into slabs, the coarse tail is kept once on the mesh's first
    device; `probe` and the probe collides descend across them, and a
    point insert sets level 0 slab by slab and rebuilds the levels above.

A plain map given as the other operand is split the same way. Any other
public method of the map's class raises NotImplementedError naming ROADMAP
Queue 1 item 13b instead of gathering silently; `gather()` makes a
single-device copy on request.

Layout: dense grids are flat z-major (index = z*dimx*dimy + y*dimx + x,
TemplateVoxelMap.h:258), so z-slabs are contiguous pieces of the flat axis
(dimz must divide over the mesh). Bit maps split their [8, N] planes along
N and keep the plane axis whole, with the occupancy summary beside them.

Facade opt-in: `GpuVoxels.add_map(..., mesh=mesh)` keeps the named map
sharded (re-pinned after every update).
"""
from __future__ import annotations

from dataclasses import fields
from typing import Tuple

import torch

from ..constants import UNKNOWN_PROBABILITY, BitVoxelMeaning, float_to_probability
from ..maps.hierarchical import (NS_DYNAMIC_MAP, NS_FREE, NS_OCCUPIED, NS_STATIC_MAP, NS_UNKNOWN,
                                 STATUS_OCCUPANCY_MASK, U8, HierarchicalBitMap, HierarchicalProbMap, _axis_index,
                                 _build_pyramid, _is_uniform, _status_from_occupancy, count_probe_hits,
                                 decode_status_flags, query_coords_of)
from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap, _DenseMap
from ..maps.voxelmap import replace as map_replace
from ..ops import collide as collide_ops
from ..ops import collide_cuda
from ..ops import insert as insert_ops
from ..utils import to_device
from .sharded import GridMesh, psum, replicate, split_slabs

Dims = Tuple[int, int, int]
ITEM_13B = "ROADMAP Queue 1 item 13b"


def _axis_devices(mesh: GridMesh, axis: str) -> list:
    """The devices of the mesh axis a map is split over: only 'z' (the
    slabs of scene 0's row)."""
    if axis != "z":
        raise ValueError(f"map values split over the mesh's 'z' axis, got {axis!r}")
    return mesh.z_devices()


def _check_divides(m, mesh: GridMesh, axis: str) -> int:
    nz = len(_axis_devices(mesh, axis))
    if m.dims[2] % nz:
        raise ValueError(f"map dimz {m.dims[2]} must divide the mesh '{axis}' axis ({nz}) for z-slab sharding")
    return nz


class _ShardedValue:
    """What every slab-sharded value shares: the mesh, the axis, the global
    dims and the refusal of methods with no slab form."""

    def _init_common(self, base_cls, mesh: GridMesh, axis: str, dims: Dims, side_length: float, map_type):
        self._base_cls = base_cls
        self.mesh = mesh
        self.axis = axis
        self.devices = _axis_devices(mesh, axis)
        self.dims = tuple(int(d) for d in dims)
        self.side_length = float(side_length)
        self.map_type = map_type
        self.slab_dz = self.dims[2] // len(self.devices)
        self.z0s = [k * self.slab_dz for k in range(len(self.devices))]

    @property
    def device(self) -> torch.device:
        """The mesh device every count and probe result lands on."""
        return self.devices[0]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if hasattr(self.__dict__.get("_base_cls"), name):
            raise NotImplementedError(
                f"{self._base_cls.__name__}.{name} has no slab form on a sharded value ({ITEM_13B}); "
                "gather() makes a single-device copy")
        raise AttributeError(name)


# -- dense maps ------------------------------------------------------------------
def _split_map(m, devices, dims: Dims):
    """A plain dense map as one map of its class per slab: every tensor field
    cut along its last (voxel) axis, each slab contiguous on its device."""
    nz = len(devices)
    local = (dims[0], dims[1], dims[2] // nz)
    per_slab = [{} for _ in range(nz)]
    for f in fields(m):
        v = getattr(m, f.name)
        if isinstance(v, torch.Tensor):
            for k, p in enumerate(split_slabs(v, devices)):
                per_slab[k][f.name] = p.contiguous()
    return [map_replace(m, dims=local, **ch) for ch in per_slab]


def _segments(nz: int, s: int, lin: int):
    """The pairs (a[i + lin], b[i]) of two flat grids of nz slabs of s voxels,
    i and i + lin both inside, as runs (b slab, a slab, a start, b start,
    length) that stay inside one slab of each."""
    n = nz * s
    lo_g, hi_g = max(0, -lin), min(n, n - lin)
    out = []
    for kb in range(nz):
        lo, hi = max(kb * s, lo_g), min((kb + 1) * s, hi_g)
        while lo < hi:
            j = lo + lin
            ka = j // s
            run = min(hi - lo, (ka + 1) * s - j)
            out.append((kb, ka, j - ka * s, lo - kb * s, run))
            lo += run
    return out


def _cols(t: torch.Tensor, start: int, n: int) -> torch.Tensor:
    """Voxels [start, start + n) of a slab tensor (last axis), contiguous."""
    if start == 0 and n == t.shape[-1]:
        return t
    return t[..., start:start + n].contiguous()


class ShardedDenseMap(_ShardedValue):
    """A dense map (ProbVoxelMap, BitVectorVoxelMap, CountingVoxelMap,
    DistanceVoxelMap) as one map of its class per z-slab of a mesh axis."""

    def __init__(self, slabs, mesh: GridMesh, axis: str, dims: Dims):
        first = slabs[0]
        self._init_common(type(first), mesh, axis, dims, first.side_length, first.map_type)
        self.slabs = tuple(slabs)

    def _with(self, slabs) -> "ShardedDenseMap":
        return ShardedDenseMap(slabs, self.mesh, self.axis, self.dims)

    @property
    def voxelmap_size(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    def gather(self, device=None):
        """A single-device copy of the whole map on `device` (default: the
        mesh's first device): the slabs joined along the voxel axis."""
        device = self.device if device is None else device
        first = self.slabs[0]
        changes = {}
        for f in fields(first):
            if isinstance(getattr(first, f.name), torch.Tensor):
                changes[f.name] = torch.cat([getattr(s, f.name).to(device) for s in self.slabs], dim=-1)
        return map_replace(first, dims=self.dims, **changes)

    def _other_slabs(self, other) -> list:
        """The other operand's slabs on this value's devices."""
        if isinstance(other, ShardedDenseMap):
            if other.dims != self.dims or len(other.slabs) != len(self.slabs):
                raise ValueError(f"sharded maps of dims {other.dims} / {len(other.slabs)} slabs and "
                                 f"{self.dims} / {len(self.slabs)} slabs do not pair")
            return [replicate(s, d) for s, d in zip(other.slabs, self.devices)]
        if isinstance(other, _DenseMap):
            if tuple(other.dims) != self.dims:
                raise ValueError(f"maps must share dims: {other.dims} vs {self.dims}")
            return _split_map(other, self.devices, self.dims)
        raise TypeError(f"cannot pair a sharded {self._base_cls.__name__} with {type(other).__name__}")

    # -- insertion ----------------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "ShardedDenseMap":
        """The single-device insert, slab by slab: points voxelized in the
        global frame, z shifted by the slab's first row, out-of-slab points
        dropped."""
        out = []
        for slab, dev, z0 in zip(self.slabs, self.devices, self.z0s):
            pts = to_device(points, torch.float32, dev)
            if isinstance(slab, ProbVoxelMap):
                data, _ = insert_ops.insert_prob(slab.data, pts, self.side_length, slab.dims, meaning, z0)
                out.append(map_replace(slab, data=data))
            elif isinstance(slab, BitVectorVoxelMap):
                data, _, occ_d = insert_ops.insert_bit(slab.data, pts, self.side_length, slab.dims, int(meaning), z0)
                out.append(map_replace(slab, data=data, occ=None if slab.occ is None else slab.occ | occ_d))
            elif isinstance(slab, CountingVoxelMap):
                data, _ = insert_ops.insert_count(slab.data, pts, self.side_length, slab.dims, z0)
                out.append(map_replace(slab, data=data))
            else:
                raise NotImplementedError(f"{self._base_cls.__name__}.insert_point_cloud has no slab form ({ITEM_13B})")
        return self._with(out)

    # -- collision ----------------------------------------------------------
    def _offset_count(self, a_parts, b_parts, lin: int, count) -> torch.Tensor:
        """Sum of count(a run, b run) over the pairs a[i + lin], b[i], each run
        counted on b's device."""
        counts = []
        for kb, ka, a0, b0, n in _segments(len(self.slabs), self.slabs[0].voxelmap_size, lin):
            counts.append(count(_cols(a_parts[ka], a0, n).to(self.devices[kb]), _cols(b_parts[kb], b0, n)))
        if not counts:
            return torch.zeros((), dtype=torch.int64, device=self.device)
        return psum(counts, self.device)

    def collide_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith count, the single-device rule per slab (K1 for prob x
        prob, K7 for bit planes without a summary), summed."""
        t = float_to_probability(coll_threshold)
        off = tuple(int(v) for v in offset)
        lin = insert_ops.linear_offset(off, self.dims)
        o = self._other_slabs(other)
        mine = self.slabs
        if issubclass(self._base_cls, ProbVoxelMap) and isinstance(o[0], ProbVoxelMap):
            return self._offset_count([s.data for s in mine], [s.data for s in o], lin,
                                      lambda a, b: collide_cuda.count_prob_prob(a, b, t, t))
        if issubclass(self._base_cls, ProbVoxelMap) and isinstance(o[0], BitVectorVoxelMap):
            a = [s.data for s in mine]
            if all(s.occ is not None for s in o):
                return self._offset_count(a, [s.occ for s in o], lin,
                                          lambda x, y: collide_ops.count_prob_occ(x, t, y))
            return self._offset_count(a, [s.data for s in o], lin, lambda x, y: collide_ops.count_prob_bit(x, t, y))
        if issubclass(self._base_cls, BitVectorVoxelMap) and isinstance(o[0], BitVectorVoxelMap):
            if all(s.occ is not None for s in mine) and all(s.occ is not None for s in o):
                return self._offset_count([s.occ for s in mine], [s.occ for s in o], lin, collide_ops.count_occ_occ)
            return self._offset_count([s.data for s in mine], [s.data for s in o], lin, collide_cuda.count_bit_bit)
        if issubclass(self._base_cls, BitVectorVoxelMap) and isinstance(o[0], ProbVoxelMap):
            # DefaultCollider bit x prob: the prob side at i - offset
            rlin = insert_ops.linear_offset(tuple(-v for v in off), self.dims)
            a = [s.data for s in o]
            if all(s.occ is not None for s in mine):
                return self._offset_count(a, [s.occ for s in mine], rlin,
                                          lambda x, y: collide_ops.count_prob_occ(x, t, y))
            return self._offset_count(a, [s.data for s in mine], rlin,
                                      lambda x, y: collide_ops.count_prob_bit(x, t, y))
        raise TypeError(f"cannot collide a sharded {self._base_cls.__name__} with {type(other).__name__}")

    def collide_with_types(self, other, coll_threshold: float = 1.0, sv_window: int = 0, sv_offset: int = 0):
        """collideWithTypes slab by slab (K4 per slab for bit x bit at
        sv_offset 0 and windows up to 24): (count, meanings int32[8] ORed
        over the slabs, the marked map, still sharded)."""
        parts = [s.collide_with_types(o, coll_threshold, sv_window, sv_offset)
                 for s, o in zip(self.slabs, self._other_slabs(other))]
        meanings = parts[0][1].to(self.device)
        for p in parts[1:]:
            meanings = meanings | p[1].to(self.device)
        return psum([p[0] for p in parts], self.device), meanings, self._with([p[2] for p in parts])

    def collide_with_bitcheck(self, other, margin: int = 0, sv_offset: int = 0) -> torch.Tensor:
        return psum([s.collide_with_bitcheck(o, margin, sv_offset)
                     for s, o in zip(self.slabs, self._other_slabs(other))], self.device)

    def merge(self, other, *args, **kwargs) -> "ShardedDenseMap":
        return self._with([s.merge(o, *args, **kwargs) for s, o in zip(self.slabs, self._other_slabs(other))])


def _per_slab(name: str):
    def method(self, *args, **kwargs):
        if not hasattr(self._base_cls, name):
            raise AttributeError(f"{self._base_cls.__name__} has no {name}")
        return self._with([getattr(s, name)(*args, **kwargs) for s in self.slabs])

    method.__name__ = name
    method.__doc__ = f"`{name}` voxel by voxel, so slab by slab; the result stays sharded."
    return method


for _name in ("clear_map", "clear_voxel_meaning", "clear_bit", "clear_bits", "clear_collision_flags",
              "shift_left_swept_volume_ids"):
    setattr(ShardedDenseMap, _name, _per_slab(_name))


# -- hierarchical pyramids -------------------------------------------------------
class ShardedPyramid(_ShardedValue):
    """A dense hierarchical map (HierarchicalBitMap, HierarchicalProbMap)
    with every pyramid level whose z extent divides over the mesh split into
    slabs and the coarse tail kept once on the mesh's first device."""

    def __init__(self, base_cls, dims: Dims, side_length: float, levels: int, map_type, pyramid, occupancy,
                 mesh: GridMesh, axis: str):
        self._init_common(base_cls, mesh, axis, dims, side_length, map_type)
        self.levels = int(levels)
        self.pyramid = list(pyramid)  # per level: a list of slabs, or one tensor
        self.occupancy = occupancy  # slabs of the prob tier's log-odds, or None

    def gather(self, device=None):
        """A single-device copy of the whole map on `device` (default: the
        mesh's first device)."""
        device = self.device if device is None else device
        pyr = tuple(torch.cat([p.to(device) for p in lv]) if isinstance(lv, list) else lv.to(device)
                    for lv in self.pyramid)
        if issubclass(self._base_cls, HierarchicalProbMap):
            occ = torch.cat([p.to(device) for p in self.occupancy])
            return HierarchicalProbMap(occ, pyr, self.dims, self.side_length, self.levels)
        return HierarchicalBitMap(pyr, self.dims, self.side_length, self.levels)

    def _level_at(self, lvl: int, x, y, z, in_range: bool) -> torch.Tensor:
        """Level `lvl`'s status at int64 level coords, with the single-device
        gather's out-of-range rule; a split level answers from the owning
        slab."""
        part = self.pyramid[lvl]
        if not isinstance(part, list):
            zs, ys, xs = part.shape
            if not in_range:
                x, y, z = _axis_index(x, xs), _axis_index(y, ys), _axis_index(z, zs)
            return torch.take(part, (z * ys + y) * xs + x)
        zsl, ys, xs = part[0].shape
        if not in_range:
            x, y, z = _axis_index(x, xs), _axis_index(y, ys), _axis_index(z, zsl * len(part))
        out = torch.zeros(x.shape, dtype=U8, device=self.device)
        for k, (p, dev) in enumerate(zip(part, self.devices)):
            local = ((z - k * zsl).clamp(0, zsl - 1) * ys + y) * xs + x
            out = torch.where(z // zsl == k, torch.take(p, local.to(dev)).to(self.device), out)
        return out

    def _descend(self, stop: int, coords: torch.Tensor, in_range: bool) -> torch.Tensor:
        """hierarchical.descend across the slabs: the status of the first
        uniform node from the top down to `stop` (or the node at `stop`)."""
        c = to_device(coords, torch.int64, self.device)
        x, y, z = c[..., 0], c[..., 1], c[..., 2]
        decided = torch.zeros(x.shape, dtype=torch.bool, device=self.device)
        status = torch.zeros(x.shape, dtype=U8, device=self.device)
        for lvl in range(self.levels, stop - 1, -1):
            s = self._level_at(lvl, x >> lvl, y >> lvl, z >> lvl, in_range)
            if lvl == stop:
                return torch.where(decided, status, s)
            uni = _is_uniform(s)
            status = torch.where(uni & ~decided, s, status)
            decided |= uni
        return status

    def probe_status(self, coords, min_level: int = 0) -> torch.Tensor:
        return self._descend(int(min_level), coords, in_range=False)

    def _with_level0(self, status0: list, occupancy=None) -> "ShardedPyramid":
        """The pyramid rebuilt from new level-0 slabs: each split level from
        its slab's finer level (a 2-cube never crosses a slab where the
        coarser level still splits), the first whole level from the
        gathered finer one, the tail from that."""
        pyr, cur = [status0], status0
        for lvl in range(1, self.levels + 1):
            if isinstance(cur, list) and not isinstance(self.pyramid[lvl], list):
                cur = torch.cat([c.to(self.device) for c in cur])
            cur = [_build_pyramid(c, 1)[1] for c in cur] if isinstance(cur, list) else _build_pyramid(cur, 1)[1]
            pyr.append(cur)
        return ShardedPyramid(self._base_cls, self.dims, self.side_length, self.levels, self.map_type, pyr,
                              occupancy, self.mesh, self.axis)

    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED, static_map: bool = True):
        """The single-device point insert, slab by slab on level 0 (points
        voxelized in the global frame, z shifted by the slab's first row as
        an integer), then the pyramid rebuilt across the slabs. The
        deterministic tier sets hard statuses tagged by `static_map`; the
        probabilistic one sets the meaning's probability."""
        if not isinstance(self.pyramid[0], list):
            raise NotImplementedError(f"a pyramid whose level 0 is not split has no slab insert ({ITEM_13B})")
        prob = issubclass(self._base_cls, HierarchicalProbMap)
        occ_bit = NS_FREE if int(meaning) == int(BitVoxelMeaning.eBVM_FREE) else NS_OCCUPIED
        flag = NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP
        status0, occupancy = [], [] if prob else None
        for k, (s0, dev) in enumerate(zip(self.pyramid[0], self.devices)):
            local = (s0.shape[2], s0.shape[1], s0.shape[0])
            pts = to_device(points, torch.float32, dev).reshape(-1, 3)
            if prob:
                flat, _ = insert_ops.insert_prob(self.occupancy[k].reshape(-1), pts, self.side_length, local,
                                                 meaning, k * s0.shape[0])
                occupancy.append(flat.reshape(s0.shape))
                status0.append(_status_from_occupancy(occupancy[-1]))
            else:
                idx, _ = insert_ops.voxelize(pts, self.side_length, local, k * s0.shape[0])
                hits = insert_ops.occupancy_mask(idx, s0.numel()).reshape(s0.shape) > 0
                status0.append(torch.where(hits, (s0 & (0xFF ^ STATUS_OCCUPANCY_MASK)) | (occ_bit | flag), s0))
        return self._with_level0(status0, occupancy)

    def probe(self, coords, min_level: int = 0):
        return decode_status_flags(self.probe_status(coords, min_level))

    def probe_clamped(self, coords: torch.Tensor, min_level: int = 0):
        return decode_status_flags(self._descend(int(min_level), coords, in_range=True))

    def _collide_probe(self, other, min_level: int, offset):
        from ..maps.hierarchical import _PyramidQueries
        from ..maps.paged import PagedHierarchicalMap

        if isinstance(other, (_PyramidQueries, PagedHierarchicalMap, _ShardedValue)):
            raise NotImplementedError(f"octree x octree collides have no slab form ({ITEM_13B})")
        coords, valid = query_coords_of(other)
        return count_probe_hits(self.probe_clamped, coords.to(self.device), valid.to(self.device), self.dims,
                                int(min_level), offset)

    def collide_with(self, other, min_level: int = 0, offset=(0, 0, 0)) -> torch.Tensor:
        """Probe self at other's voxel list entries or dense voxels + offset."""
        return self._collide_probe(other, min_level, offset)[0]

    def collide_with_counting_unknown(self, other, min_level: int = 0, offset=(0, 0, 0)):
        return self._collide_probe(other, min_level, offset)

    def clear_map(self) -> "ShardedPyramid":
        """The pristine UNKNOWN map, every level filled in place of a rebuild."""
        prob = issubclass(self._base_cls, HierarchicalProbMap)
        status = NS_UNKNOWN
        if prob:
            status = int(_status_from_occupancy(torch.full((1,), UNKNOWN_PROBABILITY, dtype=torch.int8))[0])
        pyr = [[torch.full_like(p, status) for p in lv] if isinstance(lv, list) else torch.full_like(lv, status)
               for lv in self.pyramid]
        occ = [torch.full_like(p, UNKNOWN_PROBABILITY) for p in self.occupancy] if prob else None
        return ShardedPyramid(self._base_cls, self.dims, self.side_length, self.levels, self.map_type, pyr, occ,
                              self.mesh, self.axis)


# -- the public functions ------------------------------------------------------------
def shard_map_value(m, mesh: GridMesh, axis: str = "z"):
    """The map `m` as a slab-sharded value over `mesh`'s `axis`.

    Supports the dense tiers (ProbVoxelMap, CountingVoxelMap,
    DistanceVoxelMap: flat data; BitVectorVoxelMap: planes and occupancy
    summary) and the hierarchical pyramids (levels split while their z
    extent divides the mesh, the coarse tail kept once). A value already
    sharded over this mesh is returned as it is."""
    if isinstance(m, _ShardedValue):
        if m.axis == axis and m.devices == _axis_devices(mesh, axis):
            return m
        m = m.gather()
    nz = _check_divides(m, mesh, axis)
    devices = _axis_devices(mesh, axis)
    if isinstance(m, _DenseMap):
        return ShardedDenseMap(_split_map(m, devices, m.dims), mesh, axis, m.dims)
    if isinstance(m, (HierarchicalProbMap, HierarchicalBitMap)):
        def split_level(lv):
            return split_slabs(lv, devices, axis=0) if lv.shape[0] % nz == 0 else lv.to(devices[0])

        occ = split_slabs(m.occupancy, devices, axis=0) if isinstance(m, HierarchicalProbMap) else None
        return ShardedPyramid(type(m), m.dims, m.side_length, m.levels, m.map_type,
                              [split_level(lv) for lv in m.pyramid], occ, mesh, axis)
    raise TypeError(f"no sharding layout for {type(m)}")


def _sharded_arrays(m):
    """(name, slabs, sharded dim, global extent) per field expected sharded."""
    if isinstance(m, ShardedDenseMap):
        out = [("data", [s.data for s in m.slabs], -1, m.voxelmap_size)]
        if isinstance(m.slabs[0], BitVectorVoxelMap) and m.slabs[0].occ is not None:
            out.append(("occ", [s.occ for s in m.slabs], -1, m.voxelmap_size))
        return out
    # only level 0 is asserted: coarse levels may legitimately stay whole
    lv0 = m.pyramid[0]
    if not isinstance(lv0, list):
        return [("pyramid[0]", [lv0], 0, lv0.shape[0] * len(m.devices))]
    return [("pyramid[0]", lv0, 0, sum(p.shape[0] for p in lv0))]


def assert_sharded(m, mesh: GridMesh, axis: str = "z") -> None:
    """Fail loudly if the map's bulk tensors are NOT split over the mesh:
    each slab must hold exactly global extent / mesh[axis] of the sharded
    dimension, on its own mesh device. A plain single-device map fails
    (every count would still be right, and nothing else would notice)."""
    if not isinstance(m, _ShardedValue):
        raise AssertionError(f"{type(m).__name__} is a single-device value, not sharded over {mesh}")
    devices = _axis_devices(mesh, axis)
    nz = len(devices)
    for name, parts, dim, extent in _sharded_arrays(m):
        if len(parts) != nz:
            raise AssertionError(f"{name}: {len(parts)} slabs != mesh '{axis}' size {nz}")
        want = extent // nz
        for p, dev in zip(parts, devices):
            if p.shape[dim] != want:
                raise AssertionError(f"{name}: per-slab dim {dim} is {p.shape[dim]}, want {want} "
                                     f"(global {extent} / {nz}); silently replicated?")
            if p.device != dev:
                raise AssertionError(f"{name}: a slab lies on {p.device}, its mesh device is {dev}")


def reshard_like(m, mesh: GridMesh, axis: str = "z"):
    """Re-pin a map to its mesh layout after an update: the value itself
    when it is already sharded over the mesh, a split otherwise."""
    return shard_map_value(m, mesh, axis)
