"""Slab-sharded values of existing maps.

Counterpart of gpu_voxels_tpu/parallel/shard_value.py. The reference lays an
already-built map pytree over a device mesh with NamedSharding and lets
XLA's SPMD partitioner run the map's own public ops distributed. torch has
no transparent SPMD, so `shard_map_value` returns a slab-sharded value
instead: one map of the same class per z-slab, with dims (dx, dy, dz / nz),
each on its mesh device, and the ops routed slab by slab.

Dense maps (`ShardedDenseMap`: ProbVoxelMap, BitVectorVoxelMap,
CountingVoxelMap, DistanceVoxelMap): every public instance method of the
class has a slab form that gives the single-device call's answer:

  * inserts (points, meta clouds with global ranks, robot configurations
    with the self-collision clash ORed over the slabs, update_occupancy):
    each slab voxelizes the replicated points in the global frame, shifts
    z by its first row as an integer and drops the points outside it;
  * sensing: insert_depth_image carves each slab in the global frame with
    its z offset (K3, or K6 against the frame's one pooled table), the DDA
    insert_sensor_data walks the rays once and counts every step's voxels
    on the slab that owns them; the stored sensor rides on the value;
  * collides: collide_with (K1, K7 or the summaries per run of slabs an
    offset pairs, so a slab reads the rows it needs from its neighbours),
    collide_with_marking (K2 per run, the marks on a's slab), collides_with,
    collide_with_resolution (the cubes a slab boundary cuts ORed from the
    slabs' partial cubes), collide_with_types (K4 per slab, meanings ORed),
    collide_with_bitcheck, merge and the voxel-wise clears;
  * the distance tier: obstacles store global coordinates; parallel_banding
    is sharded_edt_exact's (K5 per slab and pass), jump_flood takes the
    single-device call's route (on the card that exact EDT, on the CPU
    sharded_edt.jump_flood_slabs with the single-device rules),
    exact_separable the Z scans with the slabs' carries, exact_distances and
    the queries per slab in global positions, init_floodfill's z sweep with
    carries, min_distance_to the min over the slabs;
  * queries and files: the whole-grid tensor results (occupancy,
    occupied_mask, get_bit_mask, as_3d, squared_distances, obstacle_mask,
    extract_distances, init_floodfill) are the slabs' parts joined on the
    mesh's first device, what the reference's sharded array holds when
    read; counts and scalars land there too; every other result stays
    sharded, and internal users (a cut-out robot, merge_occupied,
    differences) never join. write_to_disk writes the single map's bytes
    slab by slab, read_from_disk (and `read_sharded_map`) reads each slab's
    body onto its device.

Hierarchical pyramids (`ShardedPyramid`: HierarchicalBitMap,
HierarchicalProbMap): levels whose z extent divides over the mesh are split
into slabs (the prob tier's occupancy grid with level 0), the coarse tail is
kept once on the mesh's first device. Every public instance method of the
class has a slab form that gives the single-device call's answer:

  * inserts (points, meta clouds with the first meaning, robot
    configurations with the clash ORed over the slabs, build with its free
    box): level 0 (the occupancy) updated slab by slab in the global frame,
    z shifted as an integer, then the levels above rebuilt across the
    slabs (a split level from its slab, the first whole level from the
    joined finer one);
  * sensing: insert_depth_image over the padded grid's slabs (K3 once a
    slab, or K6's carve once a slab against the frame's one pooled table),
    the DDA insert with the rays walked once for all slabs;
  * probes and collides: the descent across the slabs; octree x octree (a
    plain or sharded other) an AND count a slab at a split level;
  * maintenance, queries and files: check_tree reads one verdict, status
    is level 0 joined on the first device, extract_occupied_coords compacts
    each slab, write_to_disk writes the single map's bytes slab by slab,
    read_from_disk (and `read_sharded_map`) reads each slab onto its device.

A bit pyramid whose padded z extent does not divide the mesh keeps every
level whole on the first device (the reference replicates it); a prob
pyramid's raises, as the reference's device_put of its occupancy does.
`to` raises; `gather()` makes a single-device copy on request.

A plain map given as the other operand is split the same way.

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

import numpy as np
import torch

from ..constants import UNKNOWN_PROBABILITY, BitVoxelMeaning, MapType, float_to_probability
from ..geometry import transforms
from ..maps.distance_map import DistanceVoxelMap
from ..maps.hierarchical import (NS_DYNAMIC_MAP, NS_FREE, NS_OCCUPIED, NS_STATIC_MAP, NS_UNKNOWN,
                                 STATUS_OCCUPANCY_MASK, U8, HierarchicalBitMap, HierarchicalProbMap, _axis_index,
                                 _build_pyramid, _is_uniform, _PyramidQueries, _sensor_scalars, _status_from_occupancy,
                                 bbox_mask, count_probe_hits, decode_status_flags, depth_world_points, hard_status,
                                 occupied_coords_of, query_coords_of, sensor_status, store_meaning, voxel_hits)
from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap, _DenseMap, print_voxel_dump
from ..maps.voxelmap import replace as map_replace
from ..ops import collide as collide_ops
from ..ops import collide_cuda, edt, raycast, raycast_cuda
from ..ops import insert as insert_ops
from ..ops.compact import compacted_nonzero
from ..utils import io as map_io
from ..utils import to_device
from . import sharded_edt
from .sharded import GridMesh, gather_rows, psum, replicate, split_slabs
from .sharded_edt_exact import build_sharded_parallel_banding, flood_z_slabs, l1_z_slabs

Dims = Tuple[int, int, int]
F32 = torch.float32


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
    """What every slab-sharded value shares: the mesh, the axis and the
    global dims."""

    def _init_common(self, base_cls, mesh: GridMesh, axis: str, dims: Dims, side_length: float, map_type):
        self._base_cls = base_cls
        self.mesh = mesh
        self.axis = axis
        self.devices = _axis_devices(mesh, axis)
        self.dims = tuple(int(d) for d in dims)
        self.side_length = float(side_length)
        self.map_type = map_type

    @property
    def device(self) -> torch.device:
        """The mesh device every count, probe and whole-grid result lands on."""
        return self.devices[0]


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
    DistanceVoxelMap) as one map of its class per z-slab of a mesh axis.
    Every public instance method of the class has a slab form here, equal
    to the single-device call."""

    def __init__(self, slabs, mesh: GridMesh, axis: str, dims: Dims, sensor=None):
        first = slabs[0]
        self._init_common(type(first), mesh, axis, dims, first.side_length, first.map_type)
        self.slabs = tuple(slabs)
        self.slab_dz = self.dims[2] // len(self.devices)
        self.z0s = [k * self.slab_dz for k in range(len(self.devices))]
        # the stored Sensor (init_sensor_settings), carried onto every derived value
        self._sensor = sensor if sensor is not None else getattr(first, "_sensor", None)

    def _with(self, slabs) -> "ShardedDenseMap":
        return ShardedDenseMap(slabs, self.mesh, self.axis, self.dims, self._sensor)

    def _require(self, name: str) -> None:
        """Raise as the single-device map does where its class has no `name`."""
        if not hasattr(self._base_cls, name):
            raise AttributeError(f"'{self._base_cls.__name__}' object has no attribute '{name}'")

    def _zipped(self):
        """(slab, its device, its first global row) per slab."""
        return zip(self.slabs, self.devices, self.z0s)

    def _join(self, parts, dim: int = -1) -> torch.Tensor:
        """A whole-grid tensor result: the slabs' parts joined along `dim` on
        the mesh's first device (what the reference's sharded array holds
        when read)."""
        return torch.cat([p.to(self.device) for p in parts], dim=dim)

    @property
    def voxelmap_size(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]

    @property
    def dimensions(self) -> Dims:
        return self.dims

    @property
    def metric_dimensions(self) -> Tuple[float, float, float]:
        return tuple(d * self.side_length for d in self.dims)

    def gather(self, device=None):
        """A single-device copy of the whole map on `device` (default: the
        mesh's first device): the slabs joined along the voxel axis."""
        device = self.device if device is None else device
        first = self.slabs[0]
        changes = {}
        for f in fields(first):
            if isinstance(getattr(first, f.name), torch.Tensor):
                changes[f.name] = torch.cat([getattr(s, f.name).to(device) for s in self.slabs], dim=-1)
        out = map_replace(first, dims=self.dims, **changes)
        if self._sensor is not None:
            object.__setattr__(out, "_sensor", self._sensor)
        return out

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
        dropped. A distance map's obstacles store their global coordinates."""
        out = []
        for slab, dev, z0 in self._zipped():
            pts = to_device(points, F32, dev)
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
                idx, _ = insert_ops.voxelize(pts, self.side_length, slab.dims, z0)
                mask = insert_ops.occupancy_mask(idx, slab.voxelmap_size).bool()
                out.append(map_replace(slab, data=edt.with_obstacles(slab.data, mask, slab.dims, z0)))
        return self._with(out)

    init_sensor_settings = _DenseMap.init_sensor_settings
    update_sensor_pose = _DenseMap.update_sensor_pose

    def update_occupancy(self, points, delta) -> "ShardedDenseMap":
        """Log-odds additive update of every hit voxel, slab by slab."""
        self._require("update_occupancy")
        return self._with([map_replace(slab, data=insert_ops.update_occupancy(slab.data, points, delta,
                                                                            self.side_length, slab.dims, z0))
                           for slab, _, z0 in self._zipped()])

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "ShardedDenseMap":
        """The projective sensor update slab by slab: hits voxelized in the
        global frame, each slab carved with its z offset (K3, or with
        carve_pool > 1 K6 against the frame's pooled table, built once on
        the mesh's first device and handed to every slab)."""
        self._require("insert_depth_image")
        pool = int(carve_pool)
        depth = to_device(depth, F32, self.device)
        pose = to_device(sensor.pose(), F32, self.device)
        pooled = raycast_cuda.min_pool_depth(depth, pool, float(sensor.invalid_value)) if pool > 1 else None
        out = []
        for slab, dev, z0 in self._zipped():
            new = raycast.insert_depth_image(
                slab.data, depth.to(dev), pose.to(dev), float(sensor.fx), float(sensor.fy), float(sensor.cx),
                float(sensor.cy), self.side_length, slab.dims, invalid_value=float(sensor.invalid_value),
                carve_pool=pool, z_index_offset=z0, pooled_depth=None if pooled is None else pooled.to(dev),
            )
            out.append(map_replace(slab, data=new))
        return self._with(out)

    def _masks_of(self, robot_map) -> list:
        """A robot map's (sharded, dense or anything with occupied_mask())
        or a bool[N] mask's slabs on this value's devices."""
        if isinstance(robot_map, (ShardedDenseMap, _DenseMap)):
            return [s.occupied_mask() for s in self._other_slabs(robot_map)]
        if hasattr(robot_map, "occupied_mask"):
            robot_map = robot_map.occupied_mask()
        return split_slabs(robot_map, self.devices)

    def insert_sensor_data(self, points, sensor_origin=None, enable_raycasting: bool = True,
                           cut_real_robot: bool = False, robot_map=None, max_steps: int = 256) -> "ShardedDenseMap":
        """ProbVoxelMap.insert_sensor_data slab by slab: the points (moved by
        the stored sensor's pose, as the single-device call does) and their
        hits voxelized in the global frame, the rays walked once with every
        step's voxels counted on the slab that owns them
        (raycast.ray_crossing_counts_slabs). `robot_map` may be sharded."""
        self._require("insert_sensor_data")
        pts = to_device(points, F32, self.device)
        if sensor_origin is None:
            if self._sensor is not None:
                pts = transforms.transform_points(to_device(self._sensor.pose(), F32, self.device), pts)
                sensor_origin = self._sensor.position
            else:
                sensor_origin = (0.0, 0.0, 0.0)
        origin = tuple(float(v) for v in sensor_origin)
        masks = [None] * len(self.slabs)
        if cut_real_robot and robot_map is not None:
            masks = self._masks_of(robot_map)
        free = [None] * len(self.slabs)
        if enable_raycasting:
            free = raycast.ray_crossing_counts_slabs(origin, pts, self.side_length, self.dims, self.devices, max_steps)
        out = []
        for (slab, dev, z0), mask, fc in zip(self._zipped(), masks, free):
            new = raycast.insert_sensor_data(
                slab.data, origin, pts.to(dev), self.side_length, slab.dims, enable_raycasting=enable_raycasting,
                cut_real_robot=cut_real_robot, robot_occupied_mask=mask, max_steps=max_steps, z_index_offset=z0,
                free_counts=fc,
            )
            out.append(map_replace(slab, data=new))
        return self._with(out)

    # -- robots -------------------------------------------------------------
    def insert_meta_point_cloud(self, meta, meanings=None) -> "ShardedDenseMap":
        """The meta insert slab by slab: uniform meanings as a point insert;
        per-subcloud meanings as the prob tier's ranked scatter-max (ranks
        of the whole cloud, so the later point wins as on one device) or
        the bit tier's one-pass multi-meaning scatter."""
        self._require("insert_meta_point_cloud")
        if meanings is None:
            return self.insert_point_cloud(meta.points)
        out = []
        for slab, _, z0 in self._zipped():
            if isinstance(slab, ProbVoxelMap):
                data = insert_ops.insert_meta_prob(slab.data, meta, meanings, self.side_length, slab.dims, z0)
                out.append(map_replace(slab, data=data))
            else:
                data, occ = insert_ops.insert_meta_bits(slab.data, slab.occ, meta, meanings, self.side_length,
                                                        slab.dims, z0)
                out.append(map_replace(slab, data=data, occ=occ))
        return self._with(out)

    def _clash(self, meta) -> torch.Tensor:
        """The self-collision clash: the OR of the slabs' clashes, on the
        mesh's first device."""
        parts = [insert_ops.self_collision_clash(meta.to(dev), self.side_length, slab.dims, z0)
                 for slab, dev, z0 in self._zipped()]
        clash = parts[0].to(self.device)
        for p in parts[1:]:
            clash = clash | p.to(self.device)
        return clash

    def insert_meta_point_cloud_with_self_collision_check(self, meta, meaning=BitVoxelMeaning.eBVM_OCCUPIED):
        """(the map with every sub-cloud inserted, the device bool whether
        two sub-clouds share a voxel)."""
        self._require("insert_meta_point_cloud_with_self_collision_check")
        return self.insert_point_cloud(meta.points, meaning), self._clash(meta)

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """(new map, ok device bool): the robot cloud inserted (a distance
        map's obstacles, the meta insert otherwise), ok False on a
        self-collision."""
        self._require("insert_robot_configuration")
        clash = torch.zeros((), dtype=torch.bool, device=self.device)
        if with_self_collision_test:
            clash = self._clash(robot_links)
        if issubclass(self._base_cls, DistanceVoxelMap):
            return self.insert_point_cloud(robot_links.points), ~clash
        return self.insert_meta_point_cloud(robot_links), ~clash

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

    def collides_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """Boolean collisionCheck, a device bool."""
        self._require("collides_with")
        return collide_ops.any_collision(self.collide_with(other, coll_threshold, offset))

    def collide_with_marking(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        """(count, the map with eBVM_COLLISION set at every hit, still
        sharded): K2 once per run of slabs the offset pairs (a[i + off]
        against b[i]), on a's slab, b's run moved there. The runs that share
        an a slab cover disjoint ranges of it, so each takes the previous
        run's marked slab as its a."""
        self._require("collide_with_marking")
        o = self._other_slabs(other)
        if not isinstance(o[0], ProbVoxelMap):
            raise TypeError(f"cannot collide ProbVoxelMap with {type(other)}")
        t = float_to_probability(coll_threshold)
        lin = insert_ops.linear_offset(tuple(int(v) for v in offset), self.dims)
        marked = [s.data for s in self.slabs]
        counts = []
        for kb, ka, a0, b0, n in _segments(len(self.slabs), self.slabs[0].voxelmap_size, lin):
            cnt, marked[ka] = collide_cuda.count_and_mark_prob_run(marked[ka], o[kb].data.to(self.devices[ka]), t, t,
                                                                   a0, b0, n)
            counts.append(cnt)
        count = psum(counts, self.device) if counts else torch.zeros((), dtype=torch.int64, device=self.device)
        return count, self._with([map_replace(s, data=d) for s, d in zip(self.slabs, marked)])

    def collide_with_resolution(self, other, coll_threshold: float = 1.0, resolution_level: int = 0,
                                offset=(0, 0, 0)) -> torch.Tensor:
        """collideWithResolution slab by slab: occupancy OR-pooled over
        2^level cubes (ops/collide.count_with_resolution). The left map's
        geometric offset reads its rows from the slabs that hold them; a
        cube that crosses a slab boundary is ORed from the slabs' partial
        cubes on the mesh's first device."""
        self._require("collide_with_resolution")
        t = float_to_probability(coll_threshold)
        o = self._other_slabs(other)
        if issubclass(self._base_cls, ProbVoxelMap):
            mine = [collide_ops.prob_occupied(s.data, t) for s in self.slabs]
        else:
            mine = [s.occupied_mask() for s in self.slabs]
        if isinstance(o[0], ProbVoxelMap):
            theirs = [collide_ops.prob_occupied(s.data, t) for s in o]
        elif isinstance(o[0], BitVectorVoxelMap):
            theirs = [s.occupied_mask() for s in o]
        else:
            raise TypeError(f"cannot collide {self._base_cls.__name__} with {type(other)}")
        dx, dy, dz = self.dims
        zl, sc = self.slab_dz, 1 << int(resolution_level)
        ox, oy, oz = (int(v) for v in offset)
        a3 = [m.reshape(zl, dy, dx) for m in mine]
        counts, partial = [], {}
        for k, (dev, z0) in enumerate(zip(self.devices, self.z0s)):
            a = collide_ops._shift3d(gather_rows(a3, z0 + oz, z0 + oz + zl, dev, False), (ox, oy, 0))
            lead = z0 % sc  # the rows of the first cube that lie below the slab
            pad = torch.zeros((lead, dy, dx), dtype=torch.bool, device=dev)
            pa = collide_ops.or_pool(torch.cat([pad, a]), resolution_level)
            pb = collide_ops.or_pool(torch.cat([pad, theirs[k].reshape(zl, dy, dx)]), resolution_level)
            whole = [j for j in range(pa.shape[0])
                     if (z0 // sc + j) * sc >= z0 and min((z0 // sc + j + 1) * sc, dz) <= z0 + zl]
            if whole:
                counts.append((pa[whole[0]:whole[-1] + 1] & pb[whole[0]:whole[-1] + 1]).sum(dtype=torch.int64))
            for j in range(pa.shape[0]):
                if j not in whole:
                    ca, cb = partial.get(z0 // sc + j, (False, False))
                    partial[z0 // sc + j] = (pa[j].to(self.device) | ca, pb[j].to(self.device) | cb)
        counts += [(ca & cb).sum(dtype=torch.int64) for ca, cb in partial.values()]
        return psum(counts, self.device)

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

    # -- the distance tier -------------------------------------------------------
    def merge_occupied(self, prob_map, occupancy_threshold: float = 0.5) -> "ShardedDenseMap":
        """mergeOccupied: a (sharded or plain) prob map's occupied voxels
        become obstacles, slab against slab."""
        self._require("merge_occupied")
        t = float_to_probability(occupancy_threshold)
        return self._with([map_replace(slab, data=edt.with_obstacles(slab.data, p.data.to(torch.int32) >= t,
                                                                     slab.dims, z0))
                           for (slab, _, z0), p in zip(self._zipped(), self._other_slabs(prob_map))])

    def _packed(self) -> list:
        return [s.data for s in self.slabs]

    def _with_packed(self, packed) -> "ShardedDenseMap":
        return self._with([map_replace(s, data=p) for s, p in zip(self.slabs, packed)])

    def parallel_banding(self, m1: int = 1, m2: int = 1, m3: int = 1) -> "ShardedDenseMap":
        """The exact EDT slab by slab (parallel/sharded_edt_exact: the Z
        flood with the slabs' carries, then K5 per slab along Y and X),
        bit-identical to the single-device call. m1/m2/m3 are accepted for
        API parity only."""
        self._require("parallel_banding")
        del m1, m2, m3
        # bound_c only checks the slab depth in the reference; no bound is computed here
        return self._with_packed(build_sharded_parallel_banding(self.mesh, self.dims, bound_c=1)(self._packed()))

    def jump_flood(self, extra_rounds: int = 1) -> "ShardedDenseMap":
        """jumpFlood3D by the route the single-device call takes on this
        value's first device (DistanceVoxelMap._jump_flood_route): the exact
        EDT (`parallel_banding`, K5 per slab), or a JFA with the
        single-device rules (parallel/sharded_edt.jump_flood_slabs: the
        coarse flood wraps, the repair stops at ops/edt.REPAIR_MAX_ROUNDS),
        so the packed grid equals the single-device call's."""
        self._require("jump_flood")
        route = DistanceVoxelMap._jump_flood_route(self.dims, extra_rounds, self.device)
        if route == "banding":
            return self.parallel_banding()
        if route == "multires":
            return self._with_packed(sharded_edt.jump_flood_slabs(self._packed(), self.dims, self.devices,
                                                                  multires=True))
        return self._with_packed(sharded_edt.jump_flood_slabs(self._packed(), self.dims, self.devices, extra_rounds))

    def _site_masks(self) -> list:
        """Per slab, the voxels that hold their own (global) coordinates."""
        return [edt.squared_distance_grid(s.data, s.dims, z0) == 0 for s, _, z0 in self._zipped()]

    def exact_separable(self) -> "ShardedDenseMap":
        """The exact EDT as ops/edt.exact_separable computes it: the Z scans
        with the slabs' carries (sharded_edt_exact.flood_z_slabs), then the
        Meijster envelopes along Y and X per slab."""
        self._require("exact_separable")
        return self._with_packed([edt.separable_yx(g1, pay1).reshape(-1)
                                  for g1, pay1 in flood_z_slabs(self._site_masks(), self.device)])

    def exact_distances(self, obstacle_coords) -> "ShardedDenseMap":
        """exactDistances3D brute force, each slab's voxels at their global
        positions."""
        self._require("exact_distances")
        return self._with_packed([edt.exact_distances(to_device(obstacle_coords, torch.int32, dev), s.dims,
                                                      z_offset=z0) for s, dev, z0 in self._zipped()])

    def squared_distances(self) -> torch.Tensor:
        """int32[Z, Y, X] squared obstacle distances, a whole-grid tensor."""
        self._require("squared_distances")
        return self._join([edt.squared_distance_grid(s.data, s.dims, z0) for s, _, z0 in self._zipped()], dim=0)

    def get_squared_obstacle_distance(self, x: int, y: int, z: int) -> torch.Tensor:
        """The squared distance at one voxel, read on the slab holding it
        (a 0-d int32 tensor on the mesh's first device)."""
        self._require("get_squared_obstacle_distance")
        dx, dy, _ = self.dims
        i = int(z) * dx * dy + int(y) * dx + int(x)
        k, n = i // self.slabs[0].voxelmap_size, self.slabs[0].voxelmap_size
        if not 0 <= k < len(self.slabs):
            raise IndexError(f"voxel ({x}, {y}, {z}) lies outside the map {self.dims}")
        local = torch.full((), i - k * n, dtype=torch.int64, device=self.devices[k])
        return edt.squared_distance_at(self.slabs[k].data, local, self.slabs[k].dims, self.z0s[k]).to(self.device)

    def get_obstacle_distance(self, x: int, y: int, z: int) -> torch.Tensor:
        return torch.sqrt(self.get_squared_obstacle_distance(x, y, z).to(torch.float32))

    def min_distance_to(self, points) -> torch.Tensor:
        """The least metric distance from any query point to its nearest
        obstacle (points outside the map count as MAX_OBSTACLE_DISTANCE): the
        min over the slabs of each slab's min over the points it holds."""
        self._require("min_distance_to")
        mins = []
        for s, dev, z0 in self._zipped():
            idx, _ = insert_ops.voxelize(to_device(points, F32, dev), self.side_length, s.dims, z0)
            mins.append(edt.min_squared_distance_at(s.data, idx, s.dims, z0).to(self.device))
        return torch.sqrt(torch.stack(mins).min().to(torch.float32)) * self.side_length

    def extract_distances(self, robot_radius: int = 0) -> torch.Tensor:
        """int8 free-space bytes, a whole-grid tensor."""
        self._require("extract_distances")
        return self._join([edt.extract_byte_distances(s.data, s.dims, robot_radius, z0)
                           for s, _, z0 in self._zipped()])

    def init_floodfill(self) -> torch.Tensor:
        """The Manhattan distance field (ops/edt.manhattan_distance), a
        whole-grid tensor: the z sweeps' carries cross the slabs as prefix
        and suffix minima (sharded_edt_exact.l1_z_slabs), the y and x sweeps
        stay in their slab."""
        self._require("init_floodfill")
        cap = 32767
        d = [torch.where(m, 0, cap).to(torch.int32) for m in self._site_masks()]
        out = []
        for g in l1_z_slabs(d, self.device):
            for axis in (1, 2):
                g = edt.l1_pass(g, axis)
            out.append(torch.clamp(g, max=cap).reshape(-1))
        return self._join(out)

    def obstacle_mask(self) -> torch.Tensor:
        """bool[N]: the obstacle voxels, a whole-grid tensor."""
        self._require("obstacle_mask")
        return self._join([m.reshape(-1) for m in self._site_masks()])

    def differences(self, other) -> torch.Tensor:
        """differences3D: the voxels whose squared distances disagree with a
        (sharded or plain) distance map's, summed over the slabs."""
        self._require("differences")
        return psum([edt.differences(s.data, o.data, s.dims, z0)
                     for (s, _, z0), o in zip(self._zipped(), self._other_slabs(other))], self.device)

    # -- queries and files --------------------------------------------------
    def occupancy(self) -> torch.Tensor:
        self._require("occupancy")
        return self._join([s.occupancy() for s in self.slabs])

    def occupied_mask(self, *args, **kwargs) -> torch.Tensor:
        self._require("occupied_mask")
        return self._join([s.occupied_mask(*args, **kwargs) for s in self.slabs])

    def get_bit_mask(self, meaning) -> torch.Tensor:
        self._require("get_bit_mask")
        return self._join([s.get_bit_mask(meaning) for s in self.slabs])

    def as_3d(self) -> torch.Tensor:
        """The voxel data as [..., Z, Y, X], a whole-grid tensor."""
        dx, dy, dz = self.dims
        data = self._join([s.data for s in self.slabs])
        return data.reshape(data.shape[:-1] + (dz, dy, dx))

    def clone(self) -> "ShardedDenseMap":
        return self._with([s.clone() for s in self.slabs])

    def memory_usage(self) -> int:
        """Device bytes of voxel data over all slabs: the single map's."""
        return sum(s.memory_usage() for s in self.slabs)

    def print_voxel_map_data(self, max_entries: int = 32) -> str:
        """printVoxelMapData's text, the single map's: every slab copied into
        one host buffer, one wait for the devices."""
        datas = [s.data for s in self.slabs]
        pinned = any(d.is_cuda for d in datas)
        host = torch.empty(datas[0].shape[:-1] + (self.voxelmap_size,), dtype=datas[0].dtype, pin_memory=pinned)
        at = 0
        for d in datas:
            host[..., at:at + d.shape[-1]].copy_(d, non_blocking=pinned)
            at += d.shape[-1]
        for dev in {d.device for d in datas if d.is_cuda}:
            torch.cuda.current_stream(dev).synchronize()
        return print_voxel_dump(host.numpy(), self._base_cls, self.dims, max_entries)

    def write_to_disk(self, path) -> bool:
        """writeToDisk: the single map's bytes, the header then each slab's
        body in turn (one host read a slab, never the whole map gathered)."""
        map_io.write_voxel_map_slabs(self, self.slabs, path)
        return True

    def read_from_disk(self, path) -> "ShardedDenseMap":
        """readFromDisk: the file's map, each slab read onto its device: a
        value sharded over the same mesh. A file of another MapType raises."""
        map_type = map_io._file_map_type(path)
        if map_type != MapType(int(self.map_type)):
            raise ValueError(f"file holds {map_type.name}, map is {MapType(int(self.map_type)).name}")
        return read_sharded_map(path, self.mesh, self.axis)


def _per_slab(name: str):
    def method(self, *args, **kwargs):
        self._require(name)
        return self._with([getattr(s, name)(*args, **kwargs) for s in self.slabs])

    method.__name__ = name
    method.__doc__ = f"`{name}` voxel by voxel, so slab by slab; the result stays sharded."
    return method


for _name in ("clear_map", "clear_voxel_meaning", "clear_bit", "clear_bits", "clear_collision_flags",
              "shift_left_swept_volume_ids", "fill_pba_uninit"):
    setattr(ShardedDenseMap, _name, _per_slab(_name))


# -- hierarchical pyramids -------------------------------------------------------
def _rebuild_levels(status0, split: list, device) -> list:
    """A pyramid over level 0 (a list of slabs, or one tensor), level l from
    level l - 1 as `split[l]` lays it out: each split level slab by slab (a
    2-cube never crosses a slab where the coarser level still splits), the
    first whole level from the finer one joined on `device`, the tail from
    that."""
    pyr, cur = [status0], status0
    for splits in split[1:]:
        if isinstance(cur, list) and not splits:
            cur = torch.cat([c.to(device) for c in cur])
        cur = [_build_pyramid(c, 1)[1] for c in cur] if isinstance(cur, list) else _build_pyramid(cur, 1)[1]
        pyr.append(cur)
    return pyr


class ShardedPyramid(_ShardedValue):
    """A dense hierarchical map (HierarchicalBitMap, HierarchicalProbMap)
    with every pyramid level whose z extent divides over the mesh split into
    slabs (the prob tier's occupancy grid with level 0) and the coarse tail
    kept once on the mesh's first device. Every public method of the class
    has a slab form here, equal to the single-device call: level 0 (and the
    occupancy) is updated slab by slab in the global frame and the levels
    above are rebuilt across the slabs. A bit pyramid whose padded z extent
    does not divide the mesh keeps every level whole on the first device, as
    the reference's sharded value replicates it; its methods run there."""

    def __init__(self, base_cls, dims: Dims, side_length: float, levels: int, map_type, pyramid, occupancy,
                 mesh: GridMesh, axis: str):
        self._init_common(base_cls, mesh, axis, dims, side_length, map_type)
        self.levels = int(levels)
        self.pyramid = list(pyramid)  # per level: a list of slabs, or one tensor
        self.occupancy = occupancy  # slabs of the prob tier's log-odds, or None

    def _prob(self) -> bool:
        return issubclass(self._base_cls, HierarchicalProbMap)

    def _parts(self, lvl: int = 0) -> list:
        """Level `lvl` as (part [zl, Y, X], its device, its first row): the
        slabs of a split level, else the whole level on the first device."""
        lv = self.pyramid[lvl]
        if not isinstance(lv, list):
            return [(lv, self.device, 0)]
        return [(p, d, k * p.shape[0]) for k, (p, d) in enumerate(zip(lv, self.devices))]

    @staticmethod
    def _local(part: torch.Tensor) -> Dims:
        """A slab's (padded) dims (x, y, z) from its [z, y, x] tensor."""
        zl, py, px = part.shape
        return (px, py, zl)

    def _with_level0(self, status0: list, occupancy=None) -> "ShardedPyramid":
        """The pyramid rebuilt from new level-0 parts, laid out as this one."""
        l0 = status0 if isinstance(self.pyramid[0], list) else status0[0]
        pyr = _rebuild_levels(l0, [isinstance(lv, list) for lv in self.pyramid], self.device)
        return ShardedPyramid(self._base_cls, self.dims, self.side_length, self.levels, self.map_type, pyr,
                              occupancy, self.mesh, self.axis)

    def _with_occupancy(self, occupancy: list) -> "ShardedPyramid":
        """The prob tier rebuilt from new occupancy slabs."""
        return self._with_level0([_status_from_occupancy(o) for o in occupancy], occupancy)

    # -- properties and maintenance --------------------------------------------
    @property
    def padded_dims(self) -> Dims:
        _, py, px = self._parts(0)[0][0].shape
        return (px, py, sum(p.shape[0] for p, _, _ in self._parts(0)))

    @property
    def status(self) -> torch.Tensor:
        """The bit tier's status grid, a whole-grid tensor: level 0's slabs
        joined on the mesh's first device."""
        if self._prob():
            raise AttributeError("'HierarchicalProbMap' object has no attribute 'status'")
        return torch.cat([p.to(self.device) for p, _, _ in self._parts(0)])

    def fine_slabs(self) -> list:
        """The ground truth's z-slabs, in z order: the prob tier's occupancy,
        the bit tier's level 0 (one whole part where level 0 does not split)."""
        return list(self.occupancy) if self._prob() else [p for p, _, _ in self._parts(0)]

    def to(self, device):
        raise TypeError("a sharded pyramid stays on its mesh: gather(device) makes a single-device copy, "
                        "shard_map_value(m, mesh) lays a map over another mesh")

    def gather(self, device=None):
        """A single-device copy of the whole map on `device` (default: the
        mesh's first device)."""
        device = self.device if device is None else device
        pyr = tuple(torch.cat([p.to(device) for p in lv]) if isinstance(lv, list) else lv.to(device)
                    for lv in self.pyramid)
        if self._prob():
            occ = torch.cat([p.to(device) for p in self.occupancy])
            return HierarchicalProbMap(occ, pyr, self.dims, self.side_length, self.levels)
        return HierarchicalBitMap(pyr, self.dims, self.side_length, self.levels)

    def memory_usage(self) -> int:
        """Device bytes over every slab and the tail: the single map's."""
        tensors = [p for lv in self.pyramid for p in (lv if isinstance(lv, list) else [lv])]
        tensors += list(self.occupancy) if self._prob() else []
        return int(sum(t.numel() * t.element_size() for t in tensors))

    needs_rebuild = _PyramidQueries.needs_rebuild
    rebuild = _PyramidQueries.rebuild
    clear_collision_flags = _PyramidQueries.clear_collision_flags
    clear_voxel_meaning = _PyramidQueries.clear_voxel_meaning

    def propagate(self) -> "ShardedPyramid":
        """NTree::propagate: the levels rebuilt from level 0's slabs (the prob
        tier's status from its occupancy slabs)."""
        if self._prob():
            return self._with_occupancy(self.occupancy)
        return self._with_level0([p for p, _, _ in self._parts(0)])

    def check_tree(self) -> bool:
        """NTree::checkTree: each split level against its finer slab's 2x2x2
        fusion, the first whole level against the joined finer one, the tail
        as the single tier checks it; the verdicts land on the mesh's first
        device and are read once."""
        want = _rebuild_levels(self.pyramid[0], [isinstance(lv, list) for lv in self.pyramid], self.device)
        oks = []
        for w, have in zip(want[1:], self.pyramid[1:]):
            for a, b in zip(w if isinstance(w, list) else [w], have if isinstance(have, list) else [have]):
                if a.shape != b.shape:
                    return False
                oks.append((a == b).all().to(self.device))
        return bool(torch.stack(oks).all()) if oks else True

    def clear_map(self) -> "ShardedPyramid":
        """The pristine UNKNOWN map, every level filled in place of a rebuild."""
        prob = self._prob()
        status = NS_UNKNOWN
        if prob:
            status = int(_status_from_occupancy(torch.full((1,), UNKNOWN_PROBABILITY, dtype=torch.int8))[0])
        pyr = [[torch.full_like(p, status) for p in lv] if isinstance(lv, list) else torch.full_like(lv, status)
               for lv in self.pyramid]
        occ = [torch.full_like(p, UNKNOWN_PROBABILITY) for p in self.occupancy] if prob else None
        return ShardedPyramid(self._base_cls, self.dims, self.side_length, self.levels, self.map_type, pyr, occ,
                              self.mesh, self.axis)

    # -- inserts ------------------------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED, static_map: bool = True):
        """The single-device point insert, slab by slab on level 0 (points
        voxelized in the global frame, z shifted by the slab's first row as
        an integer), then the pyramid rebuilt across the slabs. The
        deterministic tier sets hard statuses tagged by `static_map`; the
        probabilistic one stores the meaning's probability."""
        pts = to_device(points, F32, self.device).reshape(-1, 3)
        if self._prob():
            occ = []
            for (_, dev, z0), o in zip(self._parts(0), self.occupancy):
                flat, _ = insert_ops.insert_prob(o.reshape(-1), pts.to(dev), self.side_length, self._local(o), meaning,
                                                 z0)
                occ.append(flat.reshape(o.shape))
            return self._with_occupancy(occ)
        occ_bit = NS_FREE if int(meaning) == int(BitVoxelMeaning.eBVM_FREE) else NS_OCCUPIED
        flag = NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP
        status0 = []
        for s0, dev, z0 in self._parts(0):
            hits = voxel_hits(pts.to(dev), self.side_length, self._local(s0), z0)
            status0.append(hard_status(s0.reshape(-1), hits, occ_bit, flag).reshape(s0.shape))
        return self._with_level0(status0)

    insert_meta_point_cloud = _PyramidQueries.insert_meta_point_cloud

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """(new map, ok device bool): the meta insert, ok False where two
        sub-clouds share a voxel of the padded grid (the OR of the slabs'
        clashes, on the mesh's first device)."""
        clash = torch.zeros((), dtype=torch.bool, device=self.device)
        if with_self_collision_test:
            for s0, dev, z0 in self._parts(0):
                clash = clash | insert_ops.self_collision_clash(robot_links.to(dev), self.side_length,
                                                                self._local(s0), z0).to(self.device)
        return self.insert_meta_point_cloud(robot_links), ~clash

    def build(self, points, free_bounding_box: bool = False) -> "ShardedPyramid":
        """NTree::build slab by slab: the cleared map; with free_bounding_box
        the points' voxel box (taken in the global frame) set FREE on every
        slab it reaches (the bit tier tagged ns_STATIC_MAP); then the points
        inserted."""
        m = self.clear_map()
        points = to_device(points, F32, self.device).reshape(-1, 3)
        if free_bounding_box:
            if self._prob():
                m = m._with_occupancy([store_meaning(o.reshape(-1), bbox_mask(points, self.side_length,
                                                                               self._local(o), dev, z0),
                                                     BitVoxelMeaning.eBVM_FREE).reshape(o.shape)
                                       for (_, dev, z0), o in zip(m._parts(0), m.occupancy)])
            else:
                m = m._with_level0([hard_status(s0.reshape(-1), bbox_mask(points, self.side_length, self._local(s0),
                                                                          dev, z0),
                                                NS_FREE, NS_STATIC_MAP).reshape(s0.shape)
                                    for s0, dev, z0 in m._parts(0)])
        return m.insert_point_cloud(points)

    # -- sensing ------------------------------------------------------------------
    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "ShardedPyramid":
        """Projective fusion over the padded grid's z-slabs, in the global
        frame, each slab carved with its first row as its z offset (K3 once a
        slab; with carve_pool > 1 K6's carve once a slab against the frame's
        one pooled table). The prob tier runs the dense depth insert on its
        occupancy slabs; the bit tier sets FREE where carved and not hit,
        then OCCUPIED at the hits, both tagged DYNAMIC. Then one rebuild."""
        pool = int(carve_pool)
        fx, fy, cx, cy, inv = _sensor_scalars(sensor)
        depth = to_device(depth, F32, self.device)
        pose = to_device(sensor.pose(), F32, self.device)
        pooled = raycast_cuda.min_pool_depth(depth, pool, inv) if pool > 1 else None
        if self._prob():
            occ = []
            for (_, dev, z0), o in zip(self._parts(0), self.occupancy):
                flat = raycast.insert_depth_image(
                    o.reshape(-1), depth.to(dev), pose.to(dev), fx, fy, cx, cy, self.side_length, self._local(o),
                    invalid_value=inv, carve_pool=pool, z_index_offset=z0,
                    pooled_depth=None if pooled is None else pooled.to(dev))
                occ.append(flat.reshape(o.shape))
            return self._with_occupancy(occ)
        world = depth_world_points(depth, pose, sensor)
        status0 = []
        for s0, dev, z0 in self._parts(0):
            local = self._local(s0)
            hits = voxel_hits(world.to(dev), self.side_length, local, z0)
            free = raycast.carve(depth.to(dev), pose.to(dev), fx, fy, cx, cy, self.side_length, local, inv, pool,
                                 z0, None if pooled is None else pooled.to(dev))
            status0.append(sensor_status(s0.reshape(-1), free & ~hits, hits).reshape(s0.shape))
        return self._with_level0(status0)

    def insert_point_cloud_with_free_space(self, points, sensor_origin=(0.0, 0.0, 0.0),
                                           max_steps: int = 256) -> "ShardedPyramid":
        """The DDA sensor insert over the padded grid's slabs: the rays walked
        once, every step's voxels counted on the slab that owns them
        (raycast.ray_crossing_counts_slabs). The prob tier takes the dense
        DDA update on its occupancy slabs; the bit tier sets the crossed
        cells FREE, then the hits OCCUPIED."""
        origin = tuple(float(v) for v in sensor_origin)
        pts = to_device(points, F32, self.device).reshape(-1, 3)
        parts = self._parts(0)
        free = raycast.ray_crossing_counts_slabs(origin, pts, self.side_length, self.padded_dims,
                                                 [dev for _, dev, _ in parts], max_steps)
        if self._prob():
            return self._with_occupancy([
                raycast.insert_sensor_data(o.reshape(-1), origin, pts.to(dev), self.side_length, self._local(o),
                                           enable_raycasting=True, max_steps=max_steps, z_index_offset=z0,
                                           free_counts=fc).reshape(o.shape)
                for (_, dev, z0), o, fc in zip(parts, self.occupancy, free)])
        return self._with_level0([
            sensor_status(s0.reshape(-1), fc > 0, voxel_hits(pts.to(dev), self.side_length, self._local(s0), z0))
            .reshape(s0.shape) for (s0, dev, z0), fc in zip(parts, free)])

    # -- probes and collides -------------------------------------------------------
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

    probe = _PyramidQueries.probe

    def probe_clamped(self, coords: torch.Tensor, min_level: int = 0):
        return decode_status_flags(self._descend(int(min_level), coords, in_range=True))

    def _collide_probe(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """Probe self at other's voxel list entries or dense voxels + offset."""
        coords, valid = query_coords_of(other)
        return count_probe_hits(self.probe_clamped, coords.to(self.device), valid.to(self.device), self.dims,
                                int(min_level), offset)

    collide_with = _PyramidQueries.collide_with
    collide_with_resolution = _PyramidQueries.collide_with_resolution
    collide_with_counting_unknown = _PyramidQueries.collide_with_counting_unknown

    def _rows_of(self, other, lvl: int) -> list:
        """The other pyramid's (plain or sharded) level `lvl`, cut as this
        one's level `lvl` is, each part on its device."""
        theirs = other.pyramid[lvl]
        out = []
        for p, dev, z0 in self._parts(lvl):
            if isinstance(theirs, list):
                out.append(gather_rows(theirs, z0, z0 + p.shape[0], dev, 0))
            else:
                out.append(theirs[z0:z0 + p.shape[0]].to(dev))
        return out

    def collide_with_hierarchical(self, other, min_level: int = 0) -> torch.Tensor:
        """NTree x NTree: the cells occupied in both hierarchies at level
        `min_level`, an AND count a slab where the level splits (the other
        pyramid, plain or sharded, cut the same way), one where it is whole,
        summed on the mesh's first device."""
        if other.padded_dims != self.padded_dims:
            raise ValueError("hierarchies must share dimensions")
        lvl = int(min_level)
        counts = [(((a & NS_OCCUPIED) != 0) & ((b & NS_OCCUPIED) != 0)).sum(dtype=torch.int64)
                  for (a, _, _), b in zip(self._parts(lvl), self._rows_of(other, lvl))]
        return psum(counts, self.device)

    # -- queries and files -----------------------------------------------------------
    def extract_occupied_coords(self) -> np.ndarray:
        """int32[K, 3] (x, y, z) of the occupied voxels inside dims, in z, y, x
        order: each slab's compacted mask (two host reads a slab, O(K)
        bytes), its indices moved by the slab's first row."""
        px, py, _ = self.padded_dims
        idx = [compacted_nonzero((s0 & STATUS_OCCUPANCY_MASK) == NS_OCCUPIED) + z0 * px * py
               for s0, _, z0 in self._parts(0)]
        return occupied_coords_of(np.concatenate(idx), self.padded_dims, self.dims)

    def write_to_disk(self, path) -> bool:
        """writeToDisk: the single map's bytes, the header then each slab's
        fine rows in turn (one host read a slab, never the map gathered)."""
        map_io.write_hierarchical_map(self, path)
        return True

    def read_from_disk(self, path):
        """readFromDisk: the file's map of this MapType, a dense body read
        slab by slab onto this value's mesh; a paged body as the single call
        reads it (a paged map on the mesh's first device)."""
        map_type = map_io._file_map_type(path)
        if map_type != MapType(int(self.map_type)):
            raise ValueError(f"file holds {map_type.name}, map is {MapType(int(self.map_type)).name}")
        if map_io.is_paged_octree(path):
            return map_io.read_hierarchical_map(path, device=self.device)
        return read_sharded_map(path, self.mesh, self.axis)


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
        prob = isinstance(m, HierarchicalProbMap)
        _check_padded_divides(prob, m.padded_dims[2], nz, axis)

        def split_level(lv):
            return split_slabs(lv, devices, axis=0) if lv.shape[0] % nz == 0 else lv.to(devices[0])

        occ = split_slabs(m.occupancy, devices, axis=0) if prob else None
        return ShardedPyramid(type(m), m.dims, m.side_length, m.levels, m.map_type,
                              [split_level(lv) for lv in m.pyramid], occ, mesh, axis)
    raise TypeError(f"no sharding layout for {type(m)}")


def _check_padded_divides(prob: bool, padded_z: int, nz: int, axis: str) -> None:
    """The prob tier's occupancy grid is always split, as the reference's
    device_put of it is, so its padded z extent must divide the mesh. (A bit
    pyramid whose padded extent does not divide keeps every level whole,
    replicated in the reference.)"""
    if prob and padded_z % nz:
        raise ValueError(f"a HierarchicalProbMap's padded z extent {padded_z} must divide the mesh '{axis}' axis "
                         f"({nz}): its occupancy grid is split into z-slabs")


def read_sharded_map(path, mesh: GridMesh, axis: str = "z"):
    """A dense map file (utils/io's VoxelMap format) or a dense hierarchy's
    octree file read as a value sharded over `mesh`'s `axis`, each slab's
    body read straight onto its device: never the whole map on one device.
    A hierarchy's levels are rebuilt across the slabs, laid out as
    shard_map_value lays them."""
    devices = _axis_devices(mesh, axis)
    if map_io._file_map_type(path) not in map_io.OCTREE_TYPES:
        maps, dims = map_io.read_voxel_map_slabs(path, devices)
        return ShardedDenseMap(maps, mesh, axis, dims)
    map_type, dims, side, levels, fine = map_io.read_hierarchical_slabs(path, devices)
    prob = map_type == MapType.MT_PROBAB_OCTREE
    padded_z, nz = sum(p.shape[0] for p in fine), len(devices)
    _check_padded_divides(prob, padded_z, nz, axis)
    if dims[2] % nz:
        raise ValueError(f"map dimz {dims[2]} must divide the mesh '{axis}' axis ({nz}) for z-slab sharding")
    status0 = [_status_from_occupancy(p) for p in fine] if prob else fine
    split = [(padded_z >> lvl) % nz == 0 for lvl in range(levels + 1)]
    pyr = _rebuild_levels(status0 if split[0] else status0[0], split, devices[0])
    return ShardedPyramid(HierarchicalProbMap if prob else HierarchicalBitMap, dims, side, levels, map_type, pyr,
                          fine if prob else None, mesh, axis)


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
