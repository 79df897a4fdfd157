"""Dense voxel maps (equivalents of voxelmap/TemplateVoxelMap + subclasses).

Counterpart of gpu_voxels_tpu/maps/voxelmap.py. Voxel data is a flat tensor
over N = dimx*dimy*dimz with the reference's linear addressing
(index = z*dimx*dimy + y*dimx + x, TemplateVoxelMap.h:258), which makes the
reference's signed-pointer-offset collision semantics a pair of flat slices.

  ProbVoxelMap       int8[N] log-odds                 (voxelmap/ProbVoxelMap)
  BitVectorVoxelMap  int32[8, N] bit planes + uint8[N] occupancy summary
                                                      (voxelmap/BitVoxelMap)
  CountingVoxelMap   int8[N] density counter  (dense variant of CountingVoxel)

The public methods are functional, as in the reference: each returns a new
map (or a count) and leaves its inputs unchanged; the facade rebinds names.
Counts are 0-d int64 tensors on the map's device, so a whole
sense -> insert -> collide cycle runs without a host sync until the caller
reads a number.

Routing: prob x prob `collide_with` runs CUDA kernel K1 and
`collide_with_marking` K2; bit x bit `collide_with_types` and
`collide_with_bitcheck` run K4 at sv_offset 0 and windows up to 24
(ops/collide_cuda), gated by both maps' occupancy summaries: every method
keeps a map's summary a superset of its plane fold, or K4 would drop the
hits of a voxel the summary misses. Bit x prob and the plain bit x bit count read the bit
map's occupancy summary in plain torch, as the reference does in XLA; a bit
map without a summary (`occ=None`, raw planes) folds its planes instead, and
its bit x bit count runs CUDA kernel K7. The rest of the swept-volume domain
(sv_offset != 0, windows 25..31) runs the plain full-domain check.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from dataclasses import replace as _dc_replace
from typing import Optional, Tuple

import numpy as np
import torch

from .. import bitops, probability
from ..constants import UNKNOWN_PROBABILITY, BitVoxelMeaning, MapType, float_to_probability
from ..geometry import transforms
from ..ops import collide as collide_ops
from ..ops import collide_cuda
from ..ops import insert as insert_ops
from ..ops import raycast
from ..utils import resolve_device, to_device
from ..utils.io import DiskIO
from ..utils.logging import log_stream

_log = log_stream("voxelmap")

Dims = Tuple[int, int, int]


def replace(obj, **changes):
    """dataclasses.replace that also carries the stored Sensor: it survives
    every operation that derives a map, like the reference's m_sensor member
    (TemplateVoxelMap.hpp:836-905)."""
    new = _dc_replace(obj, **changes)
    sensor = getattr(obj, "_sensor", None)
    if sensor is not None:
        object.__setattr__(new, "_sensor", sensor)
    return new


def _n(dims: Dims) -> int:
    return dims[0] * dims[1] * dims[2]


def takes_sharded_operand(method):
    """A dense map's method `(self, other, ...)` that also takes `other` as a
    slab-sharded dense value (parallel/shard_value.ShardedDenseMap), as the
    reference's methods take the same map sharded: self is split as other
    is and the slab form answers, in self's layout
    (shard_value.split_like_operand)."""
    @functools.wraps(method)
    def wrapper(self, other, *args, **kwargs):
        from ..parallel.shard_value import ShardedDenseMap, split_like_operand

        if isinstance(other, ShardedDenseMap):
            return split_like_operand(self, method.__name__, other, *args, **kwargs)
        return method(self, other, *args, **kwargs)

    return wrapper


def cannot_collide(cls_name: str, other) -> TypeError:
    """The refusal of an operand pair, naming the operand's map class (a
    sharded value's base class), so a plain and a sharded operand read alike."""
    from ..parallel.shard_value import operand_class

    return TypeError(f"cannot collide {cls_name} with {operand_class(other)}")


@dataclass(frozen=True, eq=False)
class _DenseMap(DiskIO):
    data: torch.Tensor
    dims: Dims
    side_length: float
    _default_value = 0  # the "empty" voxel value print_voxel_map_data skips

    @property
    def voxelmap_size(self) -> int:
        return _n(self.dims)

    @property
    def dimensions(self) -> Dims:
        return self.dims

    @property
    def metric_dimensions(self) -> Tuple[float, float, float]:
        return tuple(d * self.side_length for d in self.dims)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def memory_usage(self) -> int:
        """getMemoryUsage (GpuVoxelsMap.h:253): device bytes of voxel data."""
        total = self.data.numel() * self.data.element_size()
        occ = getattr(self, "occ", None)
        if occ is not None:
            total += occ.numel() * occ.element_size()
        return int(total)

    def as_3d(self) -> torch.Tensor:
        """View as [Z, Y, X] (x fastest, reference layout)."""
        x, y, z = self.dims
        return self.data.reshape(self.data.shape[:-1] + (z, y, x))

    def clone(self):
        """A map with copies of this map's tensors."""
        occ = getattr(self, "occ", None)
        extra = {} if occ is None else {"occ": occ.clone()}
        return replace(self, data=self.data.clone(), **extra)

    def _points(self, points) -> torch.Tensor:
        return to_device(points, torch.float32, self.device)

    @staticmethod
    def _offset(offset) -> Dims:
        return tuple(int(v) for v in offset)

    def init_sensor_settings(self, sensor) -> None:
        """initSensorSettings (TemplateVoxelMap.hpp:836-856): store the Sensor
        whose pose transforms later insert_sensor_data batches. Host state
        beside the tensors, like the reference's m_sensor member; this
        module's `replace` carries it onto every derived map, so the
        init-once / insert-repeatedly loop works across the functional API."""
        object.__setattr__(self, "_sensor", sensor)

    def update_sensor_pose(self, sensor) -> None:
        """updateSensorPose (TemplateVoxelMap.hpp:858-876): refresh the stored
        sensor's position and orientation; raises if none is stored."""
        cur = getattr(self, "_sensor", None)
        if cur is None:
            raise RuntimeError("Initialize Sensor first! (init_sensor_settings)")
        cur.position = np.asarray(sensor.position, np.float32)
        cur.orientation_rpy = np.asarray(sensor.orientation_rpy, np.float32)

    def print_voxel_map_data(self, max_entries: int = 32) -> str:
        """printVoxelMapData (TemplateVoxelMap.hpp:282-286): a readable dump
        of the first non-default voxels, printed and returned, as the
        reference's. One host read of the whole map; values print as the
        reference's dtypes (uint32 bit planes and packed distances)."""
        return print_voxel_dump(self.data.cpu().numpy(), type(self), self.dims, max_entries)


def print_voxel_dump(arr: np.ndarray, cls, dims: Dims, max_entries: int = 32) -> str:
    """print_voxel_map_data's text of a map of class `cls` and `dims` whose
    voxel data `arr` (voxels on the last axis) is on the host; printed and
    returned."""
    if arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    changed = arr != cls._default_value
    nz = np.flatnonzero(changed if arr.ndim == 1 else changed.any(axis=0))[:max_entries]
    dx, dy, _ = dims
    lines = [f"VoxelMap dump ({cls.__name__} {dims}):"]
    for i in nz:
        x = int(i) % dx
        y = (int(i) // dx) % dy
        z = int(i) // (dx * dy)
        lines.append(f"  ({x},{y},{z}) = {arr[..., int(i)]}")
    out = "\n".join(lines)
    print(out)
    return out


@dataclass(frozen=True, eq=False)
class ProbVoxelMap(_DenseMap):
    """Dense probabilistic map; voxels are int8 log-odds, UNKNOWN = -128."""

    map_type = MapType.MT_PROBAB_VOXELMAP
    _default_value = UNKNOWN_PROBABILITY  # print_voxel_map_data skips these

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, device=None) -> "ProbVoxelMap":
        data = torch.full((_n(dims),), UNKNOWN_PROBABILITY, dtype=torch.int8, device=resolve_device(device))
        return ProbVoxelMap(data, tuple(int(d) for d in dims), float(side_length))

    def clear_map(self) -> "ProbVoxelMap":
        """kernelClearVoxelMap: reset to UNKNOWN (TemplateVoxelMap.hpp:205)."""
        return replace(self, data=torch.full_like(self.data, UNKNOWN_PROBABILITY))

    # -- insertion ----------------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "ProbVoxelMap":
        new, _ = insert_ops.insert_prob(self.data, self._points(points), self.side_length, self.dims, meaning)
        return replace(self, data=new)

    def update_occupancy(self, points, delta) -> "ProbVoxelMap":
        """Log-odds additive update for every hit voxel (sensor path)."""
        return replace(self, data=insert_ops.update_occupancy(self.data, points, delta, self.side_length, self.dims))

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "ProbVoxelMap":
        """Projective sensor update from a depth image and a Sensor: hits plus
        the exact visibility carve (ops/raycast.insert_depth_image; kernel K3
        on CUDA), or with carve_pool > 1 the pooled conservative carve (K6)."""
        new = raycast.insert_depth_image(
            self.data, depth, sensor.pose(),
            float(sensor.fx), float(sensor.fy), float(sensor.cx), float(sensor.cy),
            self.side_length, self.dims,
            invalid_value=float(sensor.invalid_value), carve_pool=int(carve_pool),
        )
        return replace(self, data=new)

    def insert_meta_point_cloud(self, meta, meanings=None) -> "ProbVoxelMap":
        """Uniform or per-subcloud meanings (TemplateVoxelMap.hpp:609-663).

        Per subcloud, each point SETS its meaning's probability in one
        scatter; on voxels shared between subclouds the LATER point wins:
        the deterministic reading of the reference's racy last-writer-wins
        kernel, equal to inserting the subclouds one by one
        (ops/insert.insert_meta_prob: an int64 scatter-max of ranked
        values, which never overflows, so the reference's per-cloud loop
        for large clouds has no counterpart)."""
        if meanings is None:
            return self.insert_point_cloud(meta.points)
        return replace(self, data=insert_ops.insert_meta_prob(self.data, meta, meanings, self.side_length, self.dims))

    def insert_meta_point_cloud_with_self_collision_check(self, meta, meaning=BitVoxelMeaning.eBVM_OCCUPIED):
        """insertMetaPointCloudWithSelfcollisionCheck (ProbVoxelMap.h): insert
        all sub-clouds; report whether two different sub-clouds hit the same
        voxel. Returns (map, self_collision device bool)."""
        clash = insert_ops.self_collision_clash(meta, self.side_length, self.dims)
        return self.insert_point_cloud(meta.points, meaning), clash

    def clear_voxel_meaning(self, meaning) -> "ProbVoxelMap":
        """clearBitVoxelMeaning (ProbVoxelMap.hpp:110-117): probabilistic maps
        only support clearing eBVM_OCCUPIED, which resets the map."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            _log.error("ProbVoxelMap only supports clearing eBVM_OCCUPIED")
            return self
        return self.clear_map()

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract; the reference stubs
        it NOT_SUPPORTED, ProbVoxelMap.hpp:104-108): insert the robot
        MetaPointCloud, optionally with the self-collision check. Returns
        (new_map, ok device bool); ok is False on a self-collision, and the
        insert is applied all the same."""
        if with_self_collision_test:
            new, clash = self.insert_meta_point_cloud_with_self_collision_check(robot_links)
            return new, ~clash
        return self.insert_meta_point_cloud(robot_links), torch.ones((), dtype=torch.bool, device=self.device)

    def insert_sensor_data(
        self,
        points,
        sensor_origin=None,
        enable_raycasting: bool = True,
        cut_real_robot: bool = False,
        robot_map=None,
        max_steps: int = 256,
    ) -> "ProbVoxelMap":
        """ProbVoxelMap::insertSensorData (ProbVoxelMap.hpp:52-102): occupied
        hits (+72) plus optional free-space carving (-10 per crossing ray).

        With an explicit `sensor_origin`, `points` are world-frame endpoints.
        With sensor_origin=None and a sensor stored by init_sensor_settings,
        `points` are sensor-frame and are transformed by the stored pose
        (the reference's copySensorDataToDevice -> transformSensorData flow,
        TemplateVoxelMap.hpp:879-905); otherwise the origin is 0. `robot_map`
        is a map with `occupied_mask()` or a bool[N] mask."""
        pts = self._points(points)
        sensor = getattr(self, "_sensor", None)
        if sensor_origin is None:
            if sensor is not None:
                pts = transforms.transform_points(to_device(sensor.pose(), torch.float32, self.device), pts)
                sensor_origin = sensor.position
            else:
                sensor_origin = (0.0, 0.0, 0.0)
        robot_mask = None
        if cut_real_robot and robot_map is not None:
            robot_mask = robot_map.occupied_mask() if hasattr(robot_map, "occupied_mask") else robot_map
        new = raycast.insert_sensor_data(
            self.data, tuple(float(v) for v in sensor_origin), pts, self.side_length, self.dims,
            enable_raycasting=enable_raycasting, cut_real_robot=cut_real_robot,
            robot_occupied_mask=robot_mask, max_steps=max_steps,
        )
        return replace(self, data=new)

    # -- collision ----------------------------------------------------------
    @takes_sharded_operand
    def collide_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith returning the collision count (ProbVoxelMap.hpp:144-155);
        prob x prob runs kernel K1 on CUDA maps."""
        t = float_to_probability(coll_threshold)
        off = self._offset(offset)
        if isinstance(other, ProbVoxelMap):
            return collide_cuda.count_prob_prob(self.data, other.data, t, t, self.dims, off)
        if isinstance(other, BitVectorVoxelMap):
            if other.occ is not None:
                return collide_ops.count_prob_occ(self.data, t, other.occ, self.dims, off)
            return collide_ops.count_prob_bit(self.data, t, other.data, self.dims, off)
        raise cannot_collide("ProbVoxelMap", other)

    @takes_sharded_operand
    def collide_with_resolution(
        self, other, coll_threshold: float = 1.0, resolution_level: int = 0, offset=(0, 0, 0)
    ) -> torch.Tensor:
        """collideWithResolution (CollisionInterfaces.h:107-127): collide at a
        2^level-coarsened resolution (ops.collide.count_with_resolution)."""
        t = float_to_probability(coll_threshold)
        mine = collide_ops.prob_occupied(self.data, t)
        if isinstance(other, ProbVoxelMap):
            theirs = collide_ops.prob_occupied(other.data, t)
        elif isinstance(other, BitVectorVoxelMap):
            theirs = other.occupied_mask()
        else:
            raise cannot_collide("ProbVoxelMap", other)
        return collide_ops.count_with_resolution(mine, theirs, resolution_level, self.dims, self._offset(offset))

    def collides_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """Boolean collisionCheck (TemplateVoxelMap.hpp:329-414), a device bool."""
        return collide_ops.any_collision(self.collide_with(other, coll_threshold, offset))

    @takes_sharded_operand
    def collide_with_marking(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)):
        """kernelCollideVoxelMapsDebug semantics: returns (count, map with
        eBVM_COLLISION inserted into colliding voxels); kernel K2 on CUDA."""
        t = float_to_probability(coll_threshold)
        if isinstance(other, ProbVoxelMap):
            cnt, new = collide_cuda.count_and_mark_prob(
                self.data, other.data, t, t, self.dims, self._offset(offset)
            )
            return cnt, replace(self, data=new)
        raise cannot_collide("ProbVoxelMap", other)

    # -- queries ------------------------------------------------------------
    def occupancy(self) -> torch.Tensor:
        return self.data

    def occupied_mask(self, threshold: float = 0.5) -> torch.Tensor:
        return collide_ops.prob_occupied(self.data, float_to_probability(threshold))

    @takes_sharded_operand
    def merge(self, other: "ProbVoxelMap") -> "ProbVoxelMap":
        """Voxel::reduce = saturating occupancy add (ProbabilisticVoxel.hpp:94-101).
        UNKNOWN voxels in `other` contribute nothing."""
        delta = torch.where(probability.is_unknown(other.data), 0, other.data.to(torch.int32))
        return replace(self, data=probability.update_occupancy(self.data, delta))


@dataclass(frozen=True, eq=False)
class BitVectorVoxelMap(_DenseMap):
    """Dense 256-bit deterministic map; data is int32[8, N] bit planes.

    `occ` is the maintained occupancy summary: uint8[N], 1 exactly where the
    voxel is !noneButEmpty (eBVM_FREE masked out, BitVector.h:184-198).
    Every mutation keeps it coherent, so plain collides read 1 byte per
    voxel instead of folding 32. As in the reference, a map built with
    occ=None (hand-constructed planes) falls back to the plane fold
    everywhere (bit x bit counts through CUDA kernel K7), and operations
    then propagate None; `from_planes` computes the summary."""

    occ: Optional[torch.Tensor] = None
    map_type = MapType.MT_BITVECTOR_VOXELMAP

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, device=None) -> "BitVectorVoxelMap":
        n = _n(dims)
        data = bitops.zeros((n,), device=device)
        occ = torch.zeros((n,), dtype=torch.uint8, device=data.device)
        return BitVectorVoxelMap(data, tuple(int(d) for d in dims), float(side_length), occ=occ)

    @staticmethod
    def from_planes(planes: torch.Tensor, dims: Dims, side_length: float = 1.0) -> "BitVectorVoxelMap":
        """Wrap int32[8, N] planes, computing the occupancy summary."""
        if planes.dtype != bitops.PLANE_DTYPE:
            raise TypeError(f"bit planes are int32 views of uint32 words, got {planes.dtype}")
        occ = bitops.occupied(planes).to(torch.uint8)
        return BitVectorVoxelMap(planes, tuple(int(d) for d in dims), float(side_length), occ=occ)

    def clear_map(self) -> "BitVectorVoxelMap":
        occ = None if self.occ is None else torch.zeros_like(self.occ)
        return replace(self, data=torch.zeros_like(self.data), occ=occ)

    # -- insertion ----------------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "BitVectorVoxelMap":
        new, _, occ_d = insert_ops.insert_bit(
            self.data, self._points(points), self.side_length, self.dims, int(meaning)
        )
        return replace(self, data=new, occ=None if self.occ is None else self.occ | occ_d)

    def insert_meta_point_cloud(self, meta, meanings=None) -> "BitVectorVoxelMap":
        """Meta insert, uniform or per-subcloud meanings; the per-subcloud
        path is the one-pass kernelInsertMetaPointCloud analogue
        (ops/insert.insert_meta_bits)."""
        if meanings is None:
            return self.insert_point_cloud(meta.points)
        data, occ = insert_ops.insert_meta_bits(self.data, self.occ, meta, meanings, self.side_length, self.dims)
        return replace(self, data=data, occ=occ)

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (the reference stubs it NOT_SUPPORTED on
        BitVoxelMap, BitVoxelMap.hpp:221-227): insert the robot
        MetaPointCloud, optionally with the pairwise sub-cloud
        self-collision check. Returns (new_map, ok device bool)."""
        clash = torch.zeros((), dtype=torch.bool, device=self.device)
        if with_self_collision_test:
            clash = insert_ops.self_collision_clash(robot_links, self.side_length, self.dims)
        return self.insert_meta_point_cloud(robot_links), ~clash

    # -- bit maintenance ----------------------------------------------------
    def _with_planes(self, data) -> "BitVectorVoxelMap":
        """New planes that may have cleared bits: the summary, where the map
        keeps one, is refolded."""
        occ = None if self.occ is None else bitops.occupied(data).to(torch.uint8)
        return replace(self, data=data, occ=occ)

    def clear_bit(self, bit_index: int) -> "BitVectorVoxelMap":
        """clearBit: clear one meaning in every voxel (BitVoxelMap.hpp:58-72)."""
        return self._with_planes(bitops.clear_bit(self.data, bit_index))

    def clear_bits(self, bit_indices) -> "BitVectorVoxelMap":
        d = self.data
        for b in bit_indices:
            d = bitops.clear_bit(d, b)
        return self._with_planes(d)

    def clear_voxel_meaning(self, meaning) -> "BitVectorVoxelMap":
        return self.clear_bit(int(meaning))

    def clear_collision_flags(self) -> "BitVectorVoxelMap":
        """Reset the eBVM_COLLISION marks of the marking collides
        (NTree::clearCollisionFlags analogue, NTree.h:301)."""
        return self.clear_bit(int(BitVoxelMeaning.eBVM_COLLISION))

    def shift_left_swept_volume_ids(self, shift_size: int) -> "BitVectorVoxelMap":
        """shiftLeftSweptVolumeIDs (BitVoxelMap.hpp:226-240)."""
        return self._with_planes(bitops.perform_left_shift(self.data, shift_size))

    # -- collision ----------------------------------------------------------
    @takes_sharded_operand
    def collide_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith count. Bit x bit reads the occupancy summaries when
        both maps keep one and folds the planes otherwise (kernel K7 on CUDA
        maps); bit x prob likewise reads the summary or folds."""
        t = float_to_probability(coll_threshold)
        off = self._offset(offset)
        if isinstance(other, BitVectorVoxelMap):
            if self.occ is not None and other.occ is not None:
                return collide_ops.count_occ_occ(self.occ, other.occ, self.dims, off)
            return collide_cuda.count_bit_bit(self.data, other.data, self.dims, off)
        if isinstance(other, ProbVoxelMap):
            # DefaultCollider bit x prob: the threshold applies to the prob side
            roff = tuple(-v for v in off)
            if self.occ is not None:
                return collide_ops.count_prob_occ(other.data, t, self.occ, self.dims, roff)
            return collide_ops.count_prob_bit(other.data, t, self.data, self.dims, roff)
        raise cannot_collide("BitVectorVoxelMap", other)

    @takes_sharded_operand
    def collide_with_resolution(
        self, other, coll_threshold: float = 1.0, resolution_level: int = 0, offset=(0, 0, 0)
    ) -> torch.Tensor:
        """collideWithResolution (CollisionInterfaces.h:37-60) at a
        2^level-coarsened resolution (ops.collide.count_with_resolution)."""
        mine = self.occupied_mask()
        if isinstance(other, BitVectorVoxelMap):
            theirs = other.occupied_mask()
        elif isinstance(other, ProbVoxelMap):
            theirs = collide_ops.prob_occupied(other.data, float_to_probability(coll_threshold))
        else:
            raise cannot_collide("BitVectorVoxelMap", other)
        return collide_ops.count_with_resolution(mine, theirs, resolution_level, self.dims, self._offset(offset))

    def collides_with(self, other, coll_threshold: float = 1.0, offset=(0, 0, 0)) -> torch.Tensor:
        """Boolean collisionCheck (TemplateVoxelMap.hpp:329-414), a device bool."""
        return collide_ops.any_collision(self.collide_with(other, coll_threshold, offset))

    @takes_sharded_operand
    def collide_with_types(self, other, coll_threshold: float = 1.0, sv_window: int = 0, sv_offset: int = 0):
        """collideWithTypes (BitVoxelMap.hpp:195-210): SVCollider collision
        collecting the colliding meanings. Returns (count, meanings int32[8],
        map with eBVM_COLLISION marked). Bit x bit runs K4 at sv_offset 0 and
        windows up to 24, gated by both maps' summaries where both keep one
        (as the reference), the plain full-domain check otherwise."""
        if isinstance(other, BitVectorVoxelMap):
            if sv_offset == 0 and sv_window <= 24:
                cnt, meanings, new = collide_cuda.collide_types_bit_bit(
                    self.data, other.data, sv_window, True, self.occ, other.occ
                )
            else:
                cnt, meanings, new = collide_ops.collide_with_types_bit_bit(
                    self.data, other.data, sv_window, sv_offset, True
                )
        elif isinstance(other, ProbVoxelMap):
            t = float_to_probability(coll_threshold)
            cnt, meanings, new = collide_ops.collide_with_types_bit_prob(self.data, other.data, t)
        else:
            raise cannot_collide("BitVectorVoxelMap", other)
        return cnt, meanings, replace(self, data=new, occ=self._occ_marked(new))

    def _occ_marked(self, new_data) -> Optional[torch.Tensor]:
        """Summary after a marking collide: marking only ever adds
        eBVM_COLLISION (bit 2), and a voxel holding it is occupied."""
        if self.occ is None:
            return None
        return self.occ | ((new_data[0] >> 2) & 1).to(torch.uint8)

    @takes_sharded_operand
    def collide_with_bitcheck(self, other: "BitVectorVoxelMap", margin: int = 0, sv_offset: int = 0) -> torch.Tensor:
        """Same-bit collision with a +-margin window, count only: K4 without
        marking at sv_offset 0 and margins up to 24 (gated by the summaries
        where both maps keep one), the plain check otherwise."""
        if sv_offset == 0 and margin <= 24:
            cnt, _, _ = collide_cuda.collide_types_bit_bit(self.data, other.data, margin, False, self.occ, other.occ)
            return cnt
        if sv_offset == 0:
            hit, _ = bitops.bit_margin_collision_check_packed(self.data, other.data, margin)
        else:
            hit, _ = bitops.bit_margin_collision_check_packed_full(
                self.data, other.data, torch.zeros_like(self.data), margin, sv_offset
            )
        return hit.sum(dtype=torch.int64)

    # -- queries ------------------------------------------------------------
    def occupied_mask(self) -> torch.Tensor:
        if self.occ is not None:
            return self.occ != 0
        return bitops.occupied(self.data)

    def get_bit_mask(self, meaning) -> torch.Tensor:
        return bitops.get_bit(self.data, int(meaning))

    @takes_sharded_operand
    def merge(self, other: "BitVectorVoxelMap", new_meaning=None) -> "BitVectorVoxelMap":
        """Voxel::reduce = bitwise OR; optionally re-mean the merged voxels."""
        if new_meaning is None:
            new = self.data | other.data
            if self.occ is not None and other.occ is not None:
                return replace(self, data=new, occ=self.occ | other.occ)
            return self._with_planes(new)
        occ_m = other.occupied_mask()
        p = bitops.bit_plane(int(new_meaning))
        word = bitops.as_int32(bitops.bit_word(int(new_meaning)))
        data = self.data.clone()
        data[p] = torch.where(occ_m, self.data[p] | word, self.data[p])
        if self.occ is None or int(new_meaning) == 0:
            occ = self.occ  # bit 0 never flips noneButEmpty
        else:
            occ = self.occ | occ_m.to(torch.uint8)
        return replace(self, data=data, occ=occ)


@dataclass(frozen=True, eq=False)
class CountingVoxelMap(_DenseMap):
    """Dense per-voxel point counter (dense variant of CountingVoxelList's
    noise filtering): int8[N] counts that wrap past 127 like the reference's
    raw int8 counter."""

    map_type = MapType.MT_COUNTING_VOXELLIST

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, device=None) -> "CountingVoxelMap":
        data = torch.zeros((_n(dims),), dtype=torch.int8, device=resolve_device(device))
        return CountingVoxelMap(data, tuple(int(d) for d in dims), float(side_length))

    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "CountingVoxelMap":
        """+1 per point in its voxel; density counters have no meanings."""
        new, _ = insert_ops.insert_count(self.data, self._points(points), self.side_length, self.dims)
        return replace(self, data=new)

    def occupied_mask(self, threshold: int = 1) -> torch.Tensor:
        return self.data.to(torch.int32) >= int(threshold)

    def clear_map(self) -> "CountingVoxelMap":
        return replace(self, data=torch.zeros_like(self.data))
