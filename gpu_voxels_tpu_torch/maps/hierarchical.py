"""Hierarchical maps: the dense status pyramid that replaces the octree (NTree).

Counterpart of gpu_voxels_tpu/maps/hierarchical.py. The reference NTree
answers multi-resolution tri-state queries (is this region FREE, UNKNOWN,
OCCUPIED or mixed?); here, as in the JAX package, the same semantics sit on
a dense status pyramid:

  level 0:   a status byte per voxel (bits FREE | UNKNOWN | OCCUPIED, plus
             the ns_STATIC_MAP / ns_DYNAMIC_MAP tags)
  level l+1: the OR of its 2x2x2 children (getNewStatus, Nodes.h:50-84)

A node is uniform iff exactly one occupancy bit is set. A probe descends
from the top and stops at the first uniform node (kernel_Octree.h:383-423):
one gather per level and a select, for every queried voxel at once.

  HierarchicalProbMap  int8[Zp, Yp, Xp] log-odds + the derived pyramid
                       (MT_PROBAB_OCTREE); occupied iff occ != -128 and
                       occ >= THRESHOLD_OCCUPANCY (EnvNodesProbCommon.h:30-45)
  HierarchicalBitMap   the status grid itself is the ground truth
                       (MT_BITVECTOR_OCTREE / NTreeDet): hard status sets

Both pad their dims up to a multiple of 2^levels. Maps are frozen values
like the dense maps: every insert returns a new map with its pyramid
rebuilt. Counts are 0-d int64 tensors on the map's device.

Depth fusion runs CUDA kernel K3 (the exact carve, carve_pool = 1) or K6
(the pooled carve, carve_pool > 1) on the padded grid, through
ops/raycast_cuda; CPU tensors take their plain versions. The free-space
point insert runs the DDA of ops/raycast. Nothing here reads the device on
the host except `check_tree` and `extract_occupied_coords` (O(occupied) bytes).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import torch

from .. import bitops
from ..constants import THRESHOLD_OCCUPANCY, UNKNOWN_PROBABILITY, BitVoxelMeaning, MapType, meaning_to_probability
from ..geometry import transforms
from ..ops import insert as insert_ops
from ..ops import raycast
from ..ops.compact import compacted_nonzero
from ..utils import resolve_device, to_device
from ..utils.io import DiskIO
from ..utils.logging import log_stream

_log = log_stream("octree")

Dims = Tuple[int, int, int]

NS_FREE = 1
NS_UNKNOWN = 2
NS_OCCUPIED = 4
NS_PART = 8  # implicit here: a multi-bit occupancy status (Nodes.h:50-57)
NS_LAST_LEVEL = 16
NS_COLLISION = 32
NS_STATIC_MAP = 64
NS_DYNAMIC_MAP = 128
STATUS_OCCUPANCY_MASK = NS_FREE | NS_UNKNOWN | NS_OCCUPIED

U8 = torch.uint8


def decode_status_flags(status):
    """Status byte -> (occupied, unknown, free) bool arrays: the one probe
    decode rule (kernel_Octree.h:383-423), for torch tensors and numpy
    arrays alike."""
    occupied = (status & NS_OCCUPIED) != 0
    unknown = ((status & NS_UNKNOWN) != 0) & ~occupied
    free = (status & STATUS_OCCUPANCY_MASK) == NS_FREE
    return occupied, unknown, free


def _pad_dims(dims: Dims, levels: int) -> Dims:
    q = 1 << levels
    return tuple(-(-d // q) * q for d in dims)


def _num_levels(dims: Dims, cap: int = 8) -> int:
    lvl = 0
    m = min(dims)
    while (1 << (lvl + 1)) <= m and lvl + 1 < cap:
        lvl += 1
    return max(lvl, 1)


def _status_from_occupancy(occ: torch.Tensor) -> torch.Tensor:
    unknown = occ == UNKNOWN_PROBABILITY
    occupied = ~unknown & (occ >= THRESHOLD_OCCUPANCY)
    status = torch.where(occupied, NS_OCCUPIED, NS_FREE).to(U8)
    return status.masked_fill_(unknown, NS_UNKNOWN)


def _build_pyramid(status0: torch.Tensor, levels: int) -> list:
    """[level 0 [Z, Y, X], level 1 [Z/2, Y/2, X/2], ...] status bytes: the
    2x2x2 OR one axis at a time, over strided slices."""
    pyr = [status0]
    cur = status0
    for _ in range(levels):
        cur = cur[:, :, 0::2] | cur[:, :, 1::2]
        cur = cur[:, 0::2, :] | cur[:, 1::2, :]
        cur = cur[0::2, :, :] | cur[1::2, :, :]
        pyr.append(cur)
    return pyr


# per status byte: at most one occupancy bit set (0 never occurs in a built pyramid)
_UNIFORM = [(s & STATUS_OCCUPANCY_MASK) & ((s & STATUS_OCCUPANCY_MASK) - 1) == 0 for s in range(256)]
_uniform_tables: dict = {}


def _is_uniform(status: torch.Tensor) -> torch.Tensor:
    """Exactly one occupancy bit set: the reference's non-PART condition
    (Nodes.h:64-84); the map tags are ignored. A lookup in a 256-entry table
    on the status's device (two launches)."""
    table = _uniform_tables.get(status.device)
    if table is None:
        table = _uniform_tables[status.device] = to_device(_UNIFORM, torch.bool, status.device)
    return torch.take(table, status.to(torch.int64))


def _axis_index(i: torch.Tensor, size: int) -> torch.Tensor:
    """An index along an axis of `size` as the reference's gather takes it:
    a negative index counts from the end once, then the index is clamped
    into the axis."""
    return torch.where(i < 0, i + size, i).clamp_(0, size - 1).to(torch.int64)


def gather3(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """grid[z, y, x] of a [Z, Y, X] tensor at int coordinates of any shape,
    with the reference's out-of-range rule (`_axis_index`)."""
    zs, ys, xs = grid.shape
    flat = (_axis_index(z, zs) * ys + _axis_index(y, ys)) * xs + _axis_index(x, xs)
    return torch.take(grid, flat)


def descend(pyramid, levels: int, stop: int, x: torch.Tensor, y: torch.Tensor, z: torch.Tensor,
            in_range: bool = False) -> torch.Tensor:
    """The status of the first uniform node on the way down from `levels`
    to `stop` (or the node at `stop`), per coordinate of level-0 cells
    x, y, z: one gather per level. `in_range` promises 0 <= x, y, z < the
    level-0 extents, where no index needs the reference's out-of-range rule
    (fewer launches: the probes of the collides and the checker)."""
    decided = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    status = torch.zeros(x.shape, dtype=U8, device=x.device)
    if in_range:
        x, y, z = (c.to(torch.int64) for c in (x, y, z))
    for lvl in range(levels, stop - 1, -1):
        if in_range:
            zs, ys, xs = pyramid[lvl].shape
            s = torch.take(pyramid[lvl], ((z >> lvl) * ys + (y >> lvl)) * xs + (x >> lvl))
        else:
            s = gather3(pyramid[lvl], x >> lvl, y >> lvl, z >> lvl)
        if lvl == stop:
            return torch.where(decided, status, s)
        uni = _is_uniform(s)
        status = torch.where(uni & ~decided, s, status)
        decided |= uni
    return status


def full_grid_coords(dims: Dims, device, z_offset: int = 0) -> torch.Tensor:
    """int32[N, 3] (x, y, z) of every voxel of a dense map, in linear order;
    with `z_offset` z0 the map is the z-slab [z0, z0 + dims[2]) of a larger
    one, its z shifted as an integer."""
    dx, dy, _ = dims
    lin = torch.arange(dims[0] * dims[1] * dims[2], dtype=torch.int64, device=device)
    zz = lin // (dx * dy)
    rem = lin - zz * (dx * dy)
    return torch.stack([rem % dx, rem // dx, zz + z_offset], dim=-1).to(torch.int32)


def probe_occupied(m, idx=None) -> torch.Tensor:
    """The octree probe's occupancy rule on a dense map's voxels (every
    voxel, or those at flat indices `idx`): prob occ >= 50, hard-coded in
    kernel_common.h:172-183; a bit voxel !isZero, not noneButEmpty."""
    from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

    if isinstance(m, ProbVoxelMap):
        return (m.data if idx is None else m.data[idx]).to(torch.int32) >= 50
    if isinstance(m, BitVectorVoxelMap):
        return ~bitops.is_zero(m.data if idx is None else m.data[:, idx])
    raise TypeError(type(m))


def query_parts_of(other) -> list:
    """(coords, valid and occupied mask) per part of the map an octree is
    probed against: the intersect_sparse input enumeration. A voxel list
    yields its entries (its padding is invalid); a dense map its whole index
    space masked by `probe_occupied`, a sharded one slab by slab in global
    coordinates (parallel/shard_value.operand_slabs), never gathered."""
    from ..parallel.shard_value import operand_class, operand_slabs
    from .voxellist import VoxelList
    from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

    if isinstance(other, VoxelList):
        return [(other.entry_coords(), (other.keys != other.empty) & other._entry_occupied())]
    if not issubclass(operand_class(other), (ProbVoxelMap, BitVectorVoxelMap)):
        raise TypeError(operand_class(other))
    return [(full_grid_coords(slab.dims, dev, z0), probe_occupied(slab)) for slab, z0, dev in operand_slabs(other)]


def meta_first_meaning(meanings):
    """insertMetaPointCloud's meaning rule on octrees (GvlNTree.hpp:437-453):
    only the first per-subcloud meaning counts."""
    if meanings is not None and len(meanings):
        return meanings[0]
    return BitVoxelMeaning.eBVM_OCCUPIED


def hard_status(s: torch.Tensor, mask: torch.Tensor, occ_bit: int, map_flag: int) -> torch.Tensor:
    """Status bytes s with the voxels of `mask` set hard to occ_bit, tagged
    map_flag (setOccupied, kernel_common.h:219-223)."""
    new = (s & (0xFF ^ STATUS_OCCUPANCY_MASK)) | (occ_bit | map_flag)
    return torch.where(mask, new, s)


def sensor_status(s: torch.Tensor, free: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """The deterministic sensor update of status bytes: carved cells hard
    FREE, then hits hard OCCUPIED (hits win), both tagged ns_DYNAMIC_MAP."""
    return hard_status(hard_status(s, free, NS_FREE, NS_DYNAMIC_MAP), hits, NS_OCCUPIED, NS_DYNAMIC_MAP)


def voxel_hits(points: torch.Tensor, side_length: float, dims: Dims, z_offset: int = 0) -> torch.Tensor:
    """bool over a (padded) grid, flat: the voxels of `points`; with
    `z_offset` z0 the grid is the z-slab [z0, z0 + dims[2]) of a larger one
    (voxelize's rule)."""
    idx, _ = insert_ops.voxelize(points, side_length, dims, z_offset)
    return insert_ops.occupancy_mask(idx, dims[0] * dims[1] * dims[2]) > 0


def store_meaning(occ: torch.Tensor, mask: torch.Tensor, meaning) -> torch.Tensor:
    """int8 log-odds with the voxels of `mask` set to the meaning's
    probability (meaning_to_probability, a store not an update)."""
    return occ.masked_fill(mask, meaning_to_probability(meaning))


def bbox_mask(points, side_length: float, dims: Dims, device, z_offset: int = 0) -> torch.Tensor:
    """bool over a (padded) grid, flat: the points' voxel bounding box; with
    `z_offset` z0 the grid is the z-slab [z0, z0 + dims[2]) of a larger one
    (the box taken in the global frame, its rows shifted as integers)."""
    pts = to_device(points, torch.float32, device).reshape(-1, 3)
    # a true f32 division, as the reference's: CUDA divides by a host
    # scalar as a multiply by its reciprocal
    side = torch.full((), side_length, dtype=torch.float32, device=device)
    lo = insert_ops.floor_to_int32(pts.amin(dim=0) / side)
    hi = insert_ops.floor_to_int32(pts.amax(dim=0) / side)
    px, py, pz = dims
    ix = torch.arange(px, dtype=torch.int32, device=device)[None, None, :]
    iy = torch.arange(py, dtype=torch.int32, device=device)[None, :, None]
    iz = torch.arange(z_offset, z_offset + pz, dtype=torch.int32, device=device)[:, None, None]
    inside = ((ix >= lo[0]) & (ix <= hi[0]) & (iy >= lo[1]) & (iy <= hi[1])
              & (iz >= lo[2]) & (iz <= hi[2]))
    return inside.reshape(-1)


def depth_world_points(depth: torch.Tensor, pose: torch.Tensor, sensor) -> torch.Tensor:
    """A depth frame's measurements in the world frame, the non-finite ones
    moved to -1 (outside every grid): the deterministic depth insert's hits."""
    fx, fy, cx, cy, inv = _sensor_scalars(sensor)
    world = transforms.transform_points(pose, raycast.depth_image_to_point_cloud(depth, fx, fy, cx, cy, inv))
    finite = torch.all(torch.isfinite(world), dim=-1)
    return torch.where(finite[:, None], world, -1.0)


def occupied_coords_of(idx: np.ndarray, padded_dims: Dims, dims: Dims) -> np.ndarray:
    """int32[K, 3] (x, y, z) of ascending flat indices into the padded grid,
    those outside dims dropped."""
    px, py, _ = padded_dims
    z, rem = np.divmod(idx, px * py)
    y, x = np.divmod(rem, px)
    keep = (x < dims[0]) & (y < dims[1]) & (z < dims[2])
    return np.stack([x[keep], y[keep], z[keep]], axis=1).astype(np.int32)


def _is_sharded_pyramid(m) -> bool:
    from ..parallel.shard_value import ShardedPyramid

    return isinstance(m, ShardedPyramid)


def _reject_octree_offset(offset) -> None:
    """Octree x octree takes no offset. The reference logs
    GPU_VOXELS_MAP_OFFSET_ON_WRONG_DATA_STRUCTURE and drops it
    (GvlNTree.hpp:260-262); dropping a translation silently would corrupt the
    count, so this raises."""
    if tuple(int(v) for v in offset) != (0, 0, 0):
        raise ValueError("offset not supported on octree x octree collides")


def count_probe_hits(probe, coords: torch.Tensor, valid: torch.Tensor, dims: Dims, min_level: int, offset):
    """Probe (a `probe_clamped`) at coords + offset (the intersect_sparse
    direction, GvlNTree.hpp:195); translated coords outside dims never hit.
    Returns (occupied hits, unknown hits) as 0-d int64 tensors."""
    c = insert_ops.shifted(coords, offset)
    live = valid & insert_ops.in_map(c, dims)
    occ, unk, _ = probe(insert_ops.clamp_coords(c, dims), min_level)
    return (occ & live).sum(dtype=torch.int64), (unk & live).sum(dtype=torch.int64)


def count_part_hits(probe, parts: list, device, dims: Dims, min_level: int, offset):
    """count_probe_hits over `query_parts_of` parts, each part's coords
    moved to the probed map's `device`, the counts summed there."""
    hits = [count_probe_hits(probe, c.to(device), v.to(device), dims, min_level, offset) for c, v in parts]
    if len(hits) == 1:
        return hits[0]
    return tuple(torch.stack([h[i] for h in hits]).sum() for i in (0, 1))


class _PyramidQueries(DiskIO):
    """Probe and collide machinery of the dense hierarchical tiers, on
    self.pyramid / self.levels / self.dims only."""

    @property
    def device(self) -> torch.device:
        return self.pyramid[0].device

    @property
    def padded_dims(self) -> Dims:
        z, y, x = self.pyramid[0].shape
        return (x, y, z)

    def _coords(self, coords) -> torch.Tensor:
        return to_device(coords, torch.int32, self.device)

    def probe_status(self, coords, min_level: int = 0) -> torch.Tensor:
        """The raw status byte per voxel coordinate [..., 3]: the descent
        from the top, stopped at the first occupancy-uniform node or at
        `min_level`. The map tags ride along with the deciding node."""
        c = self._coords(coords)
        return descend(self.pyramid, self.levels, int(min_level), c[..., 0], c[..., 1], c[..., 2])

    def probe(self, coords, min_level: int = 0):
        """Tri-state query per voxel coordinate (the intersect_sparse descent,
        NTree.hpp:817-1004): (occupied, unknown, free) bool tensors."""
        return decode_status_flags(self.probe_status(coords, min_level))

    def probe_clamped(self, coords: torch.Tensor, min_level: int = 0):
        """`probe` of int32 coords already inside the padded grid."""
        return decode_status_flags(descend(self.pyramid, self.levels, int(min_level), coords[..., 0], coords[..., 1],
                                           coords[..., 2], in_range=True))

    def _collide_probe(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """Probe self at other's voxel coords + offset: (occupied hits,
        unknown hits)."""
        return count_part_hits(self.probe_clamped, query_parts_of(other), self.device, self.dims, int(min_level),
                               offset)

    def collide_with(self, other, min_level: int = 0, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith dispatch (GvlNTree.hpp:150-330): octree x list or
        dense map runs the probe at other + offset; octree x octree the
        hierarchy intersection, which takes no offset (a sharded pyramid is
        an octree too, as the reference's sharded value is)."""
        from .paged import PagedHierarchicalMap

        if isinstance(other, PagedHierarchicalMap):
            _reject_octree_offset(offset)
            return other.collide_with(self, min_level=min_level)
        if isinstance(other, _PyramidQueries) or _is_sharded_pyramid(other):
            _reject_octree_offset(offset)
            return self.collide_with_hierarchical(other, min_level=min_level)
        return self._collide_probe(other, min_level, offset)[0]

    def collide_with_resolution(self, other, coll_threshold: float = 1.0, resolution_level: int = 0,
                                offset=(0, 0, 0)) -> torch.Tensor:
        """collideWithResolution (GvlNTree.hpp:179-197): resolution_level is
        the probe's min_level; coll_threshold is ignored, as by the
        reference's hard-coded probe occupancy (kernel_common.h:172)."""
        del coll_threshold
        if resolution_level > self.levels:
            raise ValueError("resolution_level greater than octree height")
        return self.collide_with(other, min_level=int(resolution_level), offset=offset)

    def collide_with_counting_unknown(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """collideWithTypesConsideringUnknownCells (GvlNTree.h:120-129):
        (collisions, unknown-cell hits)."""
        return self._collide_probe(other, min_level, offset)

    def collide_with_hierarchical(self, other, min_level: int = 0) -> torch.Tensor:
        """NTree x NTree (intersect_load_balance, NTree.hpp:1139): cells
        occupied in both hierarchies at level `min_level`. The count is
        symmetric: a sharded other counts slab by slab."""
        if other.padded_dims != self.padded_dims:
            raise ValueError("hierarchies must share dimensions")
        if _is_sharded_pyramid(other):
            return other.collide_with_hierarchical(self, min_level).to(self.device)
        a, b = self.pyramid[min_level], other.pyramid[min_level]
        return (((a & NS_OCCUPIED) != 0) & ((b & NS_OCCUPIED) != 0)).sum(dtype=torch.int64)

    def extract_occupied_coords(self) -> np.ndarray:
        """int32[K, 3] (x, y, z) of the occupied voxels inside dims, in
        z, y, x order. The mask is compacted on the device: two host reads,
        O(K) bytes."""
        idx = compacted_nonzero((self.pyramid[0] & STATUS_OCCUPANCY_MASK) == NS_OCCUPIED)
        return occupied_coords_of(idx, self.padded_dims, self.dims)

    def memory_usage(self) -> int:
        """Device bytes of the map's tensors: the reference's sum over its
        pytree leaves."""
        return int(sum(t.numel() * t.element_size() for t in self._tensors()))

    def insert_meta_point_cloud(self, meta, meanings=None):
        """insertMetaPointCloud on the octree adapter (GvlNTree.hpp:437-453):
        given per-subcloud meanings the whole cloud takes the first one."""
        return self.insert_point_cloud(meta.points, meta_first_meaning(meanings))

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract). Returns
        (new map, ok device bool)."""
        clash = torch.zeros((), dtype=torch.bool, device=self.device)
        if with_self_collision_test:
            clash = insert_ops.self_collision_clash(robot_links.to(self.device), self.side_length,
                                                    self.padded_dims)
        return self.insert_meta_point_cloud(robot_links), ~clash

    def clear_voxel_meaning(self, meaning):
        """clearBitVoxelMeaning (GvlNTree.hpp:487-494): octree maps clear
        only eBVM_OCCUPIED, which resets the map."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            _log.error("octree maps only clear eBVM_OCCUPIED")
            return self
        return self.clear_map()

    # -- NTree maintenance contract (NTree.h:267-301, NTree.hpp:2941) --------
    def needs_rebuild(self) -> bool:
        """NTree::needsRebuild: the dense pyramid never fragments."""
        return False

    def rebuild(self):
        """NTree::rebuild: defragmentation, a no-op here."""
        return self

    def check_tree(self) -> bool:
        """NTree::checkTree (NTree.h:267-271): every coarse status byte is the
        OR of its 2x2x2 children (host read)."""
        want = _build_pyramid(self.pyramid[0], self.levels)
        return all(torch.equal(w, p) for w, p in zip(want, self.pyramid))

    def clear_collision_flags(self):
        """NTree::clearCollisionFlags: probes return their results, nothing
        is stored in the nodes."""
        return self

    def _bbox_mask_flat(self, points) -> torch.Tensor:
        """bool over the padded grid, flat: the points' voxel bounding box."""
        return bbox_mask(points, self.side_length, self.padded_dims, self.device)


def _sensor_scalars(sensor):
    return (float(sensor.fx), float(sensor.fy), float(sensor.cx), float(sensor.cy),
            float(sensor.invalid_value))


@dataclass(frozen=True, eq=False)
class HierarchicalProbMap(_PyramidQueries):
    """Probabilistic hierarchical map (MT_PROBAB_OCTREE)."""

    occupancy: torch.Tensor  # int8[Zp, Yp, Xp] (padded)
    pyramid: Tuple[torch.Tensor, ...]  # status bytes per level
    dims: Dims  # logical dims (x, y, z)
    side_length: float
    levels: int
    map_type: MapType = MapType.MT_PROBAB_OCTREE

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, levels: Optional[int] = None,
               device=None) -> "HierarchicalProbMap":
        levels = levels if levels is not None else _num_levels(dims)
        pd = _pad_dims(dims, levels)
        occ = torch.full((pd[2], pd[1], pd[0]), UNKNOWN_PROBABILITY, dtype=torch.int8, device=resolve_device(device))
        pyr = _build_pyramid(_status_from_occupancy(occ), levels)
        return HierarchicalProbMap(occ, tuple(pyr), tuple(int(d) for d in dims), float(side_length), levels)

    def _tensors(self):
        return (self.occupancy,) + tuple(self.pyramid)

    def to(self, device) -> "HierarchicalProbMap":
        device = resolve_device(device)
        return replace(self, occupancy=self.occupancy.to(device), pyramid=tuple(p.to(device) for p in self.pyramid))

    def _rebuilt(self, occ: torch.Tensor) -> "HierarchicalProbMap":
        pyr = _build_pyramid(_status_from_occupancy(occ), self.levels)
        return replace(self, occupancy=occ, pyramid=tuple(pyr))

    def _rebuilt_flat(self, flat: torch.Tensor) -> "HierarchicalProbMap":
        return self._rebuilt(flat.reshape(self.occupancy.shape))

    def clear_map(self) -> "HierarchicalProbMap":
        return self._rebuilt(torch.full_like(self.occupancy, UNKNOWN_PROBABILITY))

    # -- insertion -----------------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "HierarchicalProbMap":
        """Point insert: voxels of the padded grid take the meaning's
        probability, then the pyramid is rebuilt."""
        pts = to_device(points, torch.float32, self.device).reshape(-1, 3)
        flat, _ = insert_ops.insert_prob(self.occupancy.reshape(-1), pts, self.side_length, self.padded_dims,
                                         meaning)
        return self._rebuilt_flat(flat)

    def insert_point_cloud_with_free_space(self, points, sensor_origin=(0.0, 0.0, 0.0),
                                           max_steps: int = 256) -> "HierarchicalProbMap":
        """insertPointCloudWithFreespaceCalculation (GvlNTree.hpp:108-130):
        occupied hits and ray-carved free space, the probabilistic update
        (the DDA insert_sensor_data on the padded grid)."""
        flat = raycast.insert_sensor_data(
            self.occupancy.reshape(-1), tuple(float(v) for v in sensor_origin),
            to_device(points, torch.float32, self.device).reshape(-1, 3), self.side_length, self.padded_dims,
            enable_raycasting=True, max_steps=max_steps,
        )
        return self._rebuilt_flat(flat)

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "HierarchicalProbMap":
        """Projective sensor fusion on the padded grid, then one rebuild:
        carve_pool = 1 is the exact carve (K3 on the card), P > 1 the P x P
        pooled conservative carve (K6)."""
        fx, fy, cx, cy, inv = _sensor_scalars(sensor)
        flat = raycast.insert_depth_image(
            self.occupancy.reshape(-1), depth, sensor.pose(), fx, fy, cx, cy, self.side_length,
            self.padded_dims, invalid_value=inv, carve_pool=int(carve_pool),
        )
        return self._rebuilt_flat(flat)

    def build(self, points, free_bounding_box: bool = False) -> "HierarchicalProbMap":
        """NTree::build (NTree.hpp:385-540): rebuild from a point set; with
        free_bounding_box the points' voxel box is set FREE first (NTree.h:127)."""
        m = self.clear_map()
        if free_bounding_box:
            m = m._rebuilt_flat(store_meaning(m.occupancy.reshape(-1), m._bbox_mask_flat(points),
                                              BitVoxelMeaning.eBVM_FREE))
        return m.insert_point_cloud(points)

    def propagate(self) -> "HierarchicalProbMap":
        """NTree::propagate: the pyramid is rebuilt after every insert already."""
        return self._rebuilt(self.occupancy)


@dataclass(frozen=True, eq=False)
class HierarchicalBitMap(_PyramidQueries):
    """Deterministic hierarchical map (MT_BITVECTOR_OCTREE / NTreeDet): the
    status byte per voxel is the ground truth, and inserts write hard
    statuses (setOccupied, kernel_common.h:219-223):

      occupied insert:  status = (old & ~OCC_MASK) | ns_OCCUPIED
      free insert:      status = (old & ~OCC_MASK) | ns_FREE

    environment inserts tag ns_STATIC_MAP, sensor inserts ns_DYNAMIC_MAP
    (kernel_common.h:186-245); the tags OR up the pyramid. pyramid[0] is the
    status grid."""

    pyramid: Tuple[torch.Tensor, ...]
    dims: Dims
    side_length: float
    levels: int
    map_type: MapType = MapType.MT_BITVECTOR_OCTREE

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, levels: Optional[int] = None,
               device=None) -> "HierarchicalBitMap":
        levels = levels if levels is not None else _num_levels(dims)
        pd = _pad_dims(dims, levels)
        s0 = torch.full((pd[2], pd[1], pd[0]), NS_UNKNOWN, dtype=U8, device=resolve_device(device))
        return HierarchicalBitMap(tuple(_build_pyramid(s0, levels)), tuple(int(d) for d in dims),
                                  float(side_length), levels)

    @property
    def status(self) -> torch.Tensor:
        return self.pyramid[0]

    def _tensors(self):
        return tuple(self.pyramid)

    def to(self, device) -> "HierarchicalBitMap":
        device = resolve_device(device)
        return replace(self, pyramid=tuple(p.to(device) for p in self.pyramid))

    def _rebuilt(self, status0: torch.Tensor) -> "HierarchicalBitMap":
        return replace(self, pyramid=tuple(_build_pyramid(status0, self.levels)))

    def clear_map(self) -> "HierarchicalBitMap":
        return self._rebuilt(torch.full_like(self.pyramid[0], NS_UNKNOWN))

    def _hard_set(self, mask_flat: torch.Tensor, occ_bit: int, map_flag: int) -> "HierarchicalBitMap":
        s = hard_status(self.pyramid[0].reshape(-1), mask_flat, occ_bit, map_flag)
        return self._rebuilt(s.reshape(self.pyramid[0].shape))

    def _hits(self, points: torch.Tensor) -> torch.Tensor:
        """bool over the padded grid, flat: the voxels of `points`."""
        return voxel_hits(points, self.side_length, self.padded_dims)

    def _sensor_update(self, free: torch.Tensor, hits: torch.Tensor) -> "HierarchicalBitMap":
        """sensor_status on level 0; one pyramid rebuild."""
        return self._rebuilt(sensor_status(self.pyramid[0].reshape(-1), free, hits).reshape(self.pyramid[0].shape))

    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED,
                           static_map: bool = True) -> "HierarchicalBitMap":
        """Hard status insert: eBVM_FREE marks cells free, every other meaning
        occupied; static_map picks the ns_STATIC_MAP or ns_DYNAMIC_MAP tag."""
        hits = self._hits(to_device(points, torch.float32, self.device).reshape(-1, 3))
        occ_bit = NS_FREE if int(meaning) == int(BitVoxelMeaning.eBVM_FREE) else NS_OCCUPIED
        return self._hard_set(hits, occ_bit, NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP)

    def insert_point_cloud_with_free_space(self, points, sensor_origin=(0.0, 0.0, 0.0),
                                           max_steps: int = 256) -> "HierarchicalBitMap":
        """Deterministic sensor insert (GvlNTree.hpp:108-130): hits hard
        OCCUPIED, the cells the rays cross hard FREE (hits win)."""
        pts = to_device(points, torch.float32, self.device).reshape(-1, 3)
        free_counts = raycast.ray_crossing_counts(tuple(float(v) for v in sensor_origin), pts, self.side_length,
                                                  self.padded_dims, max_steps)
        return self._sensor_update(free_counts > 0, self._hits(pts))

    def insert_depth_image(self, depth, sensor, carve_pool: int = 1) -> "HierarchicalBitMap":
        """Projective deterministic sensor fusion on the padded grid:
        visibility-carved cells hard FREE, measurement cells hard OCCUPIED.
        carve_pool = 1 is the exact carve (K3 on the card), P > 1 the pooled
        conservative carve (K6); the reference takes its Pallas kernels on
        its accelerator the same way (its `_depth_fusion_bit`)."""
        depth = to_device(depth, torch.float32, self.device)
        pose = to_device(sensor.pose(), torch.float32, self.device)
        hits = self._hits(depth_world_points(depth, pose, sensor))
        fx, fy, cx, cy, inv = _sensor_scalars(sensor)
        free = raycast.carve(depth, pose, fx, fy, cx, cy, self.side_length, self.padded_dims, inv, int(carve_pool))
        return self._sensor_update(free & ~hits, hits)

    def build(self, points, free_bounding_box: bool = False) -> "HierarchicalBitMap":
        """NTree::build (NTree.hpp:385-540): rebuild from a point set; with
        free_bounding_box the points' voxel box is first hard FREE, both
        tagged ns_STATIC_MAP."""
        m = self.clear_map()
        if free_bounding_box:
            m = m._hard_set(m._bbox_mask_flat(points), NS_FREE, NS_STATIC_MAP)
        return m.insert_point_cloud(points, static_map=True)

    def propagate(self) -> "HierarchicalBitMap":
        """NTree::propagate (re-establish the tree invariant)."""
        return self._rebuilt(self.pyramid[0])
