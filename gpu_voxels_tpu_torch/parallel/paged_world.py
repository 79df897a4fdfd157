"""Multi-device paged octree: z-slab decomposition of a `PagedHierarchicalMap`.

Counterpart of gpu_voxels_tpu/parallel/paged_world.py. The paged tier is
host-stateful (its tile pool grows on insert), so it is not split like the
dense maps (parallel/shard_value.py). Instead the virtual world is cut into
contiguous z-slabs, one independent `PagedHierarchicalMap` per device: each
slab owns its page directory, tile pool AND allocator, so pool memory,
scatter and rebuild work and probe gathers all distribute. Tile (8),
block-row (64) and page (64) boundaries nest inside any 64-multiple slab, so
every tile belongs to exactly one slab and the per-slab results partition
the single-device ones exactly.

  * Points and depth frames are replicated to every slab (they are small
    beside the grid); each slab voxelizes in the GLOBAL frame and shifts the
    resulting coords by its integer slab offset (`voxel_offset=(0, 0, z0)`,
    maps/paged.py), NEVER by translating the float points first, which would
    move `floor(p / side)` decisions at cell boundaries whenever side_length
    is not exactly representable in float32. The scatter drops out-of-slab
    cells. Free-space rays crossing slab boundaries walk the global ray
    geometry and carve each slab's own cells.
  * Every per-slab input is moved to the slab's device first; a slab map
    creates its tensors there, so nothing needs re-pinning afterwards.
  * Every collide direction is the single-device call with the offset
    translated by the slab origin (both probe directions use
    c = coords + offset, so offset_z - z0 lands queries in the slab frame);
    the per-slab counts sum because each global cell lies in exactly one
    slab. Counts and probes are combined on the first slab's device, with
    no host read; each slab's allocator reads on the host as the
    single-device map's does (H10).
  * min_level probes OR over aligned 2^l cubes; a cube never crosses a slab
    boundary iff 2^min_level divides the slab depth; coarser levels raise.
"""
from __future__ import annotations

import weakref
from typing import Sequence, Tuple

import numpy as np
import torch

from ..constants import UNKNOWN_PROBABILITY, BitVoxelMeaning
from ..maps.hierarchical import _reject_octree_offset, decode_status_flags
from ..maps.paged import (B, PAGE_EDGE, PagedHierarchicalMap, _count_probe_hits, _free_box_cloud,
                          meta_first_meaning, robot_self_collision_clash)
from ..ops.insert import shifted
from ..utils import to_device
from .shard_value import _ShardedValue, operand_class
from .sharded import as_device, psum, replicate, visible_devices

Dims = Tuple[int, int, int]


class ShardedPagedWorld:
    """Z-slab-sharded sparse hierarchical world over `devices` (default:
    every visible CUDA device; a device may be named more than once).

    Same insert / probe / collide surface as `PagedHierarchicalMap` (both
    NTree instantiations: deterministic hard-status and probabilistic
    log-odds), with memory and work distributed one slab per device. Counts
    and probe statuses are exactly the single-device map's."""

    def __init__(self, dims: Dims, side_length: float = 1.0, probabilistic: bool = False,
                 devices: Sequence | None = None):
        devices = [as_device(d) for d in (devices if devices is not None else visible_devices())]
        if not devices:
            raise ValueError("need at least one device")
        dx, dy, dz = (int(d) for d in dims)
        nz = len(devices)
        if dz % nz:
            raise ValueError(f"dimz {dz} must divide over {nz} devices")
        self.slab_dz = dz // nz
        if self.slab_dz % PAGE_EDGE:
            raise ValueError(f"slab depth {self.slab_dz} must be a multiple of {PAGE_EDGE} "
                             "(tiles/pages may not cross slab boundaries)")
        self.dims: Dims = (dx, dy, dz)
        self.side_length = float(side_length)
        self.probabilistic = bool(probabilistic)
        self.devices = devices
        self.z0s = [k * self.slab_dz for k in range(nz)]
        self._replica_cache: dict = {}
        self.shards = [PagedHierarchicalMap((dx, dy, self.slab_dz), side_length, probabilistic, device=dev)
                       for dev in devices]

    @property
    def device(self) -> torch.device:
        """Where counts and probes are combined: the first slab's device."""
        return self.devices[0]

    # -- helpers ---------------------------------------------------------------
    def _points(self, points, k: int) -> torch.Tensor:
        """`points` on slab k's device, UNtranslated: the slab shift happens in
        integer voxel space via `voxel_offset` (module docstring)."""
        return to_device(points, torch.float32, self.devices[k])

    def _voff(self, k: int) -> tuple:
        return (0, 0, self.z0s[k])

    def _coords(self, coords, k: int) -> torch.Tensor:
        return to_device(coords, torch.int32, self.devices[k])

    def _shard_offset(self, offset, k: int) -> tuple:
        ox, oy, oz = (int(v) for v in np.asarray(offset).ravel())
        return (ox, oy, oz - self.z0s[k])

    def _check_min_level(self, min_level: int) -> None:
        if min_level and self.slab_dz % (1 << min_level):
            raise ValueError(f"min_level {min_level} cubes (edge {1 << min_level}) would cross slab boundaries "
                             f"(slab depth {self.slab_dz}); use a single-device map or fewer/deeper slabs for "
                             "coarser probes")

    def _sum(self, parts) -> torch.Tensor:
        return psum(parts, self.device)

    # -- insertion ---------------------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED,
                           static_map: bool = True) -> "ShardedPagedWorld":
        for k, m in enumerate(self.shards):
            m.insert_point_cloud(self._points(points, k), meaning, static_map, voxel_offset=self._voff(k))
        return self

    def insert_point_cloud_with_free_space(self, points, sensor_origin=(0.0, 0.0, 0.0), max_steps: int = 128,
                                           static_map: bool = False) -> "ShardedPagedWorld":
        for k, m in enumerate(self.shards):
            m.insert_point_cloud_with_free_space(self._points(points, k), sensor_origin, max_steps, static_map,
                                                 voxel_offset=self._voff(k))
        return self

    def insert_depth_image(self, depth, sensor, max_steps: int = 128) -> "ShardedPagedWorld":
        """The octree sensor pipeline on the sharded world: each slab
        back-projects and ray-carves on its own device in the GLOBAL frame
        (replicated compute, Sensor.cu semantics via the slab maps), with
        only the visited cells shifted into the slab."""
        for k, m in enumerate(self.shards):
            m.insert_depth_image(to_device(depth, torch.float32, self.devices[k]), sensor, max_steps,
                                 voxel_offset=self._voff(k))
        return self

    def insert_meta_point_cloud(self, meta, meanings=None) -> "ShardedPagedWorld":
        """insertMetaPointCloud (GvlNTree.hpp:437-453): per-subcloud meanings
        degrade to the FIRST meaning (the rule of maps/paged.py)."""
        return self.insert_point_cloud(meta.points, meta_first_meaning(meanings))

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract); the self-collision
        test is the host cell-set check of the single-device map. Returns
        (world, ok)."""
        ok = True
        if with_self_collision_test:
            ok = not robot_self_collision_clash(robot_links, self.side_length)
        return self.insert_meta_point_cloud(robot_links), ok

    def build(self, points, free_bounding_box: bool = False) -> "ShardedPagedWorld":
        """NTree::build (NTree.hpp:385-540) over the slabs; the free box carve
        spans slabs like any other insert."""
        free = _free_box_cloud(points, self.side_length) if free_bounding_box else None
        self.clear_map()
        if free is not None:
            self.insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE)
        return self.insert_point_cloud(points, BitVoxelMeaning.eBVM_OCCUPIED)

    def clear_voxel_meaning(self, meaning) -> "ShardedPagedWorld":
        """clearBitVoxelMeaning (GvlNTree.hpp:487-494) per slab."""
        for m in self.shards:
            m.clear_voxel_meaning(meaning)
        return self

    def needs_rebuild(self) -> bool:
        return any(m.needs_rebuild() for m in self.shards)

    def rebuild(self) -> "ShardedPagedWorld":
        for m in self.shards:
            m.rebuild()
        return self

    # -- probing -------------------------------------------------------------------
    def _combine_probe(self, coords, fn, fill, dtype) -> torch.Tensor:
        """A per-slab probe combined over the owning slabs on the first
        device. Coords outside the world clamp into the first / last slab,
        as the single-device map clamps into its grid, so sharded probes
        equal single-device probes on any input."""
        c = to_device(coords, torch.int32, self.device)
        zc = c[..., 2].clamp(0, self.dims[2] - 1)
        out = torch.full(c.shape[:-1], fill, dtype=dtype, device=self.device)
        hi = (self.dims[0] - 1, self.dims[1] - 1, self.slab_dz - 1)
        for k, m in enumerate(self.shards):
            ck = c.to(self.devices[k])
            local = torch.stack([ck[..., 0].clamp(0, hi[0]), ck[..., 1].clamp(0, hi[1]),
                                 (ck[..., 2] - self.z0s[k]).clamp(0, hi[2])], dim=-1)
            own = (zc >= self.z0s[k]) & (zc < self.z0s[k] + self.slab_dz)
            out = torch.where(own, fn(m, local).to(self.device), out)
        return out

    def probe_status(self, coords, min_level: int = 0) -> torch.Tensor:
        """Status byte per fine voxel (kernel_Octree.h:383-423), from the
        owning slabs."""
        self._check_min_level(min_level)
        return self._combine_probe(coords, lambda m, c: m.probe_status(c, min_level), 0, torch.uint8)

    def probe(self, coords, min_level: int = 0):
        return decode_status_flags(self.probe_status(coords, min_level))

    def probe_occupancy(self, coords) -> torch.Tensor:
        """int8 log-odds per fine voxel (probabilistic tier)."""
        if not self.probabilistic:
            raise TypeError("probe_occupancy requires a probabilistic paged world")
        return self._combine_probe(coords, lambda m, c: m.probe_occupancy(c), UNKNOWN_PROBABILITY, torch.int8)

    # -- collision ---------------------------------------------------------------
    def collide_with_coords(self, coords, min_level: int = 0, offset=(0, 0, 0)) -> torch.Tensor:
        self._check_min_level(min_level)
        return self._sum([m.collide_with_coords(self._coords(coords, k), min_level, self._shard_offset(offset, k))
                          for k, m in enumerate(self.shards)])

    def collide_with_counting_unknown_coords(self, coords, min_level: int = 0, offset=(0, 0, 0)):
        self._check_min_level(min_level)
        pairs = [m.collide_with_counting_unknown_coords(self._coords(coords, k), min_level,
                                                        self._shard_offset(offset, k))
                 for k, m in enumerate(self.shards)]
        return self._sum([c for c, _ in pairs]), self._sum([u for _, u in pairs])

    def _replicas(self, other):
        """One copy of `other` per slab device, cached by object identity
        (map values are immutable, so identity pins content; a weakref guard
        rejects a stale id reused after collection). Without the cache every
        collide in a sense loop would copy the whole map to every device. A
        sharded dense map is never copied: each slab's collide reads it slab
        by slab (shard_value.operand_slabs)."""
        if isinstance(other, _ShardedValue):
            return [other] * len(self.devices)
        key = id(other)
        hit = self._replica_cache.get(key)
        if hit is not None and hit[0]() is other:
            return hit[1]
        reps = [replicate(other, d) for d in self.devices]
        try:
            self._replica_cache[key] = (weakref.ref(other), reps)
            while len(self._replica_cache) > 8:  # bound: drop the oldest entries
                self._replica_cache.pop(next(iter(self._replica_cache)))
        except TypeError:
            pass  # not weakref-able: no cache
        return reps

    def _occupied_cells(self, other):
        """(coords, valid) of another octree's exact occupied set, in global
        coords on its (first) device: from its tile pools, no host read."""
        if isinstance(other, ShardedPagedWorld):
            parts = [(m.snapshot().occupied_cells(), z0) for m, z0 in zip(other.shards, other.z0s)]
            coords = torch.cat([shifted(c, (0, 0, z0)).to(other.device) for (c, _), z0 in parts])
            return coords, torch.cat([v.to(other.device) for (_, v), _ in parts])
        return other.snapshot().occupied_cells()

    def collide_with(self, other, min_level: int = 0, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith dispatch (GvlNTree.hpp:150-330) over the slabs: lists,
        dense maps (plain or sharded), paged maps and sharded worlds. Each
        direction is the single-device call with the slab-translated offset;
        counts sum."""
        from ..maps.voxellist import VoxelList
        from ..maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap

        self._check_min_level(min_level)
        if issubclass(operand_class(other), (VoxelList, ProbVoxelMap, BitVectorVoxelMap)):
            reps = self._replicas(other)
            return self._sum([m.collide_with(reps[k], min_level, self._shard_offset(offset, k))
                              for k, m in enumerate(self.shards)])
        if isinstance(other, (PagedHierarchicalMap, ShardedPagedWorld)):
            # NTree x NTree (NTree.hpp:1139): self probed at the other octree's
            # exact occupied set; a nonzero offset raises, as on one device
            _reject_octree_offset(tuple(int(v) for v in np.asarray(offset).ravel()))
            coords, valid = self._occupied_cells(other)
            return self._sum([_count_probe_hits(m.snapshot(), coords.to(self.devices[k]), valid.to(self.devices[k]),
                                                min_level, (0, 0, -self.z0s[k]))[0]
                              for k, m in enumerate(self.shards)])
        raise TypeError(type(other))

    def collide_with_counting_unknown(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """collideWithTypesConsideringUnknownCells (GvlNTree.h:115-129):
        (collisions, unknown-cell hits) summed over the slabs."""
        self._check_min_level(min_level)
        reps = self._replicas(other)
        pairs = [m.collide_with_counting_unknown(reps[k], min_level, self._shard_offset(offset, k))
                 for k, m in enumerate(self.shards)]
        return self._sum([c for c, _ in pairs]), self._sum([u for _, u in pairs])

    # -- maintenance ---------------------------------------------------------------
    def clear_map(self) -> "ShardedPagedWorld":
        for m in self.shards:
            m.clear_map()
        return self

    def check_tree(self) -> bool:
        return all(m.check_tree() for m in self.shards)

    def n_tiles(self) -> int:
        return sum(m.n_tiles() for m in self.shards)

    def memory_usage(self) -> int:
        return sum(m.memory_usage() for m in self.shards)

    def extract_occupied_coords(self, max_out: int | None = None) -> np.ndarray:
        """int32[K, 3] occupied global coords, slab after slab (host read)."""
        parts = []
        for k, m in enumerate(self.shards):
            c = m.extract_occupied_coords()
            c[:, 2] += self.z0s[k]
            parts.append(c)
        out = np.concatenate(parts, axis=0)
        return out[:max_out] if max_out is not None else out

    @property
    def map_type(self):
        return self.shards[0].map_type

    # -- conversion / persistence ----------------------------------------------
    def to_paged_map(self) -> PagedHierarchicalMap:
        """The slabs gathered into ONE `PagedHierarchicalMap` over the global
        dims on the first device: the tiles are copied slab after slab, the
        directory, summaries and pyramid rebuilt as invariants (the disk
        reader's path, utils/io.py). Reads the slot blocks on the host."""
        from ..utils.io import _paged_from_tiles

        blocks, payloads = [], []
        for k, m in enumerate(self.shards):
            n = m.n_tiles()
            if not n:
                continue
            sb = m.slot_block[:n].cpu().numpy().copy()
            sb[:, 2] += self.z0s[k] // B  # a slab's z0 is a block multiple
            blocks.append(sb)
            payloads.append((m.occ_pool if self.probabilistic else m.pool)[:n].to(self.device))
        merged = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 3), np.int64)
        body = torch.cat(payloads) if payloads else None
        return _paged_from_tiles(self.map_type, self.dims, self.side_length, merged, body, self.device)

    @classmethod
    def from_paged_map(cls, m: PagedHierarchicalMap, devices: Sequence | None = None) -> "ShardedPagedWorld":
        """An existing single-device paged map distributed over `devices`:
        every tile belongs to exactly one z-slab (the slab depth is a block
        multiple), so the split is a partition of the tile pool, each slab
        keeping the map's slot order. Reads the slot blocks on the host."""
        from ..utils.io import _paged_from_tiles

        world = cls(m.dims, m.side_length, m.probabilistic, devices)
        n = m.n_tiles()
        if n:
            sb = m.slot_block[:n].cpu().numpy()
            body = (m.occ_pool if m.probabilistic else m.pool)[:n]
            slab_blocks = world.slab_dz // B
            owner = sb[:, 2] // slab_blocks
            for k in range(len(world.shards)):
                sel = np.flatnonzero(owner == k)
                if not sel.size:
                    continue
                local = sb[sel].copy()
                local[:, 2] -= k * slab_blocks
                payload = torch.index_select(body, 0, to_device(sel, torch.int64, body.device))
                world.shards[k] = _paged_from_tiles(m.map_type, world.shards[k].dims, m.side_length, local,
                                                    payload.to(world.devices[k]), world.devices[k])
        return world

    def write_to_disk(self, path) -> bool:
        """writeToDisk with format parity: the file is the single-device
        `write_paged_map` layout (NTree::serialize analogue; tile slots
        ordered slab-major), so it reads back into either form."""
        return self.to_paged_map().write_to_disk(path)

    def read_from_disk(self, path) -> "ShardedPagedWorld":
        """readFromDisk: a NEW world on the same devices (the repo-wide
        operations-return-new-instances convention)."""
        from ..utils import io as map_io

        m = map_io.read_map(path, device=self.device)
        if int(m.map_type) != int(self.map_type):
            raise ValueError(f"file holds map type {int(m.map_type)}, world is {int(self.map_type)}")
        return type(self).from_paged_map(m, self.devices)

    def assert_distributed(self) -> None:
        """Fail loudly if a slab's pool is not on its own device, or if the
        pools use fewer distinct devices than the world names: the paged
        counterpart of shard_value.assert_sharded (a silent single-device
        fallback would still pass every equality check). On one card every
        slab is named on it, and one distinct device is what it asks for:
        there, and in the CPU tests (every slab on 'cpu'), it cannot tell a
        fallback onto one device from the world asked for, and no tensor
        moves between two devices that hold data. Only the placement is
        tested with distinct devices ('cpu' beside 'meta')."""
        seen = set()
        for m, want in zip(self.shards, self.devices):
            if m.pool.device != want:
                raise AssertionError(f"slab pool on {m.pool.device}, want {want}")
            seen.add(m.pool.device)
        if len(seen) != len(set(self.devices)):
            raise AssertionError(f"{len(seen)} distinct devices hold pools, want {len(set(self.devices))}")
