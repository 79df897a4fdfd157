"""High-level scene facade (reference: gpu_voxels/GpuVoxels.{h,cpp}).

Counterpart of gpu_voxels_tpu/api.py. `GpuVoxels` keeps name -> map,
name -> robot and name -> primitive-array registries and offers the
reference's convenience surface (GpuVoxels.h:91-415): the map factory over
every MapType, box / file / robot insertion, robot configuration, the
maps' files and the visualization triggers. Maps are functional values, so
the facade holds the *current* map per name and rebinds it after every
operation; a per-map lock guards each rebind, mirroring
GpuVoxelsMap::m_mutex (GpuVoxelsMap.h:269).

Every map, robot and primitive array lives on the device given to
`initialize` (the card when none is given). `add_map` builds every MapType:
the three dense map types, the five voxel-list types and the two octree
types (a dense hierarchy up to 1024 per axis, the paged tier past it).
With `mesh` (a parallel.GridMesh) a map is laid over the mesh's z slabs:
the dense types and the dense hierarchies as slab-sharded values
(parallel.shard_map_value), re-pinned after every update; a paged-size
octree as a parallel.ShardedPagedWorld, one slab map per device.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .constants import BitVoxelMeaning, MapType
from .geometry import files, generation
from .geometry.pointcloud import MetaPointCloud, PointCloud
from .maps.distance_map import DistanceVoxelMap
from .maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from .maps.paged import PagedHierarchicalMap
from .maps.voxellist import KIND_BIT, KIND_COUNT, KIND_PROB, VoxelList
from .maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from .parallel import ShardedPagedWorld, reshard_like, shard_map_value
from .parallel.shard_value import read_sharded_map
from .primitive_array import PrimitiveArray, PrimitiveType
from .robot.dh import KinematicChain
from .robot.robot import JointValueMap, RobotInterface
from .robot.urdf import UrdfRobot
from .utils import io as map_io
from .utils import resolve_device
from .utils.logging import Gpu_voxels as LOG
from .vis.provider import VisProvider
from .vis.serve import default_dir, publish_primitives

DEFAULT_LIST_CAPACITY = 0
_LISTS = {
    MapType.MT_BITVECTOR_VOXELLIST: (KIND_BIT, "linear"),
    MapType.MT_BITVECTOR_MORTON_VOXELLIST: (KIND_BIT, "morton"),
    MapType.MT_PROBAB_VOXELLIST: (KIND_PROB, "linear"),
    MapType.MT_PROBAB_MORTON_VOXELLIST: (KIND_PROB, "morton"),
    MapType.MT_COUNTING_VOXELLIST: (KIND_COUNT, "linear"),
}

# the file types read_map gives a dense map (a CountingVoxelMap's file goes to the list reader, F14)
_DENSE_FILES = (MapType.MT_PROBAB_VOXELMAP, MapType.MT_BITVECTOR_VOXELMAP, MapType.MT_DISTANCE_VOXELMAP)


def _slab_file(path) -> bool:
    """A file read slab by slab onto a mesh: a dense map's, or a dense
    hierarchy's octree file (not the paged tier's body)."""
    map_type = map_io._file_map_type(path)
    return map_type in _DENSE_FILES or (map_type in map_io.OCTREE_TYPES and not map_io.is_paged_octree(path))


class GpuVoxels:
    _instance: Optional["GpuVoxels"] = None

    def __init__(self):
        self._dims = None
        self._side_length = None
        self._device = None
        self._maps: Dict[str, object] = {}
        self._locks: Dict[str, threading.RLock] = {}
        self._robots: Dict[str, RobotInterface] = {}
        self._prim_arrays: Dict[str, PrimitiveArray] = {}
        self._vis: Dict[str, VisProvider] = {}
        self._meshes: Dict[str, object] = {}

    # -- lifecycle -----------------------------------------------------------
    @classmethod
    def get_instance(cls) -> "GpuVoxels":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def initialize(self, dim_x: int, dim_y: int, dim_z: int, voxel_side_length: float, device=None) -> None:
        self._dims = (int(dim_x), int(dim_y), int(dim_z))
        self._side_length = float(voxel_side_length)
        self._device = resolve_device(device)

    def get_dimensions(self):
        return self._dims

    def get_voxel_side_length(self) -> float:
        return self._side_length

    # -- map registry ----------------------------------------------------------
    def add_map(self, map_type: MapType, map_name: str, capacity: int = DEFAULT_LIST_CAPACITY, mesh=None):
        """addMap factory (GpuVoxels.cpp:164-270) over every MapType;
        `capacity` is a list's initial capacity.

        `mesh` (a parallel.GridMesh) opts the map into multi-device z-slab
        sharding: a paged-size octree is built directly as a
        ShardedPagedWorld over the mesh's devices; the other dense types and
        hierarchies become slab-sharded values, and every facade update
        re-pins the layout. Voxel lists take no mesh (as in the reference,
        where they have no sharding layout)."""
        if self._dims is None:
            raise RuntimeError("Call initialize() first")
        if map_name in self._maps:
            raise ValueError(f"map '{map_name}' already exists")
        mt = MapType(map_type)
        if mt == MapType.MT_PROBAB_VOXELMAP:
            m = ProbVoxelMap.create(self._dims, self._side_length, device=self._device)
        elif mt == MapType.MT_BITVECTOR_VOXELMAP:
            m = BitVectorVoxelMap.create(self._dims, self._side_length, device=self._device)
        elif mt == MapType.MT_DISTANCE_VOXELMAP:
            m = DistanceVoxelMap.create(self._dims, self._side_length, device=self._device)
        elif mt in _LISTS:
            kind, id_mode = _LISTS[mt]
            m = VoxelList.create(self._dims, self._side_length, kind, capacity, id_mode, device=self._device)
        elif mt in (MapType.MT_PROBAB_OCTREE, MapType.MT_BITVECTOR_OCTREE):
            m = self._octree(mt == MapType.MT_PROBAB_OCTREE, mesh)
        else:
            raise NotImplementedError(f"map type {mt.name}")
        if mesh is not None and not isinstance(m, ShardedPagedWorld):
            m = shard_map_value(m, mesh)
            self._meshes[map_name] = mesh
        self._maps[map_name] = m
        self._locks[map_name] = threading.RLock()
        self._vis[map_name] = VisProvider(map_name)
        return m

    def _octree(self, prob: bool, mesh=None):
        """Both octree types (Octree.cu:24-72): the dense status pyramid up to
        1024 per axis; past that, when every dim is a multiple of 64, the
        paged sparse tier, over a mesh a ShardedPagedWorld built directly in
        sharded form (the host-stateful tier shards as one slab map, pool
        and allocator per device)."""
        d, s = self._dims, self._side_length
        if max(d) > 1024 and all(v % 64 == 0 for v in d):
            if mesh is not None:
                return ShardedPagedWorld(d, s, prob, devices=list(mesh.devices.reshape(-1)))
            return PagedHierarchicalMap(d, s, probabilistic=prob, device=self._device)
        cls = HierarchicalProbMap if prob else HierarchicalBitMap
        return cls.create(d, s, device=self._device)

    def del_map(self, map_name: str) -> bool:
        for d in (self._maps, self._locks, self._vis, self._meshes):
            d.pop(map_name, None)
        return True

    def get_map(self, map_name: str):
        return self._maps[map_name]

    def _pinned(self, map_name: str, m):
        """A mesh-registered map re-pinned to its slab layout (the value
        itself when it already is)."""
        mesh = self._meshes.get(map_name)
        return m if mesh is None else reshard_like(m, mesh)

    def set_map(self, map_name: str, new_map) -> None:
        """Rebind a name after a functional update (re-pins mesh layouts)."""
        with self._locks[map_name]:
            self._maps[map_name] = self._pinned(map_name, new_map)

    def update_map(self, map_name: str, fn):
        """Atomically apply a map -> map function; returns the new map,
        re-pinned to its slab layout when the map was added with a mesh."""
        with self._locks[map_name]:
            new = self._pinned(map_name, fn(self._maps[map_name]))
            self._maps[map_name] = new
            return new

    def clear_map(self, map_name: str, voxel_meaning: Optional[BitVoxelMeaning] = None) -> bool:
        if voxel_meaning is None:
            self.update_map(map_name, lambda m: m.clear_map())
        else:
            self.update_map(map_name, lambda m: m.clear_voxel_meaning(int(voxel_meaning)))
        return True

    # -- insertion convenience -------------------------------------------------
    def insert_point_cloud_into_map(self, cloud, map_name: str, voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> bool:
        pts = cloud.points if isinstance(cloud, PointCloud) else cloud
        self.update_map(map_name, lambda m: m.insert_point_cloud(pts, voxel_meaning))
        return True

    def insert_box_into_map(
        self,
        corner_min,
        corner_max,
        map_name: str,
        voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED,
        points_per_voxel: int = 1,
    ) -> bool:
        """insertBoxIntoMap (GpuVoxels.cpp:519-535)."""
        delta = self._side_length / points_per_voxel
        cloud = generation.create_box_of_points(corner_min, corner_max, delta)
        return self.insert_point_cloud_into_map(np.asarray(cloud, np.float32), map_name, voxel_meaning)

    def insert_meta_point_cloud_into_map(
        self, meta: MetaPointCloud, map_name: str, voxel_meanings: Optional[List[int]] = None
    ) -> bool:
        self.update_map(map_name, lambda m: m.insert_meta_point_cloud(meta, voxel_meanings))
        return True

    def insert_point_cloud_from_file(
        self,
        map_name: str,
        path,
        use_model_path: bool = False,
        voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED,
        shift_to_zero: bool = False,
        offset_xyz=(0.0, 0.0, 0.0),
        scaling: float = 1.0,
    ) -> bool:
        """insertPointCloudFromFile (GpuVoxels.cpp): the file is read on the
        host, then the points go to the map's device."""
        pts = files.load_point_cloud(path, use_model_path, shift_to_zero, offset_xyz, scaling)
        return self.insert_point_cloud_into_map(pts, map_name, voxel_meaning)

    # -- robots ------------------------------------------------------------------
    def add_robot_dh(self, robot_name: str, link_names, dh_params, link_clouds: MetaPointCloud, **limits) -> bool:
        """A DH kinematic chain whose link clouds move to the facade's device."""
        self._robots[robot_name] = KinematicChain(link_names, dh_params, link_clouds.to(self._device), **limits)
        return True

    def add_robot(self, robot_name: str, path_to_urdf_file, use_model_path: bool = False) -> bool:
        """addRobot from a URDF (GpuVoxels.h addRobot urdf overload): link
        clouds from the same-named .binvox files, on the facade's device."""
        path = files.model_path(True) / path_to_urdf_file if use_model_path else path_to_urdf_file
        self._robots[robot_name] = UrdfRobot(path, device=self._device)
        return True

    def add_robot_object(self, robot_name: str, robot: RobotInterface) -> bool:
        self._robots[robot_name] = robot
        return True

    def get_robot(self, robot_name: str) -> RobotInterface:
        return self._robots[robot_name]

    def set_robot_configuration(self, robot_name: str, jointmap: JointValueMap) -> bool:
        self._robots[robot_name].set_configuration(jointmap)
        return True

    def get_robot_configuration(self, robot_name: str) -> JointValueMap:
        return self._robots[robot_name].get_configuration()

    def update_robot_part(self, robot_name: str, link_name: str, pointcloud) -> bool:
        self._robots[robot_name].update_point_cloud(link_name, pointcloud)
        return True

    def insert_robot_into_map(self, robot_name: str, map_name: str, voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> bool:
        """insertRobotIntoMap (GpuVoxels.cpp:499-517)."""
        clouds = self._robots[robot_name].get_transformed_clouds()
        self.update_map(map_name, lambda m: m.insert_point_cloud(clouds.points, voxel_meaning))
        return True

    def insert_robot_into_map_self_collision_aware(
        self, robot_name: str, map_name: str, voxel_meaning=BitVoxelMeaning.eBVM_OCCUPIED
    ) -> torch.Tensor:
        """Insert + self-collision test (the ProbVoxelMap path). Returns the
        clash as a device bool; read it on the host to branch."""
        clouds = self._robots[robot_name].get_transformed_clouds()
        result = {}

        def apply(m):
            new, clash = m.insert_meta_point_cloud_with_self_collision_check(clouds, voxel_meaning)
            result["clash"] = clash
            return new

        self.update_map(map_name, apply)
        return result["clash"]

    # -- primitive arrays --------------------------------------------------------
    def add_primitives(self, prim_type: PrimitiveType, array_name: str) -> bool:
        self._prim_arrays[array_name] = PrimitiveArray.create(prim_type, device=self._device)
        return True

    def del_primitives(self, array_name: str) -> bool:
        self._prim_arrays.pop(array_name, None)
        return True

    def modify_primitives(self, array_name: str, positions, diameter=None) -> bool:
        self._prim_arrays[array_name] = self._prim_arrays[array_name].set_points(positions, diameter)
        return True

    def get_primitives(self, array_name: str) -> PrimitiveArray:
        return self._prim_arrays[array_name]

    # -- persistence -------------------------------------------------------------
    def save_map(self, map_name: str, path) -> bool:
        """Map writeToDisk through the facade (the reference's formats, every
        tier: utils/io.write_map)."""
        map_io.write_map(self._maps[map_name], path)
        return True

    def load_map(self, map_name: str, path) -> bool:
        """Map readFromDisk through the facade: the file's MapType decides
        the tier (utils/io.read_map), the map lands on the facade's device
        and is bound to `map_name`. A sharded paged world reloads
        distributed over its own devices; a mesh-registered map reads a
        dense map's or a dense hierarchy's file slab by slab onto the mesh,
        any other file whole, then re-pinned to its slab layout."""
        cur = self._maps.get(map_name)
        if isinstance(cur, ShardedPagedWorld):
            self._maps[map_name] = cur.read_from_disk(path)
            return True
        mesh = self._meshes.get(map_name)
        if mesh is not None and _slab_file(path):
            self._maps[map_name] = read_sharded_map(path, mesh)
        else:
            self._maps[map_name] = self._pinned(map_name, map_io.read_map(path, device=self._device))
        self._locks.setdefault(map_name, threading.RLock())
        self._vis.setdefault(map_name, VisProvider(map_name))
        return True

    # -- visualization -------------------------------------------------------------
    def visualize_map(self, map_name: str, force_repaint: bool = True) -> bool:
        return self._vis[map_name].visualize(self._maps[map_name], force_repaint)

    def visualize_primitives_array(self, array_name: str, force_repaint: bool = True) -> bool:
        """Publish a primitive array into the live viewer manifest
        (VisPrimitiveArray, vis_interface/VisPrimitiveArray.h)."""
        arr = self._prim_arrays[array_name]
        publish_primitives(default_dir(), array_name, arr)
        LOG.info("primitive array '%s': %d primitives published", array_name, arr.size)
        return True


# the reference's camelCase method aliases (addMap, insertPointCloud, ...)
from . import compat as _compat  # noqa: E402

_compat.install()
