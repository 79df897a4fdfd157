"""High-level scene facade (reference: gpu_voxels/GpuVoxels.{h,cpp}).

Counterpart of gpu_voxels_tpu/api.py for the dense-map and robot slices.
`GpuVoxels` keeps a name -> map registry and a name -> robot registry. Maps
are functional values, so the facade holds the *current* map per name and
rebinds it after every operation; a per-map lock guards each rebind,
mirroring GpuVoxelsMap::m_mutex (GpuVoxelsMap.h:269).

Every map and robot lives on the device given to `initialize` (the card
when none is given). `add_map` builds every MapType: the three dense map
types, the five voxel-list types and the two octree types (a dense
hierarchy up to 1024 per axis, the paged tier past it). DH robots
(`add_robot_dh`) and any RobotInterface (`add_robot_object`) are inserted
with the robot calls. URDF robots, and the primitive, file and
visualisation surface raise NotImplementedError naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .constants import BitVoxelMeaning, MapType
from .geometry import generation
from .geometry.pointcloud import MetaPointCloud, PointCloud
from .maps.distance_map import DistanceVoxelMap
from .maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from .maps.paged import PagedHierarchicalMap
from .maps.voxellist import KIND_BIT, KIND_COUNT, KIND_PROB, VoxelList
from .maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from .robot.dh import KinematicChain
from .robot.robot import JointValueMap, RobotInterface
from .utils import FACADE, URDF, not_ported, resolve_device

DEFAULT_LIST_CAPACITY = 0
_LISTS = {
    MapType.MT_BITVECTOR_VOXELLIST: (KIND_BIT, "linear"),
    MapType.MT_BITVECTOR_MORTON_VOXELLIST: (KIND_BIT, "morton"),
    MapType.MT_PROBAB_VOXELLIST: (KIND_PROB, "linear"),
    MapType.MT_PROBAB_MORTON_VOXELLIST: (KIND_PROB, "morton"),
    MapType.MT_COUNTING_VOXELLIST: (KIND_COUNT, "linear"),
}


class GpuVoxels:
    _instance: Optional["GpuVoxels"] = None

    def __init__(self):
        self._dims = None
        self._side_length = None
        self._device = None
        self._maps: Dict[str, object] = {}
        self._locks: Dict[str, threading.RLock] = {}
        self._robots: Dict[str, RobotInterface] = {}

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
    def add_map(self, map_type: MapType, map_name: str, capacity: int = DEFAULT_LIST_CAPACITY):
        """addMap factory (GpuVoxels.cpp:164-270) over every MapType;
        `capacity` is a list's initial capacity."""
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
            m = self._octree(mt == MapType.MT_PROBAB_OCTREE)
        else:
            raise NotImplementedError(f"map type {mt.name}")
        self._maps[map_name] = m
        self._locks[map_name] = threading.RLock()
        return m

    def _octree(self, prob: bool):
        """Both octree types (Octree.cu:24-72): the dense status pyramid up to
        1024 per axis; past that, when every dim is a multiple of 64, the
        paged sparse tier. The reference's multi-device branch (its `mesh`
        argument) is ROADMAP Queue 1 item 13."""
        d, s = self._dims, self._side_length
        if max(d) > 1024 and all(v % 64 == 0 for v in d):
            return PagedHierarchicalMap(d, s, probabilistic=prob, device=self._device)
        cls = HierarchicalProbMap if prob else HierarchicalBitMap
        return cls.create(d, s, device=self._device)

    def del_map(self, map_name: str) -> bool:
        self._maps.pop(map_name, None)
        self._locks.pop(map_name, None)
        return True

    def get_map(self, map_name: str):
        return self._maps[map_name]

    def set_map(self, map_name: str, new_map) -> None:
        """Rebind a name after a functional update."""
        with self._locks[map_name]:
            self._maps[map_name] = new_map

    def update_map(self, map_name: str, fn):
        """Atomically apply a map -> map function; returns the new map."""
        with self._locks[map_name]:
            new = fn(self._maps[map_name])
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

    insert_point_cloud_from_file = not_ported("insert_point_cloud_from_file", FACADE)

    # -- robots ------------------------------------------------------------------
    def add_robot_dh(self, robot_name: str, link_names, dh_params, link_clouds: MetaPointCloud, **limits) -> bool:
        """A DH kinematic chain whose link clouds move to the facade's device."""
        self._robots[robot_name] = KinematicChain(link_names, dh_params, link_clouds.to(self._device), **limits)
        return True

    add_robot = not_ported("add_robot", URDF)

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

    add_primitives = not_ported("add_primitives", FACADE)
    save_map = not_ported("save_map", FACADE)
    load_map = not_ported("load_map", FACADE)
    visualize_map = not_ported("visualize_map", FACADE)
