"""CamelCase compatibility aliases matching the reference API names.

Users migrating from the CUDA GPU-Voxels can keep their method spelling:
`gvl.addMap(...)`, `map.insertPointCloud(...)`, `map.collideWith(...)` etc.
resolve to the snake_case implementations. Counterpart of
gpu_voxels_tpu/compat.py: the same alias tables, installed by
gpu_voxels_tpu_torch.api at its import on the port's classes, the
multi-device ShardedPagedWorld and slab-sharded dense maps included.
"""
from __future__ import annotations

_FACADE_ALIASES = {
    "getInstance": "get_instance",
    "addMap": "add_map",
    "delMap": "del_map",
    "clearMap": "clear_map",
    "getMap": "get_map",
    "visualizeMap": "visualize_map",
    "visualizePrimitivesArray": "visualize_primitives_array",
    "addRobot": "add_robot",
    "setRobotConfiguration": "set_robot_configuration",
    "getRobotConfiguration": "get_robot_configuration",
    "updateRobotPart": "update_robot_part",
    "insertPointCloudFromFile": "insert_point_cloud_from_file",
    "insertPointCloudIntoMap": "insert_point_cloud_into_map",
    "insertMetaPointCloudIntoMap": "insert_meta_point_cloud_into_map",
    "insertRobotIntoMap": "insert_robot_into_map",
    "insertBoxIntoMap": "insert_box_into_map",
    "addPrimitives": "add_primitives",
    "delPrimitives": "del_primitives",
    "modifyPrimitives": "modify_primitives",
    "getDimensions": "get_dimensions",
    "getVoxelSideLength": "get_voxel_side_length",
    "saveMap": "save_map",
    "loadMap": "load_map",
}

_MAP_ALIASES = {
    "insertPointCloud": "insert_point_cloud",
    "insertMetaPointCloud": "insert_meta_point_cloud",
    "insertSensorData": "insert_sensor_data",
    "collideWith": "collide_with",
    "collideWithResolution": "collide_with_resolution",
    "collideWithTypes": "collide_with_types",
    "collideWithBitcheck": "collide_with_bitcheck",
    "clearMap": "clear_map",
    "clearBit": "clear_bit",
    "clearVoxelMeaning": "clear_voxel_meaning",
    "shiftLeftSweptVolumeIDs": "shift_left_swept_volume_ids",
    "collisionCheck": "collides_with",
    "insertPointCloudWithFreespaceCalculation": "insert_point_cloud_with_free_space",
    "writeToDisk": "write_to_disk",
    "readFromDisk": "read_from_disk",
    "getMemoryUsage": "memory_usage",
    "printVoxelMapData": "print_voxel_map_data",
    "clearBitVoxelMeaning": "clear_voxel_meaning",
    "clearBits": "clear_bits",
    "initSensorSettings": "init_sensor_settings",
    "updateSensorPose": "update_sensor_pose",
    "insertRobotConfiguration": "insert_robot_configuration",
    "clearCollisionFlags": "clear_collision_flags",
    "needsRebuild": "needs_rebuild",
    "checkTree": "check_tree",
    "collideWithTypesConsideringUnknownCells": "collide_with_counting_unknown",
}

_LIST_ALIASES = {
    "insertPointCloud": "insert_point_cloud",
    "collideWith": "collide_with",
    "collideWithResolution": "collide_with_resolution",
    "collideWithTypes": "collide_with_types",
    "collideWithBitcheck": "collide_with_bitcheck",
    "collideCountingPerMeaning": "collide_counting_per_meaning",
    "collideWithTypeMask": "collide_with_type_mask",
    "clearMap": "clear_map",
    "subtractFromCountingVoxelList": "subtract",
    "getMemoryUsage": "memory_usage",
    "clearBitVoxelMeaning": "clear_voxel_meaning",
    "shrinkToFit": "shrink_to_fit",
    "findMatchingVoxels": "find_matching",
    "shiftLeftSweptVolumeIDs": "shift_left_swept_volume_ids",
    "insertMetaPointCloud": "insert_meta_point_cloud",
    "insertRobotConfiguration": "insert_robot_configuration",
    "needsRebuild": "needs_rebuild",
    "writeToDisk": "write_to_disk",
    "readFromDisk": "read_from_disk",
}

_DISTANCE_ALIASES = {
    "parallelBanding3D": "parallel_banding",
    "jumpFlood3D": "jump_flood",
    "exactDistances3D": "exact_separable",
    "getObstacleDistance": "get_obstacle_distance",
    "getSquaredObstacleDistance": "get_squared_obstacle_distance",
    "mergeOccupied": "merge_occupied",
    "differences3D": "differences",
    "extract_distances": "extract_distances",
    "init_floodfill": "init_floodfill",
}


def _apply(cls, aliases) -> None:
    for camel, snake in aliases.items():
        if hasattr(cls, snake) and not hasattr(cls, camel):
            setattr(cls, camel, getattr(cls, snake))


def install() -> None:
    from .api import GpuVoxels
    from .maps.distance_map import DistanceVoxelMap
    from .maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
    from .maps.paged import PagedHierarchicalMap
    from .maps.voxellist import VoxelList
    from .maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
    from .parallel.paged_world import ShardedPagedWorld
    from .parallel.shard_value import ShardedDenseMap, ShardedPyramid

    _apply(GpuVoxels, _FACADE_ALIASES)
    for cls in (
        ProbVoxelMap,
        BitVectorVoxelMap,
        CountingVoxelMap,
        HierarchicalProbMap,
        HierarchicalBitMap,
        PagedHierarchicalMap,
        ShardedPagedWorld,
    ):
        _apply(cls, _MAP_ALIASES)
    _apply(VoxelList, _LIST_ALIASES)
    _apply(DistanceVoxelMap, _DISTANCE_ALIASES)
    _apply(DistanceVoxelMap, _MAP_ALIASES)
    _apply(ShardedDenseMap, _MAP_ALIASES)
    _apply(ShardedDenseMap, _DISTANCE_ALIASES)
    _apply(ShardedPyramid, _MAP_ALIASES)
