"""Voxel maps."""
from .distance_map import DistanceVoxelMap
from .voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

__all__ = ["BitVectorVoxelMap", "CountingVoxelMap", "DistanceVoxelMap", "ProbVoxelMap"]
