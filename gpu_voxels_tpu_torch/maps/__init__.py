"""Voxel maps."""
from .distance_map import DistanceVoxelMap
from .hierarchical import HierarchicalBitMap, HierarchicalProbMap
from .paged import PagedHierarchicalMap
from .voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

__all__ = ["BitVectorVoxelMap", "CountingVoxelMap", "DistanceVoxelMap", "HierarchicalBitMap", "HierarchicalProbMap",
           "PagedHierarchicalMap", "ProbVoxelMap"]
