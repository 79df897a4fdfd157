"""Voxel maps."""
from .voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

__all__ = ["BitVectorVoxelMap", "CountingVoxelMap", "ProbVoxelMap"]
