"""Geometry helpers: rigid transforms, point clouds, point-cloud files,
heightmaps and deterministic test geometry."""
from . import files, generation, heightmap, pointcloud, transforms
from .pointcloud import MetaPointCloud, PointCloud

__all__ = ["MetaPointCloud", "PointCloud", "files", "generation", "heightmap", "pointcloud", "transforms"]
