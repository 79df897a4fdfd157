"""Geometry helpers: rigid transforms, point clouds and deterministic test geometry."""
from . import generation, pointcloud, transforms

__all__ = ["generation", "pointcloud", "transforms"]
