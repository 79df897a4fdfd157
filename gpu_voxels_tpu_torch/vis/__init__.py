"""Visualization: cube extraction, PLY / HTML export, the live viewer's
layer files and the per-map publishers (counterpart of gpu_voxels_tpu/vis)."""
from .extract import extract_cubes, occupied_coords
from .provider import VisProvider

__all__ = ["VisProvider", "extract_cubes", "occupied_coords"]
