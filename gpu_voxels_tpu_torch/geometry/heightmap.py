"""Heightmap-image -> point cloud loader (reference: helpers/HeightMapLoader.cpp).

Counterpart of gpu_voxels_tpu/geometry/heightmap.py (the same numpy code).
The reference decodes an image with stb_image and extrudes each pixel's
intensity into a column of points. Here images load via PIL when available;
.npy/.npz arrays always work (height in array units).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def load_height_array(path) -> np.ndarray:
    p = Path(path)
    if p.suffix in (".npy", ".npz"):
        arr = np.load(p)
        if isinstance(arr, np.lib.npyio.NpzFile):
            arr = arr[arr.files[0]]
        return np.asarray(arr, np.float32)
    try:
        from PIL import Image  # optional
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "PIL not available; provide the heightmap as .npy instead"
        ) from e
    img = Image.open(p).convert("L")
    return np.asarray(img, np.float32)


def heightmap_to_point_cloud(
    heights: np.ndarray,
    pixel_size: float = 1.0,
    height_scale: float = 1.0,
    height_offset: float = 0.0,
    fill_columns: bool = True,
) -> np.ndarray:
    """Extrude a [H, W] height array into points.

    fill_columns=True inserts a point per voxel-sized step of the column
    (solid terrain, the reference's behaviour); False keeps surface only.
    """
    heights = np.asarray(heights, np.float32) * height_scale + height_offset
    h, w = heights.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    if not fill_columns:
        return np.stack(
            [xs.ravel() * pixel_size, ys.ravel() * pixel_size, heights.ravel()], axis=1
        )
    pts = []
    step = pixel_size
    max_h = float(heights.max()) if heights.size else 0.0
    n_steps = int(np.ceil(max_h / step)) + 1
    for k in range(n_steps):
        z = k * step
        mask = heights >= z
        if not mask.any():
            break
        pts.append(
            np.stack(
                [xs[mask] * pixel_size, ys[mask] * pixel_size, np.full(mask.sum(), z, np.float32)],
                axis=1,
            )
        )
    return np.concatenate(pts, axis=0) if pts else np.zeros((0, 3), np.float32)
