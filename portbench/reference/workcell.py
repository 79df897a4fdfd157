"""The planner's workcell map and motion-check states."""
from __future__ import annotations

import numpy as np
import torch

from .sensing import MAX_P, UNKNOWN


def box_voxels(cfg: dict) -> list[tuple]:
    """Per box, per axis, the half-open range of the voxels whose centres
    (k + 0.5) * side lie inside [lo, hi], in float64."""
    side, dims = cfg["map"]["side_m"], cfg["map"]["dims"]
    out = []
    for lo, hi in cfg["boxes_m"]:
        axes = []
        for a in range(3):
            k0 = next((k for k in range(dims[a]) if (k + 0.5) * side >= lo[a]), dims[a])
            k1 = next((k for k in range(dims[a] - 1, -1, -1) if (k + 0.5) * side <= hi[a]), -1) + 1
            axes.append((k0, max(k0, k1)))
        out.append(tuple(axes))
    return out


def env_map(cfg: dict, device) -> torch.Tensor:
    """int8 [N]: UNKNOWN everywhere, 127 (an occupied insert) in every box voxel."""
    dx, dy, dz = cfg["map"]["dims"]
    env = torch.full((dz, dy, dx), UNKNOWN, dtype=torch.int8, device=device)
    for (x0, x1), (y0, y1), (z0, z1) in box_voxels(cfg):
        env[z0:z1, y0:y1, x0:x1] = MAX_P
    return env.reshape(-1)


def segment_states(a, b, resolution: float) -> np.ndarray:
    """float32 [n + 1, 6]: a to b in n = max(ceil(max|b - a| / res), 1)
    equal steps, both ends included (checkMotion's interpolation)."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    n = max(int(np.ceil(float(np.max(np.abs(b - a))) / resolution)), 1)
    r = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)[:, None]
    return a[None, :] * (1 - r) + b[None, :] * r
