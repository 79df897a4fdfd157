"""Primitive arrays for visualization overlays.

Equivalent of primitive_array/PrimitiveArray.{h,cu}: a device array of
spheres or cuboids, each a Vector4 (position + diameter), purely for the
visualization layer. Counterpart of gpu_voxels_tpu/primitive_array.py: a
frozen dataclass of one tensor on its device (the card when none is given).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace

import numpy as np
import torch

from .utils import resolve_device, to_device


class PrimitiveType(enum.IntEnum):
    ePRIM_SPHERE = 0
    ePRIM_CUBOID = 1


@dataclass(frozen=True, eq=False)
class PrimitiveArray:
    """positions_diameters: float32[N, 4] (x, y, z, diameter)."""

    positions_diameters: torch.Tensor
    prim_type: PrimitiveType

    @staticmethod
    def create(prim_type: PrimitiveType, device=None) -> "PrimitiveArray":
        return PrimitiveArray(torch.zeros((0, 4), dtype=torch.float32, device=resolve_device(device)),
                              PrimitiveType(prim_type))

    @property
    def size(self) -> int:
        return self.positions_diameters.shape[0]

    def set_points(self, positions, diameter=None) -> "PrimitiveArray":
        """modifyPrimitives overloads: [N,4] directly, or [N,3] + diameter
        (host input, moved to this array's device)."""
        arr = np.asarray(positions, np.float32)
        if arr.ndim != 2:
            arr = arr.reshape(-1, arr.shape[-1])
        if arr.shape[1] == 3:
            if diameter is None:
                raise ValueError("diameter required for [N,3] positions")
            arr = np.concatenate([arr, np.full((len(arr), 1), diameter, np.float32)], axis=1)
        return replace(self, positions_diameters=to_device(arr, torch.float32, self.positions_diameters.device))
