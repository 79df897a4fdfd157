"""High-level map converters (reference: helpers_highlevel/DistanceMapConverter).

Counterpart of gpu_voxels_tpu/converters.py: a distance map to a prob or a
bit map (voxels within `clearance` of an obstacle become occupied), and the
prob <-> bit transfers of the GpuVoxelsMap::merge cross-type paths.
"""
from __future__ import annotations

import numpy as np
import torch

from . import bitops
from .constants import BitVoxelMeaning, float_to_probability
from .maps.distance_map import DistanceVoxelMap
from .maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap


def _within(dm: DistanceVoxelMap, clearance: float) -> torch.Tensor:
    """bool[N]: voxels whose squared distance is within the clearance."""
    thresh = int(np.ceil((clearance / dm.side_length) ** 2))
    return dm.squared_distances().reshape(-1) <= thresh


def _bit_map(mask: torch.Tensor, meaning, dims, side_length: float) -> BitVectorVoxelMap:
    """A bit map with `meaning` set where `mask` holds."""
    planes = bitops.zeros((mask.shape[0],), device=mask.device)
    word = bitops.as_int32(bitops.bit_word(int(meaning)))
    planes[bitops.bit_plane(int(meaning))] = torch.where(mask, word, 0).to(bitops.PLANE_DTYPE)
    occ = (mask & (int(meaning) != 0)).to(torch.uint8)
    return BitVectorVoxelMap(planes, dims, side_length, occ=occ)


def distance_map_to_prob_map(dm: DistanceVoxelMap, clearance: float = 0.0) -> ProbVoxelMap:
    """Voxels within `clearance` of an obstacle become occupied (127), the
    rest free (-127)."""
    occ = torch.where(_within(dm, clearance), 127, -127).to(torch.int8)
    return ProbVoxelMap(occ, dm.dims, dm.side_length)


def distance_map_to_bit_map(dm: DistanceVoxelMap, clearance: float = 0.0,
                            meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> BitVectorVoxelMap:
    return _bit_map(_within(dm, clearance), meaning, dm.dims, dm.side_length)


def prob_map_to_bit_map(pm: ProbVoxelMap, threshold: float = 0.5,
                        meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> BitVectorVoxelMap:
    mask = pm.data.to(torch.int32) >= float_to_probability(threshold)
    return _bit_map(mask, meaning, pm.dims, pm.side_length)


def bit_map_to_prob_map(bm: BitVectorVoxelMap) -> ProbVoxelMap:
    occ = torch.where(bm.occupied_mask(), 127, -128).to(torch.int8)
    return ProbVoxelMap(occ, bm.dims, bm.side_length)
