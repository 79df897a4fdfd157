"""int8 log-odds occupancy arithmetic (reference: voxel/ProbabilisticVoxel.hpp).

Counterpart of gpu_voxels_tpu/probability.py. torch int8 addition wraps, so
every update widens to int32 before the saturating clamp.
"""
from __future__ import annotations

import torch

from .constants import MAX_PROBABILITY, MIN_PROBABILITY, UNKNOWN_PROBABILITY
from .utils import to_device


def update_occupancy(occupancy: torch.Tensor, delta) -> torch.Tensor:
    """Saturating log-odds update (ProbabilisticVoxel.hpp:51-57).

    int32 add, clamped to [MIN_PROBABILITY, MAX_PROBABILITY]. The clamp floor
    is -127, so a single update moves a voxel out of UNKNOWN (-128).
    """
    if not isinstance(delta, (int, torch.Tensor)):
        delta = to_device(delta, torch.int32, occupancy.device)
    s = occupancy.to(torch.int32) + delta
    return s.clamp_(MIN_PROBABILITY, MAX_PROBABILITY).to(torch.int8)


def is_occupied(occupancy: torch.Tensor, threshold) -> torch.Tensor:
    """ProbabilisticVoxel::isOccupied: occupancy >= threshold, compared in int32."""
    return occupancy.to(torch.int32) >= int(threshold)


def is_unknown(occupancy: torch.Tensor) -> torch.Tensor:
    return occupancy == UNKNOWN_PROBABILITY
