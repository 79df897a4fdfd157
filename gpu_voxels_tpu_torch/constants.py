"""Core constants and enums of the TPU voxel-world engine.

Mirrors the numeric contract of the reference GPU-Voxels library
(reference: packages/gpu_voxels/src/gpu_voxels/helpers/common_defines.h) so that
collision counts, probability semantics and packing formats agree bit-for-bit.
"""
from __future__ import annotations

import enum

# --- Bit vector / voxel meanings (common_defines.h:46-59) -------------------
BIT_VECTOR_LENGTH = 256
NUM_BIT_PLANES = BIT_VECTOR_LENGTH // 32  # uint32 planes


class BitVoxelMeaning(enum.IntEnum):
    """Semantic meaning of a voxel bit (common_defines.h:51-59)."""

    eBVM_FREE = 0
    eBVM_OCCUPIED = 1
    eBVM_COLLISION = 2
    eBVM_UNKNOWN = 3
    eBVM_SWEPT_VOLUME_START = 4
    eBVM_SWEPT_VOLUME_END = 254
    eBVM_UNDEFINED = 255


class MapType(enum.IntEnum):
    """Map data-structure selector (common_defines.h:62-75)."""

    MT_BITVECTOR_VOXELMAP = 0
    MT_BITVECTOR_VOXELLIST = 1
    MT_BITVECTOR_OCTREE = 2
    MT_BITVECTOR_MORTON_VOXELLIST = 3
    MT_PROBAB_VOXELMAP = 4
    MT_PROBAB_VOXELLIST = 5
    MT_PROBAB_OCTREE = 6
    MT_PROBAB_MORTON_VOXELLIST = 7
    MT_COUNTING_VOXELLIST = 8
    MT_DISTANCE_VOXELMAP = 9


# --- Probability (common_defines.h:149-152) ---------------------------------
UNKNOWN_PROBABILITY = -128
MIN_PROBABILITY = -127
MAX_PROBABILITY = 127

# Sensor model for dense probabilistic maps (VoxelMapOperations.h:38-39)
SENSOR_MODEL_FREE = -10
SENSOR_MODEL_OCCUPIED = 72

# --- Distance map / PBA (common_defines.h:104-136) --------------------------
PBA_UNINITIALISED_COORD = 1023  # (1 << 10) - 1
MAX_OBSTACLE_DISTANCE = 2147483647  # INT_MAX
DISTANCE_UNINITIALISED = 0
PBA_OBSTACLE_DISTANCE = 0
MANHATTAN_DISTANCE_UNINITIALIZED = 32767
MANHATTAN_DISTANCE_START = MANHATTAN_DISTANCE_UNINITIALIZED - 1
MANHATTAN_DISTANCE_TOO_CLOSE = MANHATTAN_DISTANCE_UNINITIALIZED - 2

# Packed "uninitialised" DistanceVoxel value: x=y=z=1023 (DistanceVoxel.hpp:31-101)
PBA_UNINITIALISED_PACKED = (
    PBA_UNINITIALISED_COORD
    | (PBA_UNINITIALISED_COORD << 10)
    | (PBA_UNINITIALISED_COORD << 20)
)

# --- Hierarchy (octree replacement) (common_defines.h:189-191) --------------
BRANCHING_FACTOR = 8
LEVEL_COUNT = 15
# Probabilistic octree node occupancy threshold (octree/DataTypes.h:78)
THRESHOLD_OCCUPANCY = 10

# --- Swept volumes (common_defines.h:50-59, BitVector.h:361-402) ------------
SV_START = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)
SV_END = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_END)
MAX_SV_SHIFT = 56  # performLeftShift buffer limit


def float_to_probability(val: float) -> int:
    """Map a [0,1] float threshold to int8 log-odds (DefaultCollider.hpp:94-98).

    C semantics: float tmp = val*(127-(-127)) + (-127); return (int8)tmp
    (truncation toward zero, like C float->int casts).
    """
    tmp = val * (float(MAX_PROBABILITY) - float(MIN_PROBABILITY)) + MIN_PROBABILITY
    return int(tmp)  # Python int() truncates toward zero like C


def meaning_to_probability(meaning: int) -> int:
    """ProbabilisticVoxel::insert semantics (ProbabilisticVoxel.hpp:77-92)."""
    m = int(meaning)
    if m == BitVoxelMeaning.eBVM_FREE:
        return MIN_PROBABILITY
    if m in (BitVoxelMeaning.eBVM_OCCUPIED, BitVoxelMeaning.eBVM_COLLISION):
        return MAX_PROBABILITY
    return UNKNOWN_PROBABILITY
