"""256-bit voxel bit vectors as int32 planes (reference: helpers/BitVector.h).

Counterpart of gpu_voxels_tpu/bitops.py. A BitVector<256> is 8 planes along
a leading axis: ``planes[p]`` holds bits ``[32*p, 32*p+32)``. The JAX package
stores the planes as uint32; torch's uint32 lacks shifts, max and
``index_put_``, so here they are int32 tensors holding the same bits (a
bit-identical view: ``np.ndarray.view(np.int32)``, see ``interop``). Only
the bitwise operations below are used, so the sign is never interpreted.

This module is the subset the dense-map slice needs; the swept-volume shifts
and margin checks (gpu_voxels_tpu/bitops.py:147-467) come with kernel K4.
"""
from __future__ import annotations

import torch

from .constants import NUM_BIT_PLANES

PLANE_DTYPE = torch.int32


def as_int32(word: int) -> int:
    """The int32 value holding the same 32 bits as the uint32 `word`."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def zeros(shape_suffix, device=None) -> torch.Tensor:
    """An all-clear bit vector array of shape [8, *shape_suffix]."""
    return torch.zeros((NUM_BIT_PLANES,) + tuple(shape_suffix), dtype=PLANE_DTYPE, device=device)


def bit_plane(meaning: int) -> int:
    return int(meaning) >> 5


def bit_word(meaning: int) -> int:
    """uint32 word with only the bit for `meaning` set (within its plane)."""
    return 1 << (int(meaning) & 31)


def set_bit(planes: torch.Tensor, meaning: int) -> torch.Tensor:
    """BitVector::setBit for every voxel (BitVector.h:222-228)."""
    p = bit_plane(meaning)
    out = planes.clone()
    out[p] |= as_int32(bit_word(meaning))
    return out


def clear_bit(planes: torch.Tensor, meaning: int) -> torch.Tensor:
    p = bit_plane(meaning)
    out = planes.clone()
    out[p] &= as_int32(~bit_word(meaning))
    return out


def get_bit(planes: torch.Tensor, meaning: int) -> torch.Tensor:
    p = bit_plane(meaning)
    return (planes[p] & as_int32(bit_word(meaning))) != 0


def is_zero(planes: torch.Tensor) -> torch.Tensor:
    """BitVector::isZero (BitVector.h:162-172)."""
    return torch.all(planes == 0, dim=0)


def masked_fold(planes: torch.Tensor) -> torch.Tensor:
    """OR of every meaning bit except eBVM_FREE (plane-0 bit 0): the core of
    noneButEmpty (BitVector.h:184-198; the reference masks byte 0 with 254)."""
    out = planes[0] & as_int32(0xFFFFFFFE)
    for p in range(1, planes.shape[0]):
        out = out | planes[p]
    return out


def nonzero_u32(v: torch.Tensor) -> torch.Tensor:
    """int32 0/1 of (v != 0)."""
    return (v != 0).to(PLANE_DTYPE)


def none_but_empty(planes: torch.Tensor) -> torch.Tensor:
    """True if no bit except eBVM_FREE (bit 0) is set (BitVector.h:184-198)."""
    return masked_fold(planes) == 0


def occupied(planes: torch.Tensor) -> torch.Tensor:
    """Dense-collide occupancy: !noneButEmpty (DefaultCollider.hpp:76-81)."""
    return masked_fold(planes) != 0


def bv_or(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def bv_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b
