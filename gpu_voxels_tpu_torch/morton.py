"""Morton (Z-order) codes, bit-compatible with the reference octree.

Counterpart of gpu_voxels_tpu/morton.py (reference:
packages/gpu_voxels/src/gpu_voxels/octree/Morton.h:80-160). The 60-bit code
is 3 x 20-bit coordinates; `morton_code60` returns it as the reference's
(hi30, lo30) word pair, `morton_key60` as one int64 ``hi << 30 | lo``, the
uint64 the reference writes to disk.

torch's shifts fail on uint32 (H1), so every function here works on int64
tensors holding uint32 values: inputs are reduced mod 2^32 first (a
negative coordinate wraps as the reference's uint32 cast does) and every
left shift is masked back to 32 bits, so the results equal the reference's
uint32 arithmetic bit for bit.
"""
from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF
LO30_MASK = (1 << 30) - 1


def _u32(x) -> torch.Tensor:
    """`x` as int64 holding its uint32 value (two's-complement wrap)."""
    return torch.as_tensor(x).to(torch.int64) & U32_MASK


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every third position (Morton.h:80-100)."""
    x = _u32(x)
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2 (Morton.h Compact1By2)."""
    x = _u32(x) & 0x09249249
    x = (x ^ (x >> 2)) & 0x030C30C3
    x = (x ^ (x >> 4)) & 0x0300F00F
    x = (x ^ (x >> 8)) & 0xFF0000FF
    x = (x ^ (x >> 16)) & 0x000003FF
    return x


def morton_code30(x, y, z) -> torch.Tensor:
    """30-bit Morton code of coordinates < 1024 (Morton.h morton_code)."""
    return (_part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)) & U32_MASK


def inv_morton_code30(code):
    code = _u32(code)
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def morton_code60(x, y, z):
    """60-bit Morton code as the (hi30, lo30) pair (Morton.h morton_code60)."""
    x, y, z = _u32(x), _u32(y), _u32(z)
    lo = morton_code30(x & 1023, y & 1023, z & 1023)
    hi = morton_code30(x >> 10, y >> 10, z >> 10)
    return hi, lo


def morton_key60(x, y, z) -> torch.Tensor:
    """The 60-bit code as one int64, ``hi << 30 | lo`` (both words < 2^30)."""
    hi, lo = morton_code60(x, y, z)
    return (hi << 30) | lo


def inv_morton_code60(hi, lo):
    """(hi30, lo30) -> (x, y, z) (Morton.h inv_morton_code60)."""
    xl, yl, zl = inv_morton_code30(lo)
    xh, yh, zh = inv_morton_code30(hi)
    return ((xh << 10) | xl) & U32_MASK, ((yh << 10) | yl) & U32_MASK, ((zh << 10) | zl) & U32_MASK
