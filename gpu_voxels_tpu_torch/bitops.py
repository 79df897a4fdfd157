"""256-bit voxel bit vectors as int32 planes (reference: helpers/BitVector.h).

Counterpart of gpu_voxels_tpu/bitops.py. A BitVector<256> is 8 planes along
a leading axis: ``planes[p]`` holds bits ``[32*p, 32*p+32)``. The JAX package
stores the planes as uint32; torch's uint32 lacks shifts, max and
``index_put_``, so here they are int32 tensors holding the same bits (a
bit-identical view: ``np.ndarray.view(np.int32)``, see ``interop``). Only
the bitwise operations below are used, so the sign is never interpreted.

torch's `>>` on int32 is arithmetic, so every right shift here is a masked
logical shift (`_lsr`); a left shift (`_lsl`) clears the bits it pushes out
before shifting, so no result depends on signed overflow.

The swept-volume shifts and margin checks work on a list of the 8 plane
tensors and apply per-plane masks as Python ints, so they never copy a
constant to the device. The reference's unpacked (bool[..., 256]) forms
are not ported: the packed forms equal them (tests hold both against the
reference and its byte-level oracle).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .constants import NUM_BIT_PLANES, SV_END, SV_START
from .utils import resolve_device

PLANE_DTYPE = torch.int32


def as_int32(word: int) -> int:
    """The int32 value holding the same 32 bits as the uint32 `word`."""
    word &= 0xFFFFFFFF
    return word - (1 << 32) if word >= 1 << 31 else word


def zeros(shape_suffix, device=None) -> torch.Tensor:
    """An all-clear bit vector array of shape [8, *shape_suffix]."""
    return torch.zeros((NUM_BIT_PLANES,) + tuple(shape_suffix), dtype=PLANE_DTYPE, device=resolve_device(device))


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


# -- whole-vector shifts and swept-volume margin checks ---------------------
Words = List[torch.Tensor]


def _lsr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 words by 0 < r < 32."""
    return (x >> r) & ((1 << (32 - r)) - 1)


def _lsl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Left shift of int32-held uint32 words by 0 < r < 32; the bits pushed
    out are cleared first, so no signed value overflows."""
    return (x & ((1 << (32 - r)) - 1)) << r


def _shift_words(w: Words, k: int) -> Words:
    """result bit b = input bit (b + k), zero fill (k > 0: toward lower bits)."""
    k = int(k)
    if k == 0:
        return list(w)
    n = len(w)
    zero = torch.zeros_like(w[0])

    def word(p):
        return w[p] if 0 <= p < n else zero

    q, r = divmod(abs(k), 32)
    out = []
    for p in range(n):
        if k > 0:
            lo, hi = word(p + q), word(p + q + 1)
            out.append(lo if r == 0 else _lsr(lo, r) | _lsl(hi, 32 - r))
        else:
            hi, lo = word(p - q), word(p - q - 1)
            out.append(hi if r == 0 else _lsl(hi, r) | _lsr(lo, 32 - r))
    return out


def _masked(w: Words, mask: np.ndarray) -> Words:
    """Each word AND its plane's uint32 constant of `mask`."""
    return [x & as_int32(int(m)) for x, m in zip(w, mask)]


def or_reduce_words(x: torch.Tensor) -> torch.Tensor:
    """Bitwise-OR reduction over the last axis, by halving (torch has no
    bitwise-or reduce). The reference's `or_reduce_words_spmd` exists for
    sharded maps; on one card a plain reduction does."""
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    while x.shape[-1] > 1:
        m = x.shape[-1]
        h = m // 2
        head = x[..., :h] | x[..., h:2 * h]
        if m % 2:
            head[..., :1] |= x[..., 2 * h:]
        x = head
    return x[..., 0]


def or_reduce(planes: torch.Tensor, axis: int) -> torch.Tensor:
    """OR-reduce bit vectors over a voxel axis (thrust BitvectorOr reduce);
    axis=0 is the first axis after the plane axis."""
    return or_reduce_words(planes.movedim(axis + 1, -1))


def perform_left_shift(planes: torch.Tensor, shift_size: int) -> torch.Tensor:
    """performLeftShift (BitVector.h:361-402): bit b of the result is bit
    (b + shift_size) of the input, zero fill, shift limited to 56 by the
    reference's 64-bit buffer; then bits 0..3 of byte 0 are cleared."""
    if not (0 <= shift_size <= 56):
        raise ValueError("shift size must be in [0, 56] (BitVector.h:361)")
    out = _shift_words(list(planes), shift_size)
    out[0] = out[0] & as_int32(0xFFFFFFF0)
    return torch.stack(out, dim=0)


def shift_bits(planes: torch.Tensor, k: int) -> torch.Tensor:
    """Whole-vector bit shift: result bit b = input bit (b + k), zero fill.
    Positive k shifts toward lower indices; no masking."""
    if int(k) == 0:
        return planes
    return torch.stack(_shift_words(list(planes), k), dim=0)


def bit_margin_collision_check_packed(v1: torch.Tensor, v2: torch.Tensor, margin: int):
    """Packed bitMarginCollisionCheck for sv_offset == 0: collisions =
    v1 & OR_{s in [-margin, margin]} shift_bits(v2 & ~0xF, s). Beyond margin
    24 the reference's 64-bit buffer drops matches; the full-domain form
    reproduces that. Returns (any_collision bool[...], collisions int32[8, ...])."""
    if margin > 24:
        _, collisions = bit_margin_collision_check_packed_full(v1, v2, torch.zeros_like(v1), margin, 0)
        return ~is_zero(collisions), collisions
    v2m = list(v2)
    v2m[0] = v2m[0] & as_int32(0xFFFFFFF0)  # the non-SV nibble never matches
    window = v2m
    for s in range(1, margin + 1):
        up, down = _shift_words(v2m, s), _shift_words(v2m, -s)
        window = [w | u | d for w, u, d in zip(window, up, down)]
    collisions = torch.stack([a & w for a, w in zip(v1, window)], dim=0)
    return ~is_zero(collisions), collisions


def _bitpos_mask(predicate) -> np.ndarray:
    """uint32[8] constant with bit b set iff predicate(b)."""
    words = np.zeros(NUM_BIT_PLANES, np.uint32)
    for b in range(NUM_BIT_PLANES * 32):
        if predicate(b):
            words[b >> 5] |= np.uint32(1) << np.uint32(b & 31)
    return words


def bit_margin_collision_check_packed_full(v1, v2, collisions, margin: int, sv_offset: int):
    """Packed bitMarginCollisionCheck (BitVector.h:415-471) over the full
    reference domain, any margin < 32 and any sv_offset, with every quirk of
    the reference's 64-bit buffer (gpu_voxels_tpu/bitops.py:241-305):

    * v1 byte B is buffered at bit 32 - margin + sv_offset//8; window shift
      s matches v2 at buffer position p + s + j (j = in-byte bit); positions
      past 63 overflow and the match is dropped, a per-s mask on j;
    * when the scan starts at byte 1 (sv_offset % 8 >= 4) the 4 initially
      buffered v2 bytes sit one byte higher than refilled ones and v2 byte
      4 never enters the buffer (regions A and B with shifts DA and DB);
    * records land at bit + sv_offset//8, truncated to the byte, and only
      bytes the scan touches overwrite `collisions`.

    Returns (any_collision bool[...], collisions int32[8, ...])."""
    if margin >= 32:
        raise ValueError("margin must be < 32 (BitVector.h:428-432)")
    sv_offset = int(sv_offset)
    byte_off, bit_off = sv_offset % 8, sv_offset // 8
    first_bit = SV_START + byte_off
    first_byte = first_bit >> 3

    v2m = list(v2)
    v2m[0] = v2m[0] & as_int32(0xFFFFFFF0)
    v2a = _masked(v2m, _bitpos_mask(lambda b: b < 32))
    v2b = _masked(v2m, _bitpos_mask(lambda b: b >= 8 * (4 + first_byte)))
    da = bit_off - margin - 8 * first_byte
    db = bit_off - margin

    v1w = list(v1)
    matched = [torch.zeros_like(x) for x in v1w]
    for s in range(2 * margin + 1):
        j_max = 31 + margin - bit_off - s  # uint64 overflow cutoff
        if j_max < 0:
            continue
        win = [x | y for x, y in zip(_shift_words(v2a, da + s), _shift_words(v2b, db + s))]
        hit = [a & w for a, w in zip(v1w, win)]
        if j_max < 7:
            hit = _masked(hit, _bitpos_mask(lambda b: (b & 7) <= j_max))
        matched = [m | h for m, h in zip(matched, hit)]

    stays = _bitpos_mask(lambda b: (b & 7) + bit_off < 8)
    recorded = _shift_words(_masked(matched, stays), -bit_off)
    written_bytes = {i >> 3 for i in range(first_bit, SV_END, 8)}
    written = _bitpos_mask(lambda b: (b >> 3) in written_bytes)
    kept = _masked(list(collisions), ~written)
    out = torch.stack([r | c for r, c in zip(_masked(recorded, written), kept)], dim=0)
    return ~is_zero(out), out
