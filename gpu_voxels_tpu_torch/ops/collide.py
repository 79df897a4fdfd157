"""Dense map x dense map collision reductions, in plain torch.

Counterpart of gpu_voxels_tpu/ops/collide.py (kernelCollideVoxelMaps /
...Debug / ...Bitvector, VoxelMapOperations.hpp:78-239). These forms are the
semantics spec: `ops/collide_cuda` holds the CUDA kernels K1 and K2 for
count_prob_prob and count_and_mark_prob, K4 for collide_with_types_bit_bit
(sv_offset 0, margin <= 24) and K7 for count_bit_bit, and takes these
functions for CPU tensors.

Offset semantics replicate collisionCheckWithCounterRelativeTransform
(TemplateVoxelMap.hpp:486-519): the *left* map's base pointer is shifted by
the signed linear offset, i.e. collide(left[i+off], right[i]); indices where
either side is out of range contribute nothing.

Counts are 0-d int64 tensors on the maps' device: nothing here syncs with
the host until the caller reads the number.
"""
from __future__ import annotations

import torch

from .. import bitops
from ..constants import MAX_PROBABILITY
from .insert import linear_offset


def _offset_slices(n: int, off: int):
    """Valid flat ranges for collide(left[i+off], right[i])."""
    off = int(off)
    if off >= 0:
        return slice(off, n), slice(0, n - off)
    return slice(0, n + off), slice(-off, n)


def _slices(n: int, dims, offset):
    return _offset_slices(n, linear_offset(offset, dims) if dims else 0)


def _count(hit: torch.Tensor) -> torch.Tensor:
    return hit.sum(dtype=torch.int64)


def prob_occupied(data: torch.Tensor, threshold) -> torch.Tensor:
    return data.to(torch.int32) >= int(threshold)


def count_prob_prob(a, b, t1, t2, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """Counting collide, prob x prob (DefaultCollider thresholds)."""
    sa, sb = _slices(a.shape[-1], dims, offset)
    return _count(prob_occupied(a[sa], t1) & prob_occupied(b[sb], t2))


def count_and_mark_prob(a, b, t1, t2, dims=None, offset=(0, 0, 0)):
    """kernelCollideVoxelMapsDebug semantics for prob maps: count collisions
    AND insert eBVM_COLLISION (occupancy=127) into the left map's colliding
    voxels (VoxelMapOperations.hpp:129-184). Returns (count, new_left)."""
    sa, sb = _slices(a.shape[-1], dims, offset)
    hit = prob_occupied(a[sa], t1) & prob_occupied(b[sb], t2)
    new_a = a.clone()
    new_a[sa] = torch.where(hit, MAX_PROBABILITY, a[sa]).to(a.dtype)
    return _count(hit), new_a


def count_and_mark_prob_run(a, b, t1, t2, a0: int, b0: int, length: int):
    """count_and_mark_prob over one run: a[a0 + i] against b[b0 + i] for
    i < length, marks in a copy of all of `a`. A slab-sharded marking
    collide runs one per run of slabs an offset pairs. Returns (count,
    new_a)."""
    sa, sb = slice(a0, a0 + length), slice(b0, b0 + length)
    hit = prob_occupied(a[sa], t1) & prob_occupied(b[sb], t2)
    new_a = a.clone()
    new_a[sa] = torch.where(hit, MAX_PROBABILITY, a[sa]).to(a.dtype)
    return _count(hit), new_a


def count_bit_bit(a_planes, b_planes, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """Counting collide, bit x bit: both !noneButEmpty (DefaultCollider.hpp:76-81)."""
    sa, sb = _slices(a_planes.shape[-1], dims, offset)
    return _count(bitops.occupied(a_planes[:, sa]) & bitops.occupied(b_planes[:, sb]))


def count_prob_bit(prob, t1, bit_planes, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """prob x bit: occupancy >= t && !noneButEmpty (DefaultCollider.hpp:60-73)."""
    sa, sb = _slices(prob.shape[-1], dims, offset)
    return _count(prob_occupied(prob[sa], t1) & bitops.occupied(bit_planes[:, sb]))


def count_occ_occ(occ_a, occ_b, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """bit x bit over the maintained uint8 occupancy summaries: plain bit x bit
    collision is exactly both-!noneButEmpty, so the summaries alone answer it
    (2 bytes per voxel pair instead of a 64-byte plane fold)."""
    sa, sb = _slices(occ_a.shape[-1], dims, offset)
    return _count((occ_a[sa] & occ_b[sb]) != 0)


def count_prob_occ(prob, t1, occ_b, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """prob x bit through the bit side's occupancy summary (same contract as
    count_prob_bit)."""
    sa, sb = _slices(prob.shape[-1], dims, offset)
    return _count(prob_occupied(prob[sa], t1) & (occ_b[sb] != 0))


def count_and_mark_bit(a_planes, b_planes, dims=None, offset=(0, 0, 0)):
    """Debug-kernel semantics for bit maps: mark eBVM_COLLISION (bit 2)."""
    sa, sb = _slices(a_planes.shape[-1], dims, offset)
    hit = bitops.occupied(a_planes[:, sa]) & bitops.occupied(b_planes[:, sb])
    new_a = a_planes.clone()
    new_a[0, sa] = torch.where(hit, a_planes[0, sa] | (1 << 2), a_planes[0, sa])
    return _count(hit), new_a


def any_collision(hit_count: torch.Tensor) -> torch.Tensor:
    return hit_count > 0


def _shift3d(mask: torch.Tensor, offset) -> torch.Tensor:
    """Geometric offset: out[z, y, x] = mask[z+oz, y+oy, x+ox], False outside."""
    ox, oy, oz = (int(v) for v in offset)
    out = mask
    for axis, o in ((0, oz), (1, oy), (2, ox)):
        if o == 0:
            continue
        n = out.shape[axis]
        keep = out.narrow(axis, min(o, n), n - min(o, n)) if o > 0 else out.narrow(axis, 0, max(n + o, 0))
        fill_shape = list(out.shape)
        fill_shape[axis] = n - keep.shape[axis]
        fill = out.new_zeros(fill_shape)
        out = torch.cat([keep, fill] if o > 0 else [fill, keep], dim=axis)
    return out


def or_pool(mask3d: torch.Tensor, level: int) -> torch.Tensor:
    """OR-pool a [Z, Y, X] bool mask over 2^level cubes (pad with False)."""
    s = 1 << int(level)
    if s == 1:
        return mask3d
    pad = [p for d in reversed(mask3d.shape) for p in (0, -d % s)]  # last axis first
    m = torch.nn.functional.pad(mask3d, pad)
    zz, yy, xx = m.shape
    return m.reshape(zz // s, s, yy // s, s, xx // s, s).any(dim=5).any(dim=3).any(dim=1)


def count_with_resolution(mask_a, mask_b, resolution_level: int, dims, offset=(0, 0, 0)) -> torch.Tensor:
    """collideWithResolution for dense maps (CollisionInterfaces.h:37-127).

    The documented contract ("resolution_level = 0 delivers the highest
    accuracy whereas each increase halves the resolution",
    CollisionInterfaces.h:56): occupancy is OR-pooled over 2^level cubes and
    collisions are counted between coarse cells. The offset stays in
    fine-voxel units and is applied geometrically to the left map before
    pooling (left[i+off] vs right[i]); unlike the fine-level base-pointer
    shift (TemplateVoxelMap.hpp:486-519) it does not bleed across axis
    boundaries.
    """
    x, y, z = dims
    a = _shift3d(mask_a.reshape(z, y, x), offset)
    b = mask_b.reshape(z, y, x)
    lvl = int(resolution_level)
    return _count(or_pool(a, lvl) & or_pool(b, lvl))


def _mark_hits(planes: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """A copy of `planes` with eBVM_COLLISION (bit 2 of plane 0) set at hits."""
    out = planes.clone()
    out[0] = torch.where(hit, planes[0] | (1 << 2), planes[0])
    return out


def collide_with_types_bit_bit(a_planes, b_planes, margin: int = 0, sv_offset: int = 0, mark_collisions: bool = True,
                               b_valid=None):
    """kernelCollideVoxelMapsBitvector with SVCollider (BitVoxelMap.hpp:85-135).

    Per voxel: the windowed swept-volume check bitMarginCollisionCheck(a, b,
    margin, sv_offset); colliding voxels get eBVM_COLLISION set in the left
    map; the per-voxel colliding-bit records are OR-reduced into one bit
    vector. Returns (count, meanings int32[8], new_left); without marking
    new_left is `a_planes` itself. Where `b_valid` (bool[N]) is False, b's
    column counts as all-zero: it never hits.

    Deviation from CUDA, kept from the reference: the reference reuses one
    uninitialised per-thread temp vector across its grid-stride loop, so a
    voxel's record can leak stale bytes of an earlier voxel; here every
    voxel starts from a fresh zero record.
    """
    if sv_offset == 0 and margin <= 24:
        hit, records = bitops.bit_margin_collision_check_packed(a_planes, b_planes, margin)
    else:
        # full-domain packed path: stays in int32 planes (never unpacks to
        # bool[..., 256]), so dense swept-volume collides work at 512^3
        hit, records = bitops.bit_margin_collision_check_packed_full(
            a_planes, b_planes, torch.zeros_like(a_planes), margin, sv_offset
        )
    if b_valid is not None:
        hit = hit & b_valid
    records = torch.where(hit[None, :], records, 0)
    meanings = bitops.or_reduce_words(records)
    new_a = _mark_hits(a_planes, hit) if mark_collisions else a_planes
    return _count(hit), meanings, new_a


def collide_with_types_bit_prob(bit_planes, prob, t, mark_collisions: bool = True):
    """SVCollider bit x prob (SVCollider.hpp:98-118): a collision where the
    prob voxel passes the threshold and the bit voxel is !noneButEmpty; the
    bit voxel's whole vector is OR'd into the colliding-meanings record."""
    hit = prob_occupied(prob, t) & bitops.occupied(bit_planes)
    meanings = bitops.or_reduce_words(torch.where(hit[None, :], bit_planes, 0))
    new = _mark_hits(bit_planes, hit) if mark_collisions else bit_planes
    return _count(hit), meanings, new
