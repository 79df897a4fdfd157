"""CUDA kernels K1, K2 (prob x prob counting and marking collides), K4
(the one-pass swept-volume types collide) and K7 (the bit x bit plane-fold
count).

Counterpart of gpu_voxels_tpu/ops/collide_pallas.py (`count_prob_prob`,
`count_and_mark_prob`, `collide_types_bit_bit`, `count_bit_bit`); the
kernels are csrc/collide_prob.cu, csrc/collide_types.cu and
csrc/collide_bits.cu. K1, K2 and K7 take the reference's full-map signature
with its offset semantics (ops/collide._offset_slices). Each wrapper

* on CPU tensors returns the plain torch version (`*_plain`, the spec in
  ops/collide.py);
* on CUDA tensors launches the kernel on the current stream, without
  synchronising, and adds one to `launches[name]`; an input the kernel does
  not take raises. There is no fallback.

The count is a 0-d int64 device tensor.
"""
from __future__ import annotations

import torch

from ..utils import kernels
from . import collide

count_prob_prob_plain = collide.count_prob_prob
count_and_mark_prob_plain = collide.count_and_mark_prob
count_bit_bit_plain = collide.count_bit_bit

# kernel launches since the last reset, by wrapper name
launches = {"count_prob_prob": 0, "count_and_mark_prob": 0, "collide_types_bit_bit": 0, "count_bit_bit": 0}


def _on_cpu(*ts: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in ts)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"prob collide kernels need both maps on one CUDA device, got {a.device}, {b.device}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"prob maps are int8, got {a.dtype}, {b.dtype}")
    if a.ndim != 1 or a.shape != b.shape:
        raise ValueError(f"prob maps must be flat and of one size, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("prob maps must be contiguous")


def _slices(n: int, dims, offset):
    sa, sb = collide._slices(n, dims, offset)
    return min(sa.start, n), min(sb.start, n), max(0, sa.stop - sa.start)


def count_prob_prob(a, b, t1, t2, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """#voxels with a[i+off] >= t1 and b[i] >= t2 (K1)."""
    if _on_cpu(a, b):
        return count_prob_prob_plain(a, b, t1, t2, dims, offset)
    _check(a, b)
    a0, b0, length = _slices(a.shape[0], dims, offset)
    count = torch.empty((), dtype=torch.int64, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = kernels.library().gv_count_prob_prob(
            a.data_ptr() + a0, b.data_ptr() + b0, length, int(t1), int(t2), count.data_ptr(), stream
        )
    kernels.check(err, "count_prob_prob")
    launches["count_prob_prob"] += 1
    return count


def count_and_mark_prob(a, b, t1, t2, dims=None, offset=(0, 0, 0)):
    """K1's count plus a new left map with 127 at every hit (K2).
    Returns (count, new_a); `a` is left unchanged."""
    if _on_cpu(a, b):
        return count_and_mark_prob_plain(a, b, t1, t2, dims, offset)
    _check(a, b)
    a0, b0, length = _slices(a.shape[0], dims, offset)
    count = torch.empty((), dtype=torch.int64, device=a.device)
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = kernels.library().gv_count_and_mark_prob(
            a.data_ptr(), b.data_ptr() + b0, out.data_ptr(), a.shape[0], a0, length,
            int(t1), int(t2), count.data_ptr(), stream,
        )
    kernels.check(err, "count_and_mark_prob")
    launches["count_and_mark_prob"] += 1
    return count, out


def collide_types_bit_bit_plain(a, b, margin: int = 0, mark: bool = True):
    """K4's spec: ops/collide.collide_with_types_bit_bit at sv_offset 0."""
    return collide.collide_with_types_bit_bit(a, b, margin, 0, mark)


def _check_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"the bit collide kernels need both maps on one CUDA device, got {a.device}, {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"bit planes are int32 views of uint32 words, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or a.shape[0] != 8 or a.shape != b.shape:
        raise ValueError(f"bit maps must be [8, N] and of one size, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bit maps must be contiguous")


def collide_types_bit_bit(a, b, margin: int = 0, mark: bool = True):
    """Windowed swept-volume collide at sv_offset 0, 0 <= margin <= 24 (K4):
    (count, meanings int32[8], new_a). With `mark`, new_a is a new map with
    eBVM_COLLISION set at hits; without, it is `a` itself."""
    if _on_cpu(a, b):
        return collide_types_bit_bit_plain(a, b, margin, mark)
    _check_bits(a, b)
    if not 0 <= int(margin) <= 24:
        raise ValueError(f"the types collide kernel covers margins 0..24, got {margin}")
    count = torch.empty((), dtype=torch.int64, device=a.device)
    meanings = torch.empty(8, dtype=torch.int32, device=a.device)
    out = torch.empty_like(a) if mark else None
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = kernels.library().gv_collide_types_bit_bit(
            a.data_ptr(), b.data_ptr(), out.data_ptr() if mark else None, a.shape[1], int(margin),
            count.data_ptr(), meanings.data_ptr(), stream,
        )
    kernels.check(err, "collide_types_bit_bit")
    launches["collide_types_bit_bit"] += 1
    return count, meanings, out if mark else a


def count_bit_bit(a_planes, b_planes, dims=None, offset=(0, 0, 0)) -> torch.Tensor:
    """#voxels where a[:, i+off] and b[:, i] are both !noneButEmpty (K7): the
    fold of each map's 8 planes, bit 0 of plane 0 masked, non-zero on both
    sides. For callers that hold raw planes, and for maps without an
    occupancy summary."""
    if _on_cpu(a_planes, b_planes):
        return count_bit_bit_plain(a_planes, b_planes, dims, offset)
    _check_bits(a_planes, b_planes)
    n = a_planes.shape[1]
    a0, b0, length = _slices(n, dims, offset)
    count = torch.empty((), dtype=torch.int64, device=a_planes.device)
    stream = torch.cuda.current_stream(a_planes.device).cuda_stream
    with torch.cuda.device(a_planes.device):
        err = kernels.library().gv_count_bit_bit(
            a_planes.data_ptr(), b_planes.data_ptr(), n, a0, b0, length, count.data_ptr(), stream
        )
    kernels.check(err, "count_bit_bit")
    launches["count_bit_bit"] += 1
    return count
