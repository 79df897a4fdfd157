"""CUDA kernels K1, K2 (prob x prob counting and marking collides; K2 also
over one run of a slab-sharded map, `count_and_mark_prob_run`), K4
(the one-launch swept-volume types collide, gated by the maps' occupancy
summaries) and K7 (the bit x bit plane-fold count).

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

import ctypes

import torch

from ..utils import kernels
from . import collide

count_prob_prob_plain = collide.count_prob_prob
count_and_mark_prob_plain = collide.count_and_mark_prob
count_and_mark_prob_run_plain = collide.count_and_mark_prob_run
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
    return count_and_mark_prob_run(a, b, t1, t2, *_slices(a.shape[0], dims, offset))


def count_and_mark_prob_run(a, b, t1, t2, a0: int, b0: int, length: int):
    """K2 over one run: a[a0 + i] against b[b0 + i] for i < length, the
    marks in a new copy of all of `a` (the offset's run of count_and_mark_prob,
    or a slab of a sharded map against the run of a slab of b an offset
    pairs it with). One launch, counted under `count_and_mark_prob`.
    Returns (count, new_a)."""
    if _on_cpu(a, b):
        return count_and_mark_prob_run_plain(a, b, t1, t2, a0, b0, length)
    _check(a, b)
    n = a.shape[0]
    a0, b0, length = int(a0), int(b0), int(length)
    if min(a0, b0, length) < 0 or a0 + length > n or b0 + length > n:
        raise ValueError(f"the run [{a0}, +{length}) x [{b0}, +{length}) leaves maps of {n} voxels")
    count = torch.empty((), dtype=torch.int64, device=a.device)
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = kernels.library().gv_count_and_mark_prob(
            a.data_ptr(), b.data_ptr() + b0, out.data_ptr(), n, a0, length, int(t1), int(t2), count.data_ptr(),
            stream,
        )
    kernels.check(err, "count_and_mark_prob")
    launches["count_and_mark_prob"] += 1
    return count, out


def collide_types_bit_bit_plain(a, b, margin: int = 0, mark: bool = True, occ_a=None, occ_b=None, *, b_valid=None):
    """K4's spec: ops/collide.collide_with_types_bit_bit at sv_offset 0, over
    every voxel. It takes the wrapper's signature, so it can stand in for it
    under the map methods (chip_smoke.plain_route), and ignores the
    summaries: gating never changes an output."""
    return collide.collide_with_types_bit_bit(a, b, margin, 0, mark, b_valid=b_valid)


def k4_live_mask(a, occ_a, occ_b, margin: int) -> torch.Tensor:
    """bool[N]: the voxels K4 reads planes for when gated by both summaries
    (csrc/collide_types.cu; the reference's rule, collide_pallas.py:336-347):
    b occupied, and a occupied or, from margin 4 on, holding eBVM_FREE (the
    summary leaves bit 0 out, and a window that wide reaches it). Every hit
    voxel is live."""
    live_a = occ_a != 0
    if int(margin) >= 4:
        live_a = live_a | ((a[0] & 1) != 0)
    return (occ_b != 0) & live_a


def _check_bits(a: torch.Tensor, b: torch.Tensor) -> None:
    if not (a.is_cuda and b.is_cuda and a.device == b.device):
        raise ValueError(f"the bit collide kernels need both maps on one CUDA device, got {a.device}, {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"bit planes are int32 views of uint32 words, got {a.dtype}, {b.dtype}")
    if a.ndim != 2 or a.shape[0] != 8 or a.shape != b.shape:
        raise ValueError(f"bit maps must be [8, N] and of one size, got {tuple(a.shape)}, {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bit maps must be contiguous")


def _gate(g: torch.Tensor, a: torch.Tensor, name: str) -> int:
    """The gate's address, after checking it is one byte per voxel of `a`."""
    if g.device != a.device or g.dtype not in (torch.uint8, torch.bool) or g.shape != a.shape[1:] \
            or not g.is_contiguous():
        raise ValueError(f"{name} must be contiguous uint8 or bool [{a.shape[1]}] on {a.device}, "
                         f"got {g.dtype} {tuple(g.shape)} on {g.device}")
    return g.data_ptr()


_workspaces: dict = {}  # (device index, stream) -> K4's workspace, its address and its words


def _workspace(device: torch.device, stream: int) -> tuple:
    """K4's per-stream workspace: the blocks' partial counts and meanings and
    the ticket of the last block, zeroed once; every launch leaves it so."""
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        words = ctypes.c_int64()
        kernels.library().gv_collide_types_workspace_words(ctypes.addressof(words))
        t = torch.zeros(words.value, dtype=torch.int32, device=device)
        ws = _workspaces[key] = (t, t.data_ptr(), words.value)
    return ws


def collide_types_bit_bit(a, b, margin: int = 0, mark: bool = True, occ_a=None, occ_b=None, *, b_valid=None):
    """Windowed swept-volume collide at sv_offset 0, 0 <= margin <= 24 (K4):
    (count, meanings int32[8], new_a). With `mark`, new_a is a new map with
    eBVM_COLLISION set at hits; without, it is `a` itself.

    Given both maps' occupancy summaries (uint8[N], as the reference's
    signature, collide_pallas.py:285-293) the kernel reads planes only for
    the voxels of `k4_live_mask`; with either missing it reads every voxel.
    `b_valid` (bool[N]) makes b's columns all-zero where it is False: the
    voxel lists pass their match mask so. One launch per call. A gated mark
    copies `a` and the kernel marks the hits in the copy; an ungated one has
    the kernel write the whole new map: each is the faster on its side on
    the card (PERF.md section 6)."""
    if _on_cpu(a, b):
        return collide_types_bit_bit_plain(a, b, margin, mark, b_valid=b_valid)
    _check_bits(a, b)
    if not 0 <= int(margin) <= 24:
        raise ValueError(f"the types collide kernel covers margins 0..24, got {margin}")
    summaries = occ_a is not None and occ_b is not None
    pa = _gate(occ_a, a, "occ_a") if summaries else None
    pb = _gate(occ_b, a, "occ_b") if summaries else None
    pv = None if b_valid is None else _gate(b_valid, a, "b_valid")
    count = torch.empty((), dtype=torch.int64, device=a.device)
    meanings = torch.empty(8, dtype=torch.int32, device=a.device)
    out = (a.clone() if summaries or pv is not None else torch.empty_like(a)) if mark else a
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _, ws, words = _workspace(a.device, stream)
    with torch.cuda.device(a.device):
        err = kernels.library().gv_collide_types_bit_bit(
            a.data_ptr(), b.data_ptr(), out.data_ptr() if mark else None, a.shape[1], int(margin), pa, pb, pv,
            ws, words, count.data_ptr(), meanings.data_ptr(), stream,
        )
    kernels.check(err, "collide_types_bit_bit")
    launches["collide_types_bit_bit"] += 1
    return count, meanings, out


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
