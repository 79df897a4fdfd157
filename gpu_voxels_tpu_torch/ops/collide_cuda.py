"""CUDA kernels K1 and K2: prob x prob counting and marking collides.

Counterpart of gpu_voxels_tpu/ops/collide_pallas.py (`count_prob_prob`,
`count_and_mark_prob`); the kernels are csrc/collide_prob.cu. Each wrapper
takes the reference's full-map signature with its offset semantics
(ops/collide._offset_slices) and

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

# kernel launches since the last reset, by wrapper name
launches = {"count_prob_prob": 0, "count_and_mark_prob": 0}


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
