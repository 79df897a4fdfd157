"""CUDA kernel K5: the min-plus lower envelope of the exact EDT.

Counterpart of gpu_voxels_tpu/ops/edt_envelope.py (`envelope_pass`); the
kernel is csrc/edt_envelope.cu. The wrapper

* on CPU tensors returns the plain torch version (`envelope_pass_plain`,
  the spec in ops/edt_envelope.py);
* on CUDA tensors launches the kernel on the current stream, without
  synchronising, and adds one to `launches[name]`; an input the kernel does
  not take raises. There is no fallback.

The pass along axis 1 (Y) of a [dz, dy, dx] grid is the kernel's
[A, n, C] = [dz, dy, dx] layout; along axis 2 (X) it is [dz * dy, dx, 1].
Both read the grid in place.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import kernels
from . import edt_envelope

envelope_pass_plain = edt_envelope.envelope_plain

# kernel launches since the last reset, by wrapper name
launches = {"envelope_pass": 0}


def envelope_pass(g2: torch.Tensor, payload: torch.Tensor, axis: int = 1):
    """(d2, payload) int32 [dz, dy, dx]: the lower envelope along `axis`
    (1 or 2), equal to `envelope_pass_plain` on distances and payloads (K5
    on CUDA)."""
    if g2.device.type == "cpu" and payload.device.type == "cpu":
        return envelope_pass_plain(g2, payload, axis)
    if not (g2.is_cuda and payload.is_cuda and g2.device == payload.device):
        raise ValueError(f"the envelope kernel needs both grids on one CUDA device, got {g2.device}, {payload.device}")
    if g2.dtype != torch.int32 or payload.dtype != torch.int32:
        raise TypeError(f"the envelope takes int32 grids, got {g2.dtype}, {payload.dtype}")
    if g2.ndim != 3 or g2.shape != payload.shape:
        raise ValueError(f"the envelope takes two [dz, dy, dx] grids of one shape, got {tuple(g2.shape)}, "
                         f"{tuple(payload.shape)}")
    if not (g2.is_contiguous() and payload.is_contiguous()):
        raise ValueError("the envelope's grids must be contiguous")
    dz, dy, dx = g2.shape
    if axis == 1:
        a, n, c = dz, dy, dx
    elif axis == 2:
        a, n, c = dz * dy, dx, 1
    else:
        raise ValueError(f"the envelope scans axis 1 or 2, got {axis}")
    if n > 1024:
        raise ValueError(f"packed sites have 10-bit coordinates: lines of at most 1024, got {n}")
    out_d = torch.empty_like(g2)
    out_p = torch.empty_like(payload)
    stream = torch.cuda.current_stream(g2.device).cuda_stream
    with torch.cuda.device(g2.device):
        err = kernels.library().gv_envelope_pass(
            g2.data_ptr(), payload.data_ptr(), out_d.data_ptr(), out_p.data_ptr(), a, n, c, stream
        )
    kernels.check(err, "envelope_pass")
    launches["envelope_pass"] += 1
    return out_d, out_p


def envelope_occupancy(n: int, c: int) -> dict:
    """What the current CUDA device holds of the kernel that a pass over lines
    of `n` positions with inner extent `c` launches (c == 1: the X pass):
    resident warps per SM, registers per thread, static shared bytes per
    block, local bytes per thread, threads per block."""
    out = (ctypes.c_int * 5)()
    kernels.check(kernels.library().gv_envelope_occupancy(n, c, ctypes.addressof(out)), "envelope_occupancy")
    return dict(zip(("warps_per_sm", "registers", "shared_bytes", "local_bytes", "threads"), out))
