"""CUDA kernels of the exact EDT: K5, the min-plus lower envelope; the
grids before it, the obstacle merge and PBA phase 1's Z flood; and the
clearance query on its result.

Counterpart of gpu_voxels_tpu/ops/edt_envelope.py (`envelope_pass`); the
kernels are csrc/edt_envelope.cu (K5), csrc/edt_phase1.cu (the merge and
the Z flood) and csrc/distance_query.cu (the query); the last three replace
no TPU kernel: the reference's are jnp that XLA fuses. Each wrapper

* on CPU tensors returns the plain torch version (`envelope_pass_plain`,
  `flood_z_plain`, `merge_occupied_plain`, `min_distance_to_plain`: the
  specs in ops/edt_envelope.py and ops/edt.py);
* on CUDA tensors launches the kernel on the current stream with
  `kernels.launch`, without synchronising; an input the kernel does not
  take raises. There is no fallback.

The pass along axis 1 (Y) of a [dz, dy, dx] grid is the kernel's
[A, n, C] = [dz, dy, dx] layout; along axis 2 (X) it is [dz * dy, dx, 1].
Both read the grid in place.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import kernels
from . import edt, edt_envelope

envelope_pass_plain = edt_envelope.envelope_plain
flood_z_plain = edt_envelope.flood_z_plain
merge_occupied_plain = edt.merge_occupied
min_distance_to_plain = edt.min_distance_to


def envelope_pass(g2: torch.Tensor, payload: torch.Tensor, axis: int = 1):
    """(d2, payload) int32 [dz, dy, dx]: the lower envelope along `axis`
    (1 or 2), equal to `envelope_pass_plain` on distances and payloads (K5
    on CUDA)."""
    if g2.device.type == "cpu" and payload.device.type == "cpu":
        return envelope_pass_plain(g2, payload, axis)
    device = g2.device
    kernels.check_input(g2, "g2", torch.int32, ("dz", "dy", "dx"), device, dtype_error=TypeError)
    kernels.check_input(payload, "payload", torch.int32, g2.shape, device, dtype_error=TypeError)
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
    kernels.launch("gv_envelope_pass", device, g2.data_ptr(), payload.data_ptr(), out_d.data_ptr(), out_p.data_ptr(),
                   a, n, c)
    return out_d, out_p


def flood_z(packed_flat: torch.Tensor, dims):
    """(g1, payload) int32 [dz, dy, dx]: PBA phase 1 of the packed int32[N]
    grid of `dims` (x, y, z), equal to `flood_z_plain` (the Z flood kernel on
    CUDA, one launch; every extent at most 1024 there). Another dtype raises
    TypeError, another shape ValueError, on either device."""
    dx, dy, dz = (int(d) for d in dims)
    device = packed_flat.device
    kernels.check_input(packed_flat, "packed_flat", torch.int32, (dx * dy * dz,), device, dtype_error=TypeError)
    if device.type == "cpu":
        return flood_z_plain(packed_flat, dims)
    if max(dx, dy, dz) > 1024:
        raise ValueError(f"packed sites have 10-bit coordinates: extents of at most 1024, got {(dx, dy, dz)}")
    g1 = torch.empty((dz, dy, dx), dtype=torch.int32, device=device)
    pay1 = torch.empty_like(g1)
    kernels.launch("gv_flood_z", device, packed_flat.data_ptr(), g1.data_ptr(), pay1.data_ptr(), dx, dy, dz)
    return g1, pay1


def merge_occupied(packed_flat: torch.Tensor, prob: torch.Tensor, threshold: int, dims, z_offset: int = 0):
    """int32[N]: the packed grid with every voxel whose int8 log-odds `prob`
    is >= `threshold` made an obstacle holding its own coordinates (global
    rows from `z_offset`), equal to `merge_occupied_plain` (the merge kernel
    on CUDA, one launch). Another dtype raises TypeError, another shape or
    device ValueError, on either device."""
    dx, dy, dz = (int(d) for d in dims)
    n = dx * dy * dz
    device = packed_flat.device
    kernels.check_input(packed_flat, "packed_flat", torch.int32, (n,), device, dtype_error=TypeError)
    kernels.check_input(prob, "prob", torch.int8, (n,), device, dtype_error=TypeError)
    if device.type == "cpu":
        return merge_occupied_plain(packed_flat, prob, threshold, dims, z_offset)
    if n >= 2**31:
        raise ValueError(f"the merge indexes voxels in int32: fewer than 2^31, got {n}")
    out = torch.empty_like(packed_flat)
    # an int8 compares as int: every threshold below -128 takes all, above 127 none
    t = min(max(int(threshold), -128), 128)
    kernels.launch("gv_merge_occupied", device, packed_flat.data_ptr(), prob.data_ptr(), out.data_ptr(), n, dx, dy,
                   int(z_offset), t)
    return out


def min_distance_to(packed_flat: torch.Tensor, points: torch.Tensor, side_length: float, dims):
    """0-d float32: the least metric distance from the float32 [P, 3]
    points (P >= 1) to their nearest obstacles in the packed int32[N] grid,
    equal to `min_distance_to_plain` bit for bit (the query kernel on CUDA,
    one launch). Another dtype raises TypeError, another shape, no point or
    another device ValueError, on either device."""
    dx, dy, dz = (int(d) for d in dims)
    device = packed_flat.device
    kernels.check_input(packed_flat, "packed_flat", torch.int32, (dx * dy * dz,), device, dtype_error=TypeError)
    kernels.check_input(points, "points", torch.float32, ("P", 3), device, dtype_error=TypeError)
    if points.shape[0] == 0:
        raise ValueError("the least distance needs at least one query point")
    if device.type == "cpu":
        return min_distance_to_plain(packed_flat, points, side_length, dims)
    out = torch.empty((), dtype=torch.float32, device=device)
    # voxelize's scale: the float32 reciprocal of the side (ops/insert.map_to_voxels)
    recip = float(np.float32(1.0 / float(side_length)))
    kernels.launch("gv_min_distance_to", device, points.data_ptr(), points.shape[0], recip, float(side_length),
                   packed_flat.data_ptr(), dx, dy, dz, out.data_ptr())
    return out


def envelope_occupancy(n: int, c: int) -> dict:
    """What the current CUDA device holds of the kernel that a pass over lines
    of `n` positions with inner extent `c` launches (c == 1: the X pass):
    resident warps per SM, registers per thread, static shared bytes per
    block, local bytes per thread, threads per block."""
    out = (ctypes.c_int * 5)()
    kernels.check(kernels.library().gv_envelope_occupancy(n, c, ctypes.addressof(out)), "envelope_occupancy")
    return dict(zip(("warps_per_sm", "registers", "shared_bytes", "local_bytes", "threads"), out))
