"""Device-side stream compaction for visualization readback.

Counterpart of gpu_voxels_tpu/ops/compact.py. The reference's cube
extraction is a device kernel: the Extract load-balancer task
ballot-compacts occupied nodes into a device buffer, and only the compacted
buffer reaches the viewer (octree/load_balancer/Extract.h:50,
TemplateVoxelList.hpp:704). Here, as in the JAX package, it is plain tensor
work on the mask's device: an int32 prefix sum, then a scatter of the set
positions into a fixed-capacity index buffer. A readback then moves
O(occupied) bytes instead of the O(N) mask.

The temporaries stay int32 (the prefix sum, the destinations and the
positions: a dense map holds < 2^31 voxels), so a 512^3 mask costs 4 bytes
a voxel, not the 16 of int64 ones. The scatter has `capacity + 1` slots:
every unset or overflowing position writes the last one, which is dropped
(H2). The reference's power-of-two prefix of the fetch exists only for
XLA's compile cache (H9) and is not kept.
"""
from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32


def compact_indices(mask_flat: torch.Tensor, capacity: int):
    """(count, idx): `count` the total set count (an int32 0-d tensor; it may
    exceed `capacity`) and `idx` int32[capacity] the linear indices of the
    first `capacity` set cells of `mask_flat`, ascending (np.flatnonzero's
    order); the entries past the count are 0. No host read."""
    mask = mask_flat.reshape(-1).to(torch.bool)
    n = mask.shape[0]
    if n >= 2**31:
        raise ValueError(f"compaction indices are int32: {n} cells")
    incl = torch.cumsum(mask, 0, dtype=I32)
    count = incl[-1] if n else torch.zeros((), dtype=I32, device=mask.device)
    pos = incl - 1
    tgt = torch.where(mask & (pos < capacity), pos, capacity)
    idx = torch.zeros((capacity + 1,), dtype=I32, device=mask.device)
    idx.index_put_((tgt,), torch.arange(n, dtype=I32, device=mask.device))
    return count, idx[:capacity]


def compacted_nonzero(mask_flat: torch.Tensor, capacity: int | None = None) -> np.ndarray:
    """np.flatnonzero of a device mask with an O(K) readback: int64[K]
    ascending. Two host reads: the count, then the index prefix. With
    capacity=None the buffer spans the whole mask (equal to
    np.flatnonzero(mask)); a capacity bounds both the device buffer and the
    fetch (the viewer's max_cubes)."""
    n = int(mask_flat.numel())
    cap = n if capacity is None else min(int(capacity), n)
    count, idx = compact_indices(mask_flat, cap)
    k = min(int(count), cap)
    return idx[:k].cpu().numpy().astype(np.int64)
