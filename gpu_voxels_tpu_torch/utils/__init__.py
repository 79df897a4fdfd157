"""Shared helpers of the port."""
from __future__ import annotations

import torch

# ROADMAP Queue 1 items that bring what this slice leaves out
ROBOTS = "ROADMAP Queue 1 item 6: robots and swept volumes"
SENSING = "ROADMAP Queue 1 item 6b: K6, DDA sensor insert, counting maps, point clouds"
HIERARCHY = "ROADMAP Queue 1 item 10: hierarchical tier"
FACADE = "ROADMAP Queue 1 item 12: IO, visualization and the facade"


def not_ported(name: str, item: str):
    """A stand-in that raises NotImplementedError naming the ROADMAP item."""

    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet ({item})")

    fn.__name__ = name
    return fn


def to_device(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """`x` (numpy array, sequence, scalar or tensor) as a `dtype` tensor on
    `device` (default: a tensor's own device, torch's default device for
    host data).

    Host data bound for a CUDA device goes through pinned memory with a
    non-blocking copy, so an upload (a depth frame, a point cloud, a pose)
    is queued on the current stream instead of making the host wait for
    the device.
    """
    if isinstance(x, torch.Tensor):
        t = x.to(dtype)
    else:
        t = torch.as_tensor(x, dtype=dtype, device="cpu")
    device = torch.device(device) if device is not None else (
        t.device if isinstance(x, torch.Tensor) else torch.get_default_device()
    )
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
