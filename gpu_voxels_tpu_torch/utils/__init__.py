"""Shared helpers of the port."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device of every entry point that is given none: the CUDA card.
    Callers that want the CPU say so (`device="cpu"`); on a machine without
    CUDA, an allocation on this device raises torch's own error."""
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device, `default_device()` when None."""
    return torch.device(device) if device is not None else default_device()


def to_device(x, dtype: torch.dtype, device=None) -> torch.Tensor:
    """`x` (numpy array, sequence, scalar or tensor) as a `dtype` tensor on
    `device` (default: a tensor's own device, `default_device()` for host
    data).

    Host data bound for a CUDA device goes through pinned memory with a
    non-blocking copy, so an upload (a depth frame, a point cloud, a pose)
    is queued on the current stream instead of making the host wait for
    the device.
    """
    if isinstance(x, torch.Tensor):
        t = x.to(dtype)
    else:
        t = torch.as_tensor(x, dtype=dtype, device="cpu")
    if device is None and isinstance(x, torch.Tensor):
        device = t.device
    device = resolve_device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
