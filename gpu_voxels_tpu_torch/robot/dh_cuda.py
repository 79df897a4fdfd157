"""A DH chain's forward kinematics as one CUDA launch (csrc/dh_fk.cu).

Replaces no TPU kernel: the JAX package's FK is jnp that XLA fuses. In
PyTorch the same arithmetic is ~25 elementwise launches a link and a batched
transform; `dh_fk_points` and `dh_chain` issue it as one launch. Each
wrapper takes the joint values as f32[..., L] and

* on a CPU table returns its plain version, called with the values as given;
* on the card takes the values flattened to [T, L], or one state as a host
  numpy array [L], which travels in the launch's arguments (no upload: a
  monitor's reading, a stored configuration); launches its kernel on the
  current stream of the table's card with `kernels.launch`, without
  synchronising and without reading anything back (an empty batch launches
  nothing); and returns the plain version's shape;
* raises on an input the kernel does not take: another dtype or shape, a
  table that is not contiguous, a chain of more than MAX_LINKS links, a
  tensor off the table's card. There is no fallback.

The plain versions, `dh_chain_plain` and `dh_fk_points_plain`, are the spec
in torch: transforms.dh_matrix per link, the batched 4x4 products, then the
per-point gather and product of MetaPointCloud.transformed_per_cloud. They
read the DH table and the link indices to the host (free on the CPU; on the
card they are the kernels' yardstick, never a path). On the CPU they run
with the batch shape as given: a batched 4x4 product need not round alike
under another batch layout.

The chain's table, as KinematicChain packs it once on the clouds' device:

    params       f32[L, 4]   (d, theta, a, alpha), each rounded to f32 as
                             dh_matrix rounds it
    joint_types  int32[L]    transforms.REVOLUTE or transforms.PRISMATIC
    cloud_link   int32[C]    the link (index in link order) whose product,
                             taken before its own matrix, moves cloud c
    point_cloud  int32[P]    the cloud of each point

The kernels trust cloud_link to index inside L and point_cloud inside C:
the chain builds them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import transforms
from ..utils import kernels

F32, I32 = torch.float32, torch.int32
MAX_LINKS = 64  # csrc/dh_fk.cu kMaxLinks: the products of one state live in shared memory


def _checked(values, params, joint_types, cloud_link) -> tuple:
    """(values as the kernels take them: [T, L] on the table's card, or one
    host state [L]; T; L; C); raises on what the kernels do not take."""
    device = params.device
    n = values.shape[-1] if values.ndim else 0
    if not 1 <= n <= MAX_LINKS:
        raise ValueError(f"the DH kernels take 1 to {MAX_LINKS} links, got values {list(values.shape)}")
    if isinstance(values, np.ndarray):
        if values.dtype != np.float32 or values.ndim != 1 or not values.flags.c_contiguous:
            raise ValueError(f"host values must be one contiguous float32 [L] state, got {values.dtype} "
                             f"{list(values.shape)}")
        flat = values
    else:
        flat = values.reshape(-1, n).contiguous()
        kernels.check_input(flat, "values", F32, ("T", n), device)
    kernels.check_input(params, "params", F32, (n, 4), device)
    kernels.check_input(joint_types, "joint_types", I32, (n,), device)
    kernels.check_input(cloud_link, "cloud_link", I32, ("C",), device)
    if cloud_link.shape[0] < 1:
        raise ValueError(f"cloud_link must be [C] with C >= 1, got {list(cloud_link.shape)}")
    return flat, 1 if flat.ndim == 1 else flat.shape[0], n, cloud_link.shape[0]


def _checked_points(point_cloud: torch.Tensor, points: torch.Tensor, device: torch.device) -> int:
    """P; raises unless point_cloud is int32 [P] and points f32 [P, 3] on `device`."""
    kernels.check_input(point_cloud, "point_cloud", I32, ("P",), device)
    kernels.check_input(points, "points", F32, (point_cloud.shape[0], 3), device)
    return point_cloud.shape[0]


def _pointers(values) -> tuple:
    """(device values, host values): one of them NULL."""
    return (None, values.ctypes.data) if isinstance(values, np.ndarray) else (values.data_ptr(), None)


def dh_fk_points(values, params, joint_types, cloud_link, point_cloud, points) -> torch.Tensor:
    """f32[..., P, 3]: every point of the clouds (points f32[P, 3]) moved by
    its link's product for each state of values f32[..., L] (on the card
    also one host state f32[L]); on the card one launch of gv_dh_fk_points."""
    device = params.device
    if device.type == "cpu":
        return dh_fk_points_plain(values, params, joint_types, cloud_link, point_cloud, points)
    flat, t, n, c = _checked(values, params, joint_types, cloud_link)
    n_points = _checked_points(point_cloud, points, device)
    out = torch.empty((t, n_points, 3), dtype=F32, device=device)
    if out.numel():
        kernels.launch("gv_dh_fk_points", device, *_pointers(flat), params.data_ptr(), joint_types.data_ptr(),
                       cloud_link.data_ptr(), point_cloud.data_ptr(), points.data_ptr(), out.data_ptr(), t, n, c,
                       n_points)
    return out.reshape(values.shape[:-1] + (n_points, 3))


def dh_chain(values, params, joint_types, cloud_link) -> torch.Tensor:
    """f32[..., C, 4, 4]: each cloud's product for each state of values
    f32[..., L] (on the card also one host state f32[L]); on the card one
    launch of gv_dh_chain."""
    device = params.device
    if device.type == "cpu":
        return dh_chain_plain(values, params, joint_types, cloud_link)
    flat, t, n, c = _checked(values, params, joint_types, cloud_link)
    out = torch.empty((t, c, 4, 4), dtype=F32, device=device)
    if t:
        kernels.launch("gv_dh_chain", device, *_pointers(flat), params.data_ptr(), joint_types.data_ptr(),
                       cloud_link.data_ptr(), out.data_ptr(), t, n, c)
    return out.reshape(values.shape[:-1] + (c, 4, 4))


def dh_chain_plain(values, params, joint_types, cloud_link) -> torch.Tensor:
    """f32[..., C, 4, 4] for values f32[..., L], in torch (the spec of
    gv_dh_chain): the accumulated DH product per cloud, taken BEFORE its
    link's own matrix (identity for the first link)."""
    acc = transforms.identity(values.device).expand(values.shape[:-1] + (4, 4))
    before = []
    for i, ((d, theta, a, alpha), joint_type) in enumerate(zip(params.tolist(), joint_types.tolist())):
        before.append(acc)
        acc = transforms.matmul(acc, transforms.dh_matrix(d, theta, a, alpha, values[..., i], joint_type))
    return torch.stack([before[i] for i in cloud_link.tolist()], dim=-3)


def dh_fk_points_plain(values, params, joint_types, cloud_link, point_cloud, points) -> torch.Tensor:
    """f32[..., P, 3] for values f32[..., L], in torch (the spec of
    gv_dh_fk_points): dh_chain_plain, then one batched product per point."""
    per_point = dh_chain_plain(values, params, joint_types, cloud_link)[..., point_cloud.long(), :, :]
    return transforms.matmul(per_point[..., :3, :3], points[..., None])[..., 0] + per_point[..., :3, 3]
