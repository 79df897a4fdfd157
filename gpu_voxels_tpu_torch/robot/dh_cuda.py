"""A DH chain's forward kinematics as one CUDA launch (csrc/dh_fk.cu).

Replaces no TPU kernel: the JAX package's FK is jnp that XLA fuses. In
PyTorch the same arithmetic is ~25 elementwise launches a link and a batched
transform; `dh_fk_points` and `dh_chain` issue it as one launch. Each
wrapper

* launches its kernel on the current stream of the table's card, without
  synchronising and without reading anything back, and adds one to
  `launches[name]` (an empty batch launches nothing);
* takes the joint values as a CUDA tensor [T, L], or one state as a host
  numpy array [L], which travels in the launch's arguments (no upload: a
  monitor's reading, a stored configuration);
* raises on an input the kernel does not take: another dtype or shape, a
  tensor that is not contiguous, a chain of more than MAX_LINKS links, a
  tensor off the card or on another card. There is no fallback: a CPU chain
  calls the plain versions itself (KinematicChain routes by the device of
  its clouds, where its joint values go).

The plain versions, `dh_chain_plain` and `dh_fk_points_plain`, are the spec
in torch: transforms.dh_matrix per link, the batched 4x4 products, then the
per-point gather and product of MetaPointCloud.transformed_per_cloud. They
read the DH table and the link indices to the host (free on the CPU; on the
card they are the kernels' yardstick, never a path).

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

# kernel launches since the last reset, by wrapper name
launches = {"dh_fk_points": 0, "dh_chain": 0}


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} {list(shape)} tensor, "
                         f"got {t.dtype} {list(t.shape)}")


def _checked(name: str, values, params, joint_types, cloud_link, *more) -> tuple[int, int, int]:
    """(T, L, C); raises on what the kernels do not take. `more` pairs a
    tensor with its name, dtype and shape."""
    on_host = isinstance(values, np.ndarray)
    if on_host and (values.dtype != np.float32 or values.ndim != 1 or not values.flags.c_contiguous):
        raise ValueError(f"host values must be one contiguous float32 [L] state, got {values.dtype} "
                         f"{list(values.shape)}")
    if not on_host and values.ndim != 2:
        raise ValueError(f"values must be [T, L], got {list(values.shape)}")
    t, n = (1, values.shape[0]) if on_host else values.shape
    if not 1 <= n <= MAX_LINKS:
        raise ValueError(f"the {name} kernel takes 1 to {MAX_LINKS} links, got {n}")
    if cloud_link.ndim != 1 or cloud_link.shape[0] < 1:
        raise ValueError(f"cloud_link must be [C] with C >= 1, got {list(cloud_link.shape)}")
    checks = [(params, "params", F32, (n, 4)), (joint_types, "joint_types", I32, (n,)),
              (cloud_link, "cloud_link", I32, tuple(cloud_link.shape)), *more]
    if not on_host:
        checks.insert(0, (values, "values", F32, (t, n)))
    for args in checks:
        _check(*args)
    device = checks[0][0].device
    if device.type != "cuda":
        raise ValueError(f"the {name} kernel needs its table and values on a CUDA device, got {device}")
    for x, what, *_ in checks:
        if x.device != device:
            raise ValueError(f"{what} must be on {device}, got {x.device}")
    return t, n, cloud_link.shape[0]


def _pointers(values) -> tuple:
    """(device values, host values): one of them NULL."""
    return (None, values.ctypes.data) if isinstance(values, np.ndarray) else (values.data_ptr(), None)


def dh_fk_points(values, params, joint_types, cloud_link, point_cloud, points) -> torch.Tensor:
    """f32[T, P, 3]: every point of the clouds moved by its link's product
    for each of the T states of values f32[T, L] (or one host state f32[L],
    T = 1; points f32[P, 3]); one launch of gv_dh_fk_points."""
    if point_cloud.ndim != 1:
        raise ValueError(f"point_cloud must be [P], got {list(point_cloud.shape)}")
    n_points = point_cloud.shape[0]
    t, n, c = _checked("FK", values, params, joint_types, cloud_link,
                       (point_cloud, "point_cloud", I32, (n_points,)), (points, "points", F32, (n_points, 3)))
    out = torch.empty((t, n_points, 3), dtype=F32, device=params.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(params.device).cuda_stream
    with torch.cuda.device(params.device):
        err = kernels.library().gv_dh_fk_points(
            *_pointers(values), params.data_ptr(), joint_types.data_ptr(), cloud_link.data_ptr(),
            point_cloud.data_ptr(), points.data_ptr(), out.data_ptr(), t, n, c, n_points, stream,
        )
    kernels.check(err, "dh_fk_points")
    launches["dh_fk_points"] += 1
    return out


def dh_chain(values, params, joint_types, cloud_link) -> torch.Tensor:
    """f32[T, C, 4, 4]: each cloud's product for each of the T states of
    values f32[T, L] (or one host state f32[L], T = 1); one launch of
    gv_dh_chain."""
    t, n, c = _checked("chain", values, params, joint_types, cloud_link)
    out = torch.empty((t, c, 4, 4), dtype=F32, device=params.device)
    if t == 0:
        return out
    stream = torch.cuda.current_stream(params.device).cuda_stream
    with torch.cuda.device(params.device):
        err = kernels.library().gv_dh_chain(
            *_pointers(values), params.data_ptr(), joint_types.data_ptr(), cloud_link.data_ptr(), out.data_ptr(),
            t, n, c, stream,
        )
    kernels.check(err, "dh_chain")
    launches["dh_chain"] += 1
    return out


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
