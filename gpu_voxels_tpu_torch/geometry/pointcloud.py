"""Device-resident point clouds (helpers/PointCloud.{h,cu},
helpers/MetaPointCloud.{h,cu}).

Counterpart of gpu_voxels_tpu/geometry/pointcloud.py. `MetaPointCloud`
keeps the reference's design of ONE accumulated device allocation for all
sub-clouds (MetaPointCloud.h:221-240): a single float32[total, 3] tensor
plus a per-point int64 sub-cloud id. The offsets and names stay on the
host. Per-link transforms gather one 4x4 per point by sub-cloud id and do
one batched product, in full float32, instead of one launch per link
(MetaPointCloud.cu:624). A leading batch of matrices ([T, C, 4, 4], a whole
trajectory) gives a [T, total, 3] batch of points.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import to_device
from . import transforms

F32 = torch.float32


@dataclass(frozen=True, eq=False)
class PointCloud:
    """A single point cloud on the device (helpers/PointCloud.h:41-158)."""

    points: torch.Tensor  # float32[N, 3]

    @staticmethod
    def from_numpy(points, device=None) -> "PointCloud":
        return PointCloud(to_device(np.asarray(points, np.float32).reshape(-1, 3), F32, device))

    @property
    def size(self) -> int:
        return self.points.shape[0]

    def transformed(self, matrix) -> "PointCloud":
        """PointCloud::transform (PointCloud.cu): rigid transform."""
        return PointCloud(transforms.transform_points(matrix, self.points))

    def scaled(self, factors) -> "PointCloud":
        return PointCloud(self.points * to_device(factors, F32, self.points.device))

    def add(self, other: "PointCloud") -> "PointCloud":
        return PointCloud(torch.cat([self.points, other.points], dim=0))


@dataclass(frozen=True, eq=False)
class MetaPointCloud:
    """Named sub-clouds in one device allocation."""

    points: torch.Tensor  # float32[total, 3] (or [T, total, 3] once transformed per step)
    cloud_ids: torch.Tensor  # int64[total] sub-cloud index per point
    offsets: Tuple[int, ...]  # len = num_clouds + 1
    names: Tuple[str, ...]

    @staticmethod
    def from_clouds(clouds, names=None, device=None) -> "MetaPointCloud":
        arrs = [np.asarray(c, dtype=np.float32).reshape(-1, 3) for c in clouds]
        if names is None:
            names = tuple(f"cloud_{i}" for i in range(len(arrs)))
        sizes = [a.shape[0] for a in arrs]
        offsets = tuple(np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist())
        pts = np.concatenate(arrs, axis=0) if arrs else np.zeros((0, 3), np.float32)
        ids = np.repeat(np.arange(len(arrs), dtype=np.int64), sizes)
        pts_t = to_device(pts, F32, device)
        return MetaPointCloud(pts_t, to_device(ids, torch.int64, pts_t.device), offsets, tuple(names))

    @property
    def device(self) -> torch.device:
        return self.points.device

    @property
    def num_clouds(self) -> int:
        return len(self.offsets) - 1

    @property
    def accumulated_size(self) -> int:
        return self.offsets[-1]

    def to(self, device) -> "MetaPointCloud":
        return replace(self, points=to_device(self.points, F32, device),
                       cloud_ids=to_device(self.cloud_ids, torch.int64, device))

    def cloud_size(self, i: int) -> int:
        return self.offsets[i + 1] - self.offsets[i]

    def cloud_index(self, name: str) -> int:
        return self.names.index(name)

    def get_cloud(self, i: int) -> torch.Tensor:
        return self.points[..., self.offsets[i]:self.offsets[i + 1], :]

    def transformed(self, matrix) -> "MetaPointCloud":
        """Whole-cloud rigid transform (MetaPointCloud::transform)."""
        return replace(self, points=transforms.transform_points(matrix, self.points))

    def transformed_sub_cloud(self, cloud_id: int, matrix) -> "MetaPointCloud":
        """transformSubCloud (MetaPointCloud.cu:624): one sub-cloud only."""
        lo, hi = self.offsets[cloud_id], self.offsets[cloud_id + 1]
        pts = self.points.clone()
        pts[lo:hi] = transforms.transform_points(matrix, self.points[lo:hi])
        return replace(self, points=pts)

    def transformed_per_cloud(self, matrices) -> "MetaPointCloud":
        """Transform every sub-cloud by its own 4x4 in one batched product:
        matrices float32[..., num_clouds, 4, 4] (the per-link loop of
        KinematicChain.cu:93-126 in one op)."""
        matrices = to_device(matrices, F32, self.device)
        per_point = matrices[..., self.cloud_ids, :, :]  # [..., total, 4, 4]
        rot, t = per_point[..., :3, :3], per_point[..., :3, 3]
        return replace(self, points=transforms.matmul(rot, self.points[..., None])[..., 0] + t)

    def updated_cloud(self, cloud_id: int, points) -> "MetaPointCloud":
        """updatePointCloud: a sub-cloud of the same size is overwritten in
        place of the copy; a size change rebuilds the accumulated cloud."""
        pts = to_device(points, F32, self.device).reshape(-1, 3)
        lo, hi = self.offsets[cloud_id], self.offsets[cloud_id + 1]
        if pts.shape[0] == hi - lo:
            new = self.points.clone()
            new[lo:hi] = pts
            return replace(self, points=new)
        clouds = [self.get_cloud(i).cpu().numpy() for i in range(self.num_clouds)]
        clouds[cloud_id] = pts.cpu().numpy()
        return MetaPointCloud.from_clouds(clouds, self.names, device=self.device)

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return {n: self.get_cloud(i) for i, n in enumerate(self.names)}
