"""Denavit-Hartenberg kinematic chains (reference: robot/dh_robot/*).

Counterpart of gpu_voxels_tpu/robot/dh.py. KinematicChain::setConfiguration
(KinematicChain.cu:93-126) transforms link i's cloud by the product
DH_0 * ... * DH_{i-1} (identity for the first link: the cloud transform
happens BEFORE the link's own matrix is multiplied in). The per-link
matrices are built on the clouds' device and all link clouds move in ONE
batched transform (MetaPointCloud.transformed_per_cloud).

`link_matrices` also takes a [T, n_links] tensor of joint values and returns
[T, num_clouds, 4, 4]: the batch dimension written out that the reference
gets from `jax.vmap` (swept_volume.py:75), so a whole trajectory's FK is a
handful of batched products on the card, not T Python iterations.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from ..geometry import transforms
from ..geometry.pointcloud import MetaPointCloud
from ..utils import to_device
from .robot import JointValueMap, RobotInterface


class DHJointType(enum.IntEnum):
    REVOLUTE = transforms.REVOLUTE
    PRISMATIC = transforms.PRISMATIC


@dataclass
class DHParameters:
    """d, theta, a, alpha (+ joint value) (KinematicLink.h)."""

    d: float
    theta: float
    a: float
    alpha: float
    value: float = 0.0
    joint_type: DHJointType = DHJointType.REVOLUTE

    def matrix(self, value=None, device=None) -> torch.Tensor:
        v = self.value if value is None else value
        return transforms.dh_matrix(self.d, self.theta, self.a, self.alpha, v, int(self.joint_type), device=device)


class KinematicChain(RobotInterface):
    """DH robot: ordered links, each with an optional geometry cloud."""

    def __init__(
        self,
        link_names: Sequence[str],
        dh_params: Sequence[DHParameters],
        link_clouds: MetaPointCloud,
        lower_limits: Optional[JointValueMap] = None,
        upper_limits: Optional[JointValueMap] = None,
    ):
        if len(link_names) != len(dh_params):
            raise ValueError("DH parameter count must match link count")
        self.link_names = list(link_names)
        self.dh = {n: p for n, p in zip(link_names, dh_params)}
        self.clouds = link_clouds  # cloud names: a subset of the link names
        self.joint_values: JointValueMap = {n: p.value for n, p in self.dh.items()}
        self._lower = lower_limits or {}
        self._upper = upper_limits or {}
        self._transformed = link_clouds

    # -- FK -------------------------------------------------------------------
    def _values(self, values) -> torch.Tensor:
        """Joint values ordered by link_names as a [..., n_links] f32 tensor
        on the clouds' device."""
        if values is None or isinstance(values, dict):
            given = values or {}
            values = [float(given.get(n, self.joint_values[n])) for n in self.link_names]
        return to_device(values, torch.float32, self.clouds.device)

    def link_matrices(self, values=None) -> torch.Tensor:
        """[..., num_clouds, 4, 4]: the accumulated DH product per link cloud.

        values: joint values ordered by link_names ([n_links] or a
        [T, n_links] batch), or a dict by name; default: the stored
        configuration.
        """
        vals = self._values(values)
        acc = transforms.identity(vals.device).expand(vals.shape[:-1] + (4, 4))
        by_name = {}
        for i, name in enumerate(self.link_names):
            by_name[name] = acc  # the transform BEFORE this link's own DH matrix
            acc = transforms.matmul(acc, self.dh[name].matrix(vals[..., i]))
        return torch.stack([by_name[n] for n in self.clouds.names], dim=-3)

    def set_configuration(self, joint_values: JointValueMap) -> None:
        for k, v in joint_values.items():
            if k in self.joint_values:
                self.joint_values[k] = v
        self._transformed = self.clouds.transformed_per_cloud(self.link_matrices())

    def get_configuration(self) -> JointValueMap:
        return dict(self.joint_values)

    def get_joint_names(self) -> List[str]:
        return list(self.link_names)

    def get_transformed_clouds(self) -> MetaPointCloud:
        return self._transformed

    def transformed_clouds_for(self, values) -> MetaPointCloud:
        """Pure FK: joint values ([n_links] or [T, n_links]) -> transformed
        clouds ([total, 3] or [T, total, 3] points)."""
        return self.clouds.transformed_per_cloud(self.link_matrices(values))

    def get_lower_joint_limits(self) -> JointValueMap:
        return dict(self._lower)

    def get_upper_joint_limits(self) -> JointValueMap:
        return dict(self._upper)

    def update_point_cloud(self, link_name: str, cloud) -> None:
        idx = self.clouds.cloud_index(link_name)
        self.clouds = self.clouds.updated_cloud(idx, cloud)
        self._transformed = self.clouds.transformed_per_cloud(self.link_matrices())
