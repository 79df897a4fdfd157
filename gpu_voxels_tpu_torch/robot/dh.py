"""Denavit-Hartenberg kinematic chains (reference: robot/dh_robot/*).

Counterpart of gpu_voxels_tpu/robot/dh.py. KinematicChain::setConfiguration
(KinematicChain.cu:93-126) transforms link i's cloud by the product
DH_0 * ... * DH_{i-1} (identity for the first link: the cloud transform
happens BEFORE the link's own matrix is multiplied in).

`link_matrices` also takes a [T, n_links] tensor of joint values and returns
[T, num_clouds, 4, 4]: the batch dimension written out that the reference
gets from `jax.vmap` (swept_volume.py:75).

FK goes through the wrappers of robot/dh_cuda.py, which route by the device
of the chain's table, packed once on the clouds' device where the joint
values go: the points through `dh_fk_points` (transformed_clouds_for,
set_configuration, update_point_cloud), the matrices through `dh_chain`
(link_matrices). On the card each is one launch of csrc/dh_fk.cu (one state
given on the host travels in the launch's arguments); on the CPU the plain
versions run: the spec the tests hold against the reference.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..geometry import transforms
from ..geometry.pointcloud import MetaPointCloud
from ..utils import perfmon, to_device
from . import dh_cuda
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
        dev = link_clouds.device
        params = [[p.d, p.theta, p.a, p.alpha] for p in dh_params]
        # (params, joint_types, cloud_link) of robot/dh_cuda.py; a cloud's link
        # by name, so its cloud takes the product before that link's matrix
        self._table = (
            to_device(np.asarray(params, np.float32).reshape(-1, 4), torch.float32, dev),
            to_device([int(p.joint_type) for p in dh_params], torch.int32, dev),
            to_device([self.link_names.index(n) for n in link_clouds.names], torch.int32, dev),
        )
        self._point_cloud = link_clouds.cloud_ids.to(torch.int32)

    # -- FK -------------------------------------------------------------------
    def _values(self, values):
        """Joint values ordered by link_names as a [..., n_links] f32 tensor
        on the clouds' device; on the card one state given on the host (a
        dict, None, a sequence or an array of n_links) stays there as f32
        numpy [n_links], which the kernels take in their launch's arguments."""
        if values is None or isinstance(values, dict):
            given = values or {}
            values = [float(given.get(n, self.joint_values[n])) for n in self.link_names]
        if self.clouds.device.type == "cuda" and not isinstance(values, torch.Tensor):
            host = np.ascontiguousarray(values, np.float32)
            if host.ndim == 1:
                return host
        return to_device(values, torch.float32, self.clouds.device)

    def link_matrices(self, values=None) -> torch.Tensor:
        """[..., num_clouds, 4, 4]: the accumulated DH product per link cloud.

        values: joint values ordered by link_names ([n_links] or a
        [T, n_links] batch), or a dict by name; default: the stored
        configuration.
        """
        return dh_cuda.dh_chain(self._values(values), *self._table)

    def set_configuration(self, joint_values: JointValueMap) -> None:
        for k, v in joint_values.items():
            if k in self.joint_values:
                self.joint_values[k] = v
        self._transformed = self.transformed_clouds_for(None)

    def get_configuration(self) -> JointValueMap:
        return dict(self.joint_values)

    def get_joint_names(self) -> List[str]:
        return list(self.link_names)

    def get_transformed_clouds(self) -> MetaPointCloud:
        return self._transformed

    def transformed_clouds_for(self, values) -> MetaPointCloud:
        """Pure FK: joint values ([n_links] or [T, n_links], a dict by name,
        or None for the stored configuration) -> transformed clouds ([total,
        3] or [T, total, 3] points). `robot.chain` holds the chain and the
        transform together: on the card one launch."""
        with perfmon.span("robot.fk"):
            with perfmon.span("robot.chain"):
                pts = dh_cuda.dh_fk_points(self._values(values), *self._table, self._point_cloud, self.clouds.points)
                return replace(self.clouds, points=pts)

    def get_lower_joint_limits(self) -> JointValueMap:
        return dict(self._lower)

    def get_upper_joint_limits(self) -> JointValueMap:
        return dict(self._upper)

    def update_point_cloud(self, link_name: str, cloud) -> None:
        idx = self.clouds.cloud_index(link_name)
        self.clouds = self.clouds.updated_cloud(idx, cloud)
        self._point_cloud = self.clouds.cloud_ids.to(torch.int32)  # a resized cloud moves the ids
        self._transformed = self.transformed_clouds_for(None)
