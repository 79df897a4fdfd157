"""Robot interface contract (reference: robot/robot_interface.h:41-95).

Counterpart of gpu_voxels_tpu/robot/robot.py. A robot owns a MetaPointCloud
of link geometry clouds and produces the transformed clouds for a joint
configuration. JointValueMap is a plain dict[str, float].
"""
from __future__ import annotations

from typing import Dict, List

from ..geometry.pointcloud import MetaPointCloud

JointValueMap = Dict[str, float]


def interpolate_linear(a, b, ratio):
    """interpolateLinear (helpers/MathHelpers.cpp:84-115): works on floats,
    sequences and JointValueMaps."""
    if isinstance(a, dict):
        return {k: a[k] * (1.0 - ratio) + b[k] * ratio for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(x * (1.0 - ratio) + y * ratio for x, y in zip(a, b))
    return a * (1.0 - ratio) + b * ratio


class RobotInterface:
    """Abstract contract: setConfiguration / getTransformedClouds / limits."""

    def set_configuration(self, joint_values: JointValueMap) -> None:
        raise NotImplementedError

    def get_configuration(self) -> JointValueMap:
        raise NotImplementedError

    def get_joint_names(self) -> List[str]:
        raise NotImplementedError

    def get_transformed_clouds(self) -> MetaPointCloud:
        raise NotImplementedError

    def get_lower_joint_limits(self) -> JointValueMap:
        raise NotImplementedError

    def get_upper_joint_limits(self) -> JointValueMap:
        raise NotImplementedError

    def update_point_cloud(self, link_name: str, cloud) -> None:
        raise NotImplementedError
