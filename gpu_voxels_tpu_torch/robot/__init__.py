"""Robots and swept volumes: DH kinematic chains, the UR presets and the
swept-volume inserts. URDF robots, `.traj` files and the schedule fitter
are not ported yet (ROADMAP Queue 1 items 12 and 6c)."""
from .dh import DHJointType, DHParameters, KinematicChain
from .robot import JointValueMap, RobotInterface, interpolate_linear

__all__ = [
    "DHJointType",
    "DHParameters",
    "JointValueMap",
    "KinematicChain",
    "RobotInterface",
    "interpolate_linear",
]
