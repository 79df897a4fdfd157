"""Robots and swept volumes: DH kinematic chains, the UR presets, the
swept-volume inserts, `.traj` trajectory files and the schedule fitter
(`robot.fitter`). URDF robots are not ported yet (ROADMAP Queue 1 item 12)."""
from .dh import DHJointType, DHParameters, KinematicChain
from .fitter import deconflict_slot, fit_orderings, fit_schedule
from .robot import JointValueMap, RobotInterface, interpolate_linear
from .trajectory import Trajectory, load_trajectories

__all__ = [
    "DHJointType",
    "DHParameters",
    "JointValueMap",
    "KinematicChain",
    "RobotInterface",
    "Trajectory",
    "deconflict_slot",
    "fit_orderings",
    "fit_schedule",
    "interpolate_linear",
    "load_trajectories",
]
