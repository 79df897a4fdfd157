"""Robots and swept volumes: DH kinematic chains, the UR presets, the
swept-volume inserts, `.traj` trajectory files, the schedule fitter
(`robot.fitter`) and URDF robots (`robot.urdf`)."""
from .dh import DHJointType, DHParameters, KinematicChain
from .fitter import deconflict_slot, fit_orderings, fit_schedule
from .robot import JointValueMap, RobotInterface, interpolate_linear
from .trajectory import Trajectory, load_trajectories
from .urdf import UrdfRobot

__all__ = [
    "DHJointType",
    "DHParameters",
    "JointValueMap",
    "KinematicChain",
    "RobotInterface",
    "Trajectory",
    "UrdfRobot",
    "deconflict_slot",
    "fit_orderings",
    "fit_schedule",
    "interpolate_linear",
    "load_trajectories",
]
