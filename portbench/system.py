"""The system under test: the port's public objects, built from the
benchmark's inputs through their public constructors. The harness reaches
the program only through the classes here and their control twins in
`control.py`, which put the reference, one precision down, in the
program's place."""
from __future__ import annotations

import types

import numpy as np
import torch

from gpu_voxels_tpu_torch.constants import BitVoxelMeaning
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.planning import GvlValidityChecker, JointSpace, MotionValidator, RRTConnect
from gpu_voxels_tpu_torch.robot.dh import DHParameters, KinematicChain
from gpu_voxels_tpu_torch.sensors import Sensor
from gpu_voxels_tpu_torch.utils import to_device

from . import inputs

OCCUPIED = int(BitVoxelMeaning.eBVM_OCCUPIED)


def ur10(robot: dict, device) -> KinematicChain:
    """The UR10 as a KinematicChain: the published DH table, the
    benchmark's link clouds, a fixed tool0 frame last."""
    params = [DHParameters(d=d, theta=0.0, a=a, alpha=al)
              for d, a, al in zip(robot["dh_d_m"], robot["dh_a_m"], robot["dh_alpha_rad"])]
    params.append(DHParameters(d=0.0, theta=0.0, a=0.0, alpha=0.0))
    names = inputs.link_names(robot)
    return KinematicChain(names, params, MetaPointCloud.from_clouds(inputs.link_clouds(robot), names, device=device))


class PlacedArm:
    """The six-joint arm at its base: joint values [..., 6] (tool0 at 0) to
    world points, for the validity checker."""

    def __init__(self, chain: KinematicChain, base, device):
        self.chain = chain
        self.base = to_device(np.asarray(base, np.float32), torch.float32, device)

    def transformed_clouds_for(self, cfg):
        full = torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1)
        return types.SimpleNamespace(points=self.chain.transformed_clouds_for(full).points + self.base)


class Monitor:
    """RobotVsEnvironment's live loop: depth insert into a ProbVoxelMap, FK,
    the robot into a new BitVectorVoxelMap, collideWith, the count on the host."""

    def __init__(self, cfg: dict, device):
        s = cfg["sensor"]
        self.sensor = Sensor(position=np.asarray(s["position_m"], np.float32),
                             orientation_rpy=np.asarray(s["rpy"], np.float32),
                             data_width=s["width"], data_height=s["height"], fx=s["fx"], fy=s["fy"],
                             cx=s["cx"], cy=s["cy"], invalid_value=s["invalid_value"])
        self.dims, self.side = tuple(cfg["map"]["dims"]), cfg["map"]["side_m"]
        self.device = torch.device(device)
        self.chain = ur10(cfg["robot"], device)
        self.base = to_device(np.asarray(cfg["robot"]["base_m"], np.float32), torch.float32, device)
        self.threshold, self.pool = cfg["collide_threshold"], cfg["carve_pool"]
        self.env = ProbVoxelMap.create(self.dims, self.side, device=device)
        self.robot = None

    def sense(self, frame: np.ndarray) -> None:
        self.env = self.env.insert_depth_image(frame, self.sensor, carve_pool=self.pool)

    def place(self, joints: np.ndarray) -> torch.Tensor:
        return self.chain.transformed_clouds_for(joints).points + self.base

    def collide(self, points: torch.Tensor) -> int:
        self.robot = BitVectorVoxelMap.create(self.dims, self.side, device=self.device).insert_point_cloud(points)
        return int(self.robot.collide_with(self.env, self.threshold))

    def outputs(self) -> dict:
        """What the judge reads: the environment's log-odds, the last robot
        map's voxels, and its voxels whose bits are other than OCCUPIED alone."""
        env = self.env.data.clone()
        occ = self.robot.get_bit_mask(OCCUPIED)
        stray = int((self.robot.occupied_mask() != occ).sum())
        return {"env": env, "robot_voxels": torch.nonzero(occ).reshape(-1), "robot_stray": stray}


class Workcell:
    """The planner's scene: the workcell's ProbVoxelMap, the placed UR10,
    the port's GvlValidityChecker (or the control's `checker`), the port's
    MotionValidator and RRTConnect."""

    def __init__(self, cfg: dict, device, checker=None):
        if checker is None:
            dims, side = tuple(cfg["map"]["dims"]), cfg["map"]["side_m"]
            env = ProbVoxelMap.create(dims, side, device=device).insert_point_cloud(inputs.box_points(cfg))
            arm = PlacedArm(ur10(cfg["robot"], device), cfg["robot"]["base_m"], device)
            checker = GvlValidityChecker(env, arm, cfg["validity_threshold"], cfg["max_colliding_voxels"])
        self.checker = checker
        self.resolution = cfg["motion_resolution_rad"]
        self.space = JointSpace(np.asarray(cfg["joint_lower_rad"], np.float32),
                                np.asarray(cfg["joint_upper_rad"], np.float32))

    def validator(self, checker) -> MotionValidator:
        return MotionValidator(checker, resolution=self.resolution)

    def planner(self, validator, step: float, seed: int) -> RRTConnect:
        return RRTConnect(self.space, validator, step=step, seed=seed)

    def outputs(self) -> dict:
        return {"env": self.checker.env.data.clone()}
