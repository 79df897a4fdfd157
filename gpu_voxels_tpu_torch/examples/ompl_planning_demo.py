"""Port of gvl_ompl_planning: state + motion validity checking.

The OMPL StateValidityChecker/MotionValidator contract from
gvl_ompl_planner_helper.cpp:42-330, without OMPL itself: a state is valid iff
inserting the robot collides with the environment in <= threshold voxels;
motions interpolate at the collision resolution and validate every
intermediate state in one batch ([T, n_joints] through the batched FK).
"""
from dataclasses import replace

import numpy as np
import torch

from gpu_voxels_tpu_torch.geometry import generation
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.planning import GvlValidityChecker, MotionValidator
from gpu_voxels_tpu_torch.robot.dh import DHParameters, KinematicChain
from gpu_voxels_tpu_torch.utils import to_device

BASE = np.array([4.0, 4.0, 4.0], np.float32)


class PlanarArm:
    """2-joint planar arm based at BASE. A link's cloud transforms by the
    *preceding* links' DH product (the reference convention), so the forearm
    cloud hangs off a third link to see both joints."""

    def __init__(self, device=None):
        params = [
            DHParameters(0, 0, 0.0, 0),  # base rotation (joint 1)
            DHParameters(0, 0, 1.0, 0),  # elbow (joint 2) at reach 1.0
            DHParameters(0, 0, 0.0, 0),  # fixed tool frame
        ]
        clouds = MetaPointCloud.from_clouds(
            [
                np.linspace([0.1, 0, 0], [0.9, 0, 0], 9).astype(np.float32),  # upper
                np.linspace([0.1, 0, 0], [0.9, 0, 0], 9).astype(np.float32),  # fore
            ],
            names=("upper", "fore"),
            device=device,
        )
        self.chain = KinematicChain(["base", "upper", "fore"], params, clouds)
        self.base = to_device(BASE, torch.float32, clouds.device)

    def transformed_clouds_for(self, cfg):
        """FK of one configuration ([2]) or a batch ([T, 2])."""
        cfg = to_device(cfg, torch.float32, self.base.device)
        full = torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1)
        c = self.chain.transformed_clouds_for(full)
        return replace(c, points=c.points + self.base)


def main(device=None):
    arm = PlanarArm(device)
    # obstacle straight ahead (+x) of the base at the arm's reach
    env = ProbVoxelMap.create((64, 64, 64), 0.125, device=device).insert_point_cloud(
        generation.create_box_of_points((1.4, -0.3, -0.15), (2.0, 0.3, 0.15), 0.05)
        + BASE
    )
    checker = GvlValidityChecker(env, arm, 0.7)
    validator = MotionValidator(checker, resolution=0.05)

    blocked = checker.colliding_voxels([0.0, 0.0])  # arm pointing +x: hits
    clear = checker.colliding_voxels([np.pi / 2, 0.0])  # pointing +y: free
    print(f"pose_check: straight +x -> {blocked} colliding voxels (invalid)")
    print(f"pose_check: straight +y -> {clear} colliding voxels (valid)")
    assert blocked > 0 and clear == 0

    direct, n1 = validator.check_motion([-0.8, 0.0], [0.8, 0.0])
    print(f"motion_check: sweep through obstacle -> valid={direct} ({n1} states)")
    assert not direct

    # folding the elbow pulls the arm inside the obstacle radius: valid detour
    folded, n2 = validator.check_motion([-0.8, 2.8], [0.8, 2.8])
    print(f"motion_check: folded-elbow sweep     -> valid={folded} ({n2} states)")
    assert folded
    return True


if __name__ == "__main__":
    main()
