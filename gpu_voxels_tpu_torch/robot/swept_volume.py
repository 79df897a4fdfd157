"""Swept-volume insertion along trajectories.

Counterpart of gpu_voxels_tpu/robot/swept_volume.py. Reference:
examples/SweptVolumeVsEnvironment.cpp: each trajectory step inserts the
robot's transformed clouds with meaning eBVM_SWEPT_VOLUME_START +
(step % n_sv_ids), encoding time in the 256-bit axis.

`insert_swept_volume_batched` runs FK for all steps as one batch on the
card (KinematicChain.link_matrices takes [T, n_links]) and all T*P points
in one scatter (ops/insert.scatter_bits_multi).
"""
from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import numpy as np
import torch

from ..constants import SV_END, SV_START
from ..maps.voxelmap import BitVectorVoxelMap
from ..ops.insert import scatter_bits_multi, voxelize
from ..utils import to_device

NUM_SV_IDS = SV_END - SV_START  # 250


def sv_meaning_for_step(step: int, num_ids: int = NUM_SV_IDS - 1) -> int:
    """eBVM_SWEPT_VOLUME_START + (step % n) (SweptVolumeVsEnvironment.cpp)."""
    return SV_START + (int(step) % num_ids)


def insert_swept_volume(
    bitmap: BitVectorVoxelMap,
    robot,
    trajectory: Sequence,
    num_ids: int = NUM_SV_IDS - 1,
) -> BitVectorVoxelMap:
    """Insert the robot's clouds for every configuration, one step at a
    time, with per-step SV bits.

    `robot` provides transformed_clouds_for(values) (KinematicChain) or
    set_configuration/get_transformed_clouds (any RobotInterface);
    `trajectory` is a sequence of joint-value vectors or maps.
    """
    m = bitmap
    for step, cfg in enumerate(trajectory):
        if hasattr(robot, "transformed_clouds_for") and not isinstance(cfg, dict):
            clouds = robot.transformed_clouds_for(to_device(cfg, torch.float32, m.device))
        else:
            robot.set_configuration(cfg)
            clouds = robot.get_transformed_clouds()
        m = m.insert_point_cloud(clouds.points, sv_meaning_for_step(step, num_ids))
    return m


def insert_swept_volume_batched(
    bitmap: BitVectorVoxelMap,
    robot,
    trajectory,
    num_ids: int = NUM_SV_IDS - 1,
) -> BitVectorVoxelMap:
    """The whole trajectory in one scatter; equals insert_swept_volume.

    Requires robot.transformed_clouds_for (pure FK, taking a [T, n_joints]
    batch) and an array trajectory [T, n_joints].
    """
    traj = to_device(trajectory, torch.float32, bitmap.device)
    pts = robot.transformed_clouds_for(traj).points  # [T, P, 3]
    t, p = pts.shape[0], pts.shape[1]
    # per-step meanings are a host function of (T, num_ids): the scatter
    # knows the touched planes (3 of 8 for 64 steps) without the device
    meanings_np = np.repeat(SV_START + (np.arange(t, dtype=np.int64) % int(num_ids)), p)
    idx, _ = voxelize(pts.reshape(-1, 3), bitmap.side_length, bitmap.dims)
    data, occ = scatter_bits_multi(bitmap.data, bitmap.occ, idx, meanings_np)
    return replace(bitmap, data=data, occ=occ)
