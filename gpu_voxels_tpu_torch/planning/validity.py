"""Motion-planning validity checking backed by voxel collision counts.

Counterpart of gpu_voxels_tpu/planning/validity.py, the equivalent of
gvl_ompl_planning/gvl_ompl_planner_helper.cpp:42-330: an OMPL-style
StateValidityChecker and MotionValidator where a state is valid iff the
robot at that configuration collides with the environment map in at most
`max_colliding_voxels` voxels.

States are checked in batches: the robot's `transformed_clouds_for` takes
a [T, n_joints] batch (the port's KinematicChain is batched, which replaces
the reference's vmap), the points are voxelized and gathered against the
dense environment, and the distinct colliding voxels of each state are
counted by a sort along its points. The counts stay on the device until
`colliding_voxels`, `is_valid` or `batch_colliding_voxels` reads them; each
such read is one host read, counted in `host_reads`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..constants import float_to_probability
from ..ops.insert import clamp_coords, in_map, linear_index, map_to_voxels
from ..utils import perfmon, to_device

def _count_distinct_hits(lin: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Distinct colliding voxels along the last axis (duplicates collapse,
    like the reference's voxel-level count): sort the hit voxels' linear
    indices and count first occurrences. Cost scales with the robot's point
    count, never the grid."""
    key, _ = torch.sort(torch.where(hit, lin, -1), dim=-1)
    first = torch.ones_like(key, dtype=torch.bool)
    first[..., 1:] = key[..., 1:] != key[..., :-1]
    return (first & (key >= 0)).sum(dim=-1, dtype=torch.int64)


class GvlValidityChecker:
    """State validity: robot FK -> voxelize -> gather env occupancy -> count.

    The robot's points are gathered directly against the environment grid
    instead of inserted into a scratch map and collided grid against grid
    (the reference application's loop): the same count, far less traffic.
    Rebind `env` after the environment map changes."""

    def __init__(self, env_map, robot, coll_threshold: float = 0.7, max_colliding_voxels: int = 0):
        self.env = env_map
        self.robot = robot
        self.t = float_to_probability(coll_threshold)
        self.max_colliding = int(max_colliding_voxels)
        self.host_reads = 0

    @property
    def device(self) -> torch.device:
        return self.env.data.device

    def colliding_voxels_device(self, cfgs) -> torch.Tensor:
        """Colliding voxels of one configuration ([n_joints] -> 0-d) or of a
        batch ([T, n_joints] -> [T]), as int64 on the environment's device."""
        with perfmon.span("validity.count"):
            env = self.env
            cfg = to_device(cfgs, torch.float32, env.data.device)
            points = self.robot.transformed_clouds_for(cfg).points
            with perfmon.span("validity.gather"):
                coords = map_to_voxels(points, env.side_length)
                inside = in_map(coords, env.dims)
                idx = torch.where(inside, linear_index(coords, env.dims), 0)
                occ = (env.data[idx].to(torch.int32) >= self.t) & inside
            with perfmon.span("validity.distinct"):
                return _count_distinct_hits(idx, occ)

    def colliding_voxels(self, cfg) -> int:
        self.host_reads += 1
        count = self.colliding_voxels_device(cfg)
        with perfmon.span("validity.read"):
            return int(count)

    def is_valid(self, cfg) -> bool:
        """isValid (gvl_ompl_planner_helper.cpp pose_check)."""
        return self.colliding_voxels(cfg) <= self.max_colliding

    def batch_colliding_voxels(self, cfgs) -> np.ndarray:
        self.host_reads += 1
        counts = self.colliding_voxels_device(cfgs)
        with perfmon.span("validity.read"):
            return counts.cpu().numpy()


class HierarchicalValidityChecker(GvlValidityChecker):
    """Validity against a hierarchical map (BASELINE config #5: an octree-tier
    map against the robot's voxels inside motion checks). Each robot voxel
    probes the status pyramid top down, so mostly-uniform space costs one
    coarse gather.

    Takes a dense HierarchicalBitMap / HierarchicalProbMap, a PagedSnapshot
    or a PagedHierarchicalMap (probed through its snapshot; after the paged
    map changes, `refresh()` takes a new one). Distinct colliding voxels are
    counted on int64 linear keys, exact at every world size; the
    reference's uint32 key wraps past 2^32 voxels (F15)."""

    def __init__(self, env_map, robot, max_colliding_voxels: int = 0, min_level: int = 0):
        self._env_source = env_map if hasattr(env_map, "snapshot") else None
        self.env = env_map.snapshot() if self._env_source is not None else env_map
        self.robot = robot
        self.max_colliding = int(max_colliding_voxels)
        self.min_level = int(min_level)
        self.host_reads = 0

    @property
    def device(self) -> torch.device:
        return self.env.device

    def colliding_voxels_device(self, cfgs) -> torch.Tensor:
        with perfmon.span("validity.count"):
            env = self.env
            cfg = to_device(cfgs, torch.float32, env.device)
            points = self.robot.transformed_clouds_for(cfg).points
            with perfmon.span("validity.gather"):
                coords = map_to_voxels(points, env.side_length)
                inside = in_map(coords, env.dims)
                coords = clamp_coords(coords, env.dims)
                occ, _, _ = env.probe_clamped(coords, self.min_level)
            with perfmon.span("validity.distinct"):
                return _count_distinct_hits(linear_index(coords, env.dims), occ & inside)

    def refresh(self) -> None:
        """Take a new snapshot of a paged environment after it changed; a
        no-op for a dense one, which the caller rebinds through `env`."""
        if self._env_source is not None:
            self.env = self._env_source.snapshot()


class MotionValidator:
    """checkMotion (motion_check prefix): interpolate, then validate the
    segment's states as one batch."""

    def __init__(self, checker: GvlValidityChecker, resolution: float = 0.02):
        self.checker = checker
        self.resolution = float(resolution)

    def segment_states(self, s1, s2) -> np.ndarray:
        s1 = np.asarray(s1, np.float32)
        s2 = np.asarray(s2, np.float32)
        dist = float(np.max(np.abs(s2 - s1)))
        n = max(int(np.ceil(dist / self.resolution)), 1)
        ratios = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
        return s1[None, :] * (1 - ratios[:, None]) + s2[None, :] * ratios[:, None]

    def check_motion(self, s1, s2) -> Tuple[bool, int]:
        """Returns (valid, number of checked states): one batch, one host
        read. (The reference pads the batch to a power of two to reuse
        compiled programs; nothing here compiles per length.)"""
        with perfmon.span("validity.check_motion"):
            with perfmon.span("validity.states"):
                states = self.segment_states(s1, s2)
            counts = self.checker.batch_colliding_voxels(states)
            return bool((counts <= self.checker.max_colliding).all()), len(states)
