"""The control: the reference, in the program's place, one precision below
the configuration's float32 with TF32 off, i.e. with every matrix
product's operands in TF32 (the robot's FK, the sensor pose's product and
the carve's rotation).
A comparison that this control passes could not tell a program that
computed in TF32 from a sound one; each cell's checks must refuse it.

    python -m portbench.control --workload <cell> --seeds 11,12,13 --seconds 5

runs the control on the card through the same window and judge as a run,
once per seed in one process, and prints each seed's checks; it exits 0
when every seed's run came out not correct. The benchmark's own runs never
run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types

import numpy as np
import torch

from . import inputs
from .reference import geometry, sensing, workcell


def _keys(points: torch.Tensor, side: float, dims) -> torch.Tensor:
    """int64 voxel keys of float32 points, floor(p * (1 / side)), -1 outside."""
    c = torch.floor(points * float(np.float32(1.0 / side))).to(torch.int64)
    dx, dy, dz = dims
    inside = (c >= 0).all(-1) & (c[..., 0] < dx) & (c[..., 1] < dy) & (c[..., 2] < dz)
    return torch.where(inside, (c[..., 2] * dy + c[..., 1]) * dx + c[..., 0], -1)


class Monitor:
    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.dims, self.side = tuple(cfg["map"]["dims"]), cfg["map"]["side_m"]
        self.clouds = inputs.link_clouds(cfg["robot"])
        self.t = sensing.threshold(cfg["collide_threshold"])
        n = self.dims[0] * self.dims[1] * self.dims[2]
        self.env = torch.full((n,), sensing.UNKNOWN, dtype=torch.int8, device=self.device)
        self.robot = None

    def sense(self, frame: np.ndarray) -> None:
        depth = torch.as_tensor(frame, device=self.device)
        self.env = sensing.fuse_tf32(self.env, depth, self.cfg["sensor"], self.side, self.dims)

    def place(self, joints: np.ndarray) -> torch.Tensor:
        r = self.cfg["robot"]
        return geometry.fk_points_tf32(r, self.clouds, r["base_m"], joints[None], self.device)[0]

    def collide(self, points: torch.Tensor) -> int:
        self.robot = _keys(points, self.side, self.dims)[None]
        return int(geometry.distinct_hits(self.robot, self.env.to(torch.int32) >= self.t)[0])

    def outputs(self) -> dict:
        keys = torch.unique(self.robot[self.robot >= 0])
        return {"env": self.env.clone(), "robot_voxels": keys, "robot_stray": 0}


class Checker:
    """GvlValidityChecker's contract from the reference in TF32."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.clouds = inputs.link_clouds(cfg["robot"])
        self.env = types.SimpleNamespace(data=workcell.env_map(cfg, self.device))
        self.occupied = self.env.data.to(torch.int32) >= sensing.threshold(cfg["validity_threshold"])
        self.max_colliding = cfg["max_colliding_voxels"]
        self.host_reads = 0

    def batch_colliding_voxels(self, states) -> np.ndarray:
        self.host_reads += 1
        r = self.cfg["robot"]
        pts = geometry.fk_points_tf32(r, self.clouds, r["base_m"], np.asarray(states, np.float32), self.device)
        keys = _keys(pts, self.cfg["map"]["side_m"], self.cfg["map"]["dims"])
        return geometry.distinct_hits(keys, self.occupied).cpu().numpy()

    def is_valid(self, cfg) -> bool:
        return int(self.batch_colliding_voxels(np.asarray(cfg, np.float32)[None])[0]) <= self.max_colliding


def Workcell(cfg: dict, device):
    """The port's planner and motion validator over the control's checker."""
    from .system import Workcell as PortWorkcell

    return PortWorkcell(cfg, device, checker=Checker(cfg, device))


def main(argv=None) -> int:
    from . import harness

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=5.0)
    a = p.parse_args(argv)
    t0 = time.perf_counter()
    harness.steady_process()
    refused = 0
    seeds = [int(s) for s in a.seeds.split(",")]
    for seed in seeds:
        result = harness.execute(a.workload, seed, a.seconds, False, harness.card(1), t0, control=True)
        checks = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"control": a.workload, "seed": seed, "correct": result["correct"], "checks": checks}),
              flush=True)
        refused += not result["correct"]
    return 0 if refused == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
