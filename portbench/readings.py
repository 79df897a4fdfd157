"""The readings the band (reference/geometry.py BAND) is set from: how far
the program's float32 geometry lies from the float64 reference, and how
far the control's TF32 lies, in voxels, on the card: the FK of the joint
states each cell drives and, where the cell senses, the pose's product of
its depth frames' points.

    python -m portbench.readings --seeds 1,2,3 --states 4096

Each loop module's `readings(cfg, traffic, seed, count, device)` names
what its cell drives and calls `fk_errors` and `depth_errors` here.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import inputs, system
from .reference import geometry, sensing


def fk_errors(cfg: dict, states: np.ndarray, device) -> dict:
    side, robot = cfg["map"]["side_m"], cfg["robot"]
    clouds = inputs.link_clouds(robot)
    arm = system.PlacedArm(system.ur10(robot, device), robot["base_m"], device)
    worst = {"program": 0.0, "tf32": 0.0}
    moved = 0
    for i in range(0, len(states), 256):
        s = states[i:i + 256]
        ref = geometry.fk_points(robot, clouds, robot["base_m"], s, device)
        got = arm.transformed_clouds_for(torch.as_tensor(s, device=device)).points.double()
        low = geometry.fk_points_tf32(robot, clouds, robot["base_m"], s, device).double()
        worst["program"] = max(worst["program"], float(((got - ref).abs() / side).max()))
        worst["tf32"] = max(worst["tf32"], float(((low - ref).abs() / side).max()))
        moved += int((torch.floor(low / side) != torch.floor(ref / side)).any(-1).sum())
    return {"fk_max_program_err_vox": worst["program"], "fk_max_tf32_err_vox": worst["tf32"],
            "fk_tf32_points_in_other_voxel": moved, "fk_points": int(len(states) * sum(len(c) for c in clouds))}


def depth_errors(cfg: dict, frames: list, device) -> dict:
    """The program's world points of each frame (Sensor.process_depth_image)
    and the control's TF32 product against float64."""
    s, side = cfg["sensor"], cfg["map"]["side_m"]
    port = system.Monitor(cfg, device).sensor
    m = torch.as_tensor(sensing.pose(s), device=device)
    r = geometry.emulated_tf32(m[:3, :3].contiguous())
    worst = {"program": 0.0, "tf32": 0.0}
    moved = points = 0
    for frame in frames:
        depth = torch.as_tensor(frame, device=device)
        pts, valid = sensing.camera_points(depth, s)
        ref = pts[valid].double() @ m[:3, :3].double().T + m[:3, 3].double()
        got = port.process_depth_image(frame, device)[valid].double()
        p = geometry.emulated_tf32(pts[valid])
        low = torch.stack([(p[:, 0] * r[i, 0] + p[:, 1] * r[i, 1]) + p[:, 2] * r[i, 2] for i in range(3)], -1)
        low = (low + m[:3, 3]).double()
        worst["program"] = max(worst["program"], float(((got - ref).abs() / side).max()))
        worst["tf32"] = max(worst["tf32"], float(((low - ref).abs() / side).max()))
        moved += int((torch.floor(low / side) != torch.floor(ref / side)).any(-1).sum())
        points += int(valid.sum())
    return {"depth_max_program_err_vox": worst["program"], "depth_max_tf32_err_vox": worst["tf32"],
            "depth_tf32_points_in_other_voxel": moved, "depth_points": points}


def main(argv=None) -> int:
    from . import harness, loops

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--states", type=int, default=4096)
    a = p.parse_args(argv)
    device = harness.card(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    spec = harness.load_spec()
    for w in spec["workloads"]:
        cfg, traffic = harness.load_config(spec, w["config"]), harness.load_traffic(w["traffic"])
        loop = loops.loop_module(traffic["loop"])
        for seed in (int(s) for s in a.seeds.split(",")):
            row = loop.readings(cfg, traffic, seed, a.states, device)
            print(json.dumps({"cell": w["name"], "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
