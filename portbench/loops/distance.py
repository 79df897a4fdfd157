"""The distance monitor: the safety monitor's open loop (`loops/monitor.py`,
whose generator, late updates, traced slice and notes run it) with another
update: the next depth frame's insert (sense), the environment's occupied
voxels as obstacles of a new distance field and its exact EDT (edt), FK of
the next joint state and the arm's least distance to an obstacle, read on
the host (query). Latency runs from the update's due time to that read.

The configuration's `world_offset_m` moves every box, the moving box and
its path, the robot's base and the camera, so that the workcell lies in
the map, which starts at the world's origin.
"""
from __future__ import annotations

import copy

import torch

from ..reference import distance, geometry, sensing
from . import Window, monitor

# monitor.run's names of the second and third steps, and theirs here
STEPS = {"fk": "edt", "collide": "query"}


def world(cfg: dict) -> dict:
    """The configuration with `world_offset_m` applied."""
    c = copy.deepcopy(cfg)
    c["boxes_m"] = [[_moved(cfg, p) for p in box] for box in cfg["boxes_m"]]
    c["moving_box_m"] = [_moved(cfg, p) for p in cfg["moving_box_m"]]
    c["robot"]["base_m"] = _moved(cfg, cfg["robot"]["base_m"])
    c["sensor"]["position_m"] = _moved(cfg, cfg["sensor"]["position_m"])
    return c


def world_traffic(cfg: dict, traffic: dict) -> dict:
    """The traffic with the moving box's path moved by `world_offset_m`."""
    t = copy.deepcopy(traffic)
    mb = t["scene"]["moving_box"]
    mb["range_m"] = [float(r + cfg["world_offset_m"][mb["axis"]]) for r in mb["range_m"]]
    return t


def _moved(cfg: dict, p) -> list:
    return [float(v + o) for v, o in zip(p, cfg["world_offset_m"])]


def prepare(cfg: dict, traffic: dict, seed: int, seconds: float, device) -> dict:
    return monitor.prepare(world(cfg), world_traffic(cfg, traffic), seed, seconds, device)


def readings(cfg: dict, traffic: dict, seed: int, count: int, device) -> dict:
    return monitor.readings(world(cfg), world_traffic(cfg, traffic), seed, count, device)


class _Steps:
    """A clearance monitor as the three steps monitor.run and monitor.warm
    call: sense(frame); place(state), here the distance field, the state
    passed on; collide(state), here the clearance query. `env` is the
    environment warm sets aside and restores."""

    def __init__(self, system):
        self.system = system

    @property
    def env(self):
        return self.system.env

    @env.setter
    def env(self, value):
        self.system.env = value

    def sense(self, frame) -> None:
        self.system.sense(frame)

    def place(self, state):
        self.system.distance_field()
        return state

    def collide(self, state) -> float:
        return self.system.clearance(state)

    def outputs(self) -> dict:
        return self.system.outputs()


class _Renamed:
    """The harness's recorder, its spans named as this loop's steps."""

    def __init__(self, rec):
        self.rec = rec

    def span(self, name: str):
        return self.rec.span(STEPS.get(name, name))

    def __getattr__(self, name):
        return getattr(self.rec, name)


def build(cfg: dict, traffic: dict, inp: dict, device, control: bool = False):
    if control:
        from ..control_distance import Clearance
    else:
        from ..system_distance import Clearance
    return _Steps(Clearance(world(cfg), device))


warm = monitor.warm


def run(system, inp: dict, traffic: dict, seconds: float, rec, t_process: float, slice_s: float) -> Window:
    win = monitor.run(system, inp, traffic, seconds, _Renamed(rec), t_process, slice_s)
    win.layers = {STEPS.get(k, k): v for k, v in win.layers.items()}
    clearances = win.record.pop("counts")
    win.record["clearances"] = clearances
    del win.notes["updates_colliding"], win.notes["count_max"]
    answered = [c for c in clearances[:win.attempted] if c is not None]
    win.notes.update(updates_touching=sum(c == 0.0 for c in answered), clearance_min_m=min(answered, default=None))
    return win


def judge(cfg: dict, traffic: dict, inp: dict, win: Window, out: dict, device) -> dict:
    """Every update's clearance against the reference's band; the
    environment's log-odds after the window against the band of each voxel,
    as the monitor judges them; the last
    field's obstacles (squared distance 0) against its environment's
    occupied voxels, and its squared distances against the reference EDT of
    those obstacles, voxel for voxel."""
    cfg = world(cfg)
    robot, side, dims = cfg["robot"], cfg["map"]["side_m"], cfg["map"]["dims"]
    sensor, t = cfg["sensor"], sensing.threshold(cfg["occupancy_threshold"])
    frames = [torch.as_tensor(f, device=device) for f in inp["frames"]]
    traj = inp["trajectory"]
    pts = geometry.fk_points(robot, inp["clouds"], robot["base_m"], traj, device)
    _, cand = geometry.voxel_band(pts, side, dims)
    del pts
    lo = torch.full((dims[0] * dims[1] * dims[2],), sensing.UNKNOWN, dtype=torch.int8, device=device)
    hi = lo.clone()
    clearances = win.record["clearances"]
    outside = wide = 0
    for i, c in enumerate(clearances):
        lo, hi = sensing.fuse_band(lo, hi, frames[i % len(frames)], sensor, side, dims)
        a, b = distance.clearance_band(lo.to(torch.int32) >= t, hi.to(torch.int32) >= t, cand[i % len(traj)],
                                       side, dims)
        a, b = float(a), float(b)
        wide += a != b
        outside += c is None or not a <= c <= b
    env = out["env"].to(device)
    env_out = int(((env < lo) | (env > hi)).sum())
    obstacles = env.to(torch.int32) >= t
    d2 = out["d2"].to(device).reshape(-1).to(torch.int64)
    obstacles_differ = int(((d2 == 0) != obstacles).sum())
    edt_differ = int((d2 != distance.squared_edt(obstacles, dims).reshape(-1)).sum())
    win.notes.update(updates_with_band=wide, env_voxels_with_band=int((lo != hi).sum()),
                     env_voxels_occupied=int((lo.to(torch.int32) >= t).sum()), obstacle_voxels=int(obstacles.sum()))
    return {
        "env_voxels_outside_band": (env_out, 0),
        "obstacles_differ": (obstacles_differ, 0),
        "edt_voxels_differ": (edt_differ, 0),
        "clearances_outside_band": (outside, 0),
    }
