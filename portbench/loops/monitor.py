"""The safety monitor: an open loop of updates at the traffic's rate.

An update is due every 1 / rate_hz seconds from the window's start. It
hands the next depth frame (host memory, as a camera callback delivers it)
to the depth insert, then FK of the next joint state, the robot into a new
bit map, the collide, and the count read on the host. The generator never
drops an update: a late one runs as soon as the one before it has
answered, and its latency is timed from the moment it was due.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from .. import inputs, stats
from ..reference import geometry, sensing
from . import Window


def prepare(cfg: dict, traffic: dict, seed: int, seconds: float, device) -> dict:
    return {
        "frames": inputs.depth_frames(cfg, traffic["scene"], traffic["frame_pool"], seed, device),
        "trajectory": inputs.trajectory(traffic["trajectory"], seed),
        "clouds": inputs.link_clouds(cfg["robot"]),
    }


def readings(cfg: dict, traffic: dict, seed: int, count: int, device) -> dict:
    """The band's readings over what this mix drives: trajectory states
    (about `count`) and the frame pool."""
    from .. import readings as r

    spec = traffic["trajectory"]
    states = np.concatenate([inputs.trajectory(spec, seed * 1000 + k) for k in range(max(count // spec["states"], 1))])
    frames = inputs.depth_frames(cfg, traffic["scene"], traffic["frame_pool"], seed, device)
    return {**r.fk_errors(cfg, states[:, :6], device), **r.depth_errors(cfg, frames, device)}


def build(cfg: dict, traffic: dict, inp: dict, device, control: bool = False):
    if control:
        from ..control import Monitor
    else:
        from ..system import Monitor
    return Monitor(cfg, device)


def warm(system, inp: dict, traffic: dict) -> None:
    """Every shape of the window on a scratch environment, which the real
    one then replaces: the window starts from the state set-up left."""
    env = system.env
    for i in range(3):
        system.sense(inp["frames"][i])
        system.collide(system.place(inp["trajectory"][i]))
    system.env = env
    system.robot = None


def _wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


def run(system, inp: dict, traffic: dict, seconds: float, rec, t_process: float, slice_s: float) -> Window:
    """The window's updates, then, in a traced run, `slice_s` more under
    the profiler: their due times start afresh once the profiler runs, and
    the sequence of frames and joint states goes on."""
    rate = traffic["rate_hz"]
    n = max(int(round(seconds * rate)), 1)
    m = int(round(slice_s * rate)) if rec.trace else 0
    counts, lat, late, marks = [None] * (n + m), [None] * (n + m), [], []
    t0 = time.perf_counter() + 0.05
    failed = _updates(system, inp, traffic, rec, range(n), t0, counts, lat, late, marks)
    if m:
        rec.start_slice()
        _updates(system, inp, traffic, rec, range(n, n + m), time.perf_counter() + 0.05 - n / rate,
                 counts, lat, [], [])
        rec.stop_slice()
    layers = {}
    if rec.trace:
        if rec.cuda:
            torch.cuda.synchronize()
        for k, name in enumerate(("sense", "fk", "collide")):
            layers[name] = [rec.elapsed_ms(ev[k], ev[k + 1]) for ev in marks if ev is not None]
    window = lat[:n]
    done = sum(v is not None for v in window)
    notes = {
        "updates": n, "answered": done, "rate_hz": rate,
        "latency_median_ms": stats.median([v for v in window if v is not None]) if done else None,
        "generator_late_max_ms": max(late) * 1e3, "generator_late_median_ms": stats.median(late) * 1e3,
        "updates_colliding": sum(1 for c in counts[:n] if c), "count_max": max((c or 0) for c in counts[:n]),
        "last_answer_s": (n - 1) / rate + (window[-1] or 0.0) / 1e3,
    }
    return Window(t0 - t_process, n / rate, n, failed, done, window, layers, notes, {"counts": counts})


def _updates(system, inp, traffic, rec, indices, t0, counts, lat, late, marks) -> int:
    """Run the updates `indices`, update i due at t0 + i / rate; returns
    how many failed."""
    period = 1.0 / traffic["rate_hz"]
    frames, traj = inp["frames"], inp["trajectory"]
    failed = 0
    for i in indices:
        due = t0 + i * period
        _wait_until(due)
        late.append(time.perf_counter() - due)
        try:
            with rec.span("update"):
                ev = [rec.event()]
                with rec.span("sense"):
                    system.sense(frames[i % len(frames)])
                ev.append(rec.event())
                with rec.span("fk"):
                    pts = system.place(traj[i % len(traj)])
                ev.append(rec.event())
                with rec.span("collide"):
                    counts[i] = system.collide(pts)
                ev.append(rec.event())
            lat[i] = (time.perf_counter() - due) * 1e3
            marks.append(ev)
        except Exception:  # a failed update counts as missing; the run goes on
            failed += 1
            traceback.print_exc(file=sys.stderr)
            marks.append(None)
    return failed


def judge(cfg: dict, traffic: dict, inp: dict, win: Window, out: dict, device) -> dict:
    """Every update's count against the reference's band, the environment's
    log-odds after the window against the band of each voxel (one byte
    where no measurement lay near a boundary), and the last update's robot
    voxels against the band of its state."""
    robot, side, dims = cfg["robot"], cfg["map"]["side_m"], cfg["map"]["dims"]
    sensor, t = cfg["sensor"], sensing.threshold(cfg["collide_threshold"])
    frames = [torch.as_tensor(f, device=device) for f in inp["frames"]]
    traj = inp["trajectory"]
    pts = geometry.fk_points(robot, inp["clouds"], robot["base_m"], traj, device)
    sure, cand = geometry.voxel_band(pts, side, dims)
    del pts
    lo = torch.full((dims[0] * dims[1] * dims[2],), sensing.UNKNOWN, dtype=torch.int8, device=device)
    hi = lo.clone()
    counts = win.record["counts"]
    outside = wide = 0
    for i, c in enumerate(counts):
        j = i % len(traj)
        lo, hi = sensing.fuse_band(lo, hi, frames[i % len(frames)], sensor, side, dims)
        a, b = geometry.count_band(sure[j:j + 1], cand[j:j + 1], lo.to(torch.int32) >= t, hi.to(torch.int32) >= t)
        a, b = int(a), int(b)
        wide += a != b
        outside += c is None or not a <= c <= b
    j = (len(counts) - 1) % len(traj)
    s_keys = torch.unique(sure[j][sure[j] >= 0])
    u_keys = torch.unique(cand[j][cand[j] >= 0])
    got = out["robot_voxels"].to(device)
    robot_out = int((~torch.isin(s_keys, got)).sum()) + int((~torch.isin(got, u_keys)).sum()) + out["robot_stray"]
    env = out["env"].to(device)
    env_out = int(((env < lo) | (env > hi)).sum())
    win.notes.update(updates_with_band=wide, env_voxels_with_band=int((lo != hi).sum()),
                     env_voxels_occupied=int((lo.to(torch.int32) >= t).sum()))
    return {
        "counts_outside_band": (outside, 0),
        "env_voxels_outside_band": (env_out, 0),
        "robot_voxels_outside_band": (robot_out, 0),
    }
