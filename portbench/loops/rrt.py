"""The planner: RRT-Connect solves start to goal, back to back, for the
whole window (a closed loop), each solve with its own seed drawn from the
run's seed. The port's RRTConnect takes the benchmark's `Windowed`
validator, which forwards each motion check to the port's MotionValidator,
records its arguments and answer, and closes the window: a check due after
the window's end ends the solve. The validator's checker is a `Recording`
proxy of the port's GvlValidityChecker that keeps each batch's states and
counts as the host read them, so recording reads nothing more.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import inputs
from ..reference import geometry, sensing, workcell
from . import Window

CHUNK = 256  # states per block of the reference


class WindowClosed(Exception):
    pass


class Recording:
    """The checker as the validator sees it, keeping what the host read."""

    def __init__(self, checker):
        self._checker = checker
        self.batches = []  # (states, counts)
        self.valid = []  # (state, answer)

    def batch_colliding_voxels(self, states):
        counts = self._checker.batch_colliding_voxels(states)
        self.batches.append((np.array(states, np.float32), np.array(counts)))
        return counts

    def is_valid(self, cfg) -> bool:
        ok = self._checker.is_valid(cfg)
        self.valid.append((np.array(cfg, np.float32), bool(ok)))
        return ok

    def __getattr__(self, name):
        return getattr(self._checker, name)


class Windowed:
    """The validator handed to RRTConnect."""

    def __init__(self, validator, rec):
        self._validator = validator
        self.checker = validator.checker
        self.resolution = validator.resolution
        self.rec, self.close = rec, 0.0
        self.checks = []  # (a, b, answer, batch index, start, end)

    def check_motion(self, a, b):
        if time.perf_counter() >= self.close:
            raise WindowClosed
        k = len(self.checker.batches)
        t0 = time.perf_counter()
        with self.rec.span("check"):
            ok, n = self._validator.check_motion(a, b)
        self.checks.append((np.array(a, np.float32), np.array(b, np.float32), bool(ok), k, t0, time.perf_counter()))
        return ok, n

    def segment_states(self, a, b):
        return self._validator.segment_states(a, b)


def prepare(cfg: dict, traffic: dict, seed: int, seconds: float, device) -> dict:
    return {"clouds": inputs.link_clouds(cfg["robot"]), "solve_seeds": inputs.solve_seeds(seed, 4096),
            "start": np.asarray(traffic["start_rad"], np.float32), "goal": np.asarray(traffic["goal_rad"], np.float32)}


def readings(cfg: dict, traffic: dict, seed: int, count: int, device) -> dict:
    """The band's readings over `count` states uniform in the joint space,
    which the planner samples."""
    from .. import readings as r

    return r.fk_errors(cfg, inputs.uniform_states(cfg, count, seed), device)


def build(cfg: dict, traffic: dict, inp: dict, device, control: bool = False):
    if control:
        from ..control import Workcell
    else:
        from ..system import Workcell
    return Workcell(cfg, device)


def warm(system, inp: dict, traffic: dict) -> None:
    """Every batch length a check can take: a step of `step_rad` makes at
    most ceil(step / resolution) + 1 states, start to goal its own count."""
    checker = system.checker
    most = int(np.ceil(traffic["step_rad"] / system.resolution)) + 1
    first = len(workcell.segment_states(inp["start"], inp["goal"], system.resolution))
    for n in sorted(set(range(2, most + 1)) | {first}):
        checker.batch_colliding_voxels(np.zeros((n, 6), np.float32))
    checker.is_valid(inp["start"])


def run(system, inp: dict, traffic: dict, seconds: float, rec, t_process: float, slice_s: float) -> Window:
    """Solves for the window, then, in a traced run, for `slice_s` more
    under the profiler (its checks are judged too, not counted)."""
    checker = Recording(system.checker)
    v = Windowed(system.validator(checker), rec)
    seeds = iter(inp["solve_seeds"])
    solves = []
    t0 = time.perf_counter()
    _solve_until(system, v, inp, traffic, seeds, t0 + seconds, solves)
    n = len(v.checks)
    if rec.trace:
        rec.start_slice()
        _solve_until(system, v, inp, traffic, seeds, time.perf_counter() + slice_s, [])
        rec.stop_slice()
    window = v.checks[:n]
    done = sum(1 for c in window if c[5] <= t0 + seconds)
    layers = {}
    if rec.trace and window:
        span = [(c[5] - c[4]) * 1e3 for c in window]
        layers["check"] = span
        layers["planner_host_per_check"] = [((window[-1][5] - t0) * 1e3 - sum(span)) / len(window)]
    solved = [r for r in solves if r.solved]
    notes = {"motion_checks": done, "solves_finished": len(solves), "solves_solved": len(solved),
             "states_checked": int(sum(len(checker.batches[c[3]][0]) for c in window))}
    record = {"checks": v.checks, "batches": checker.batches, "valid": checker.valid,
              "paths": [r.path.states for r in solved]}
    return Window(t0 - t_process, seconds, n, 0, done, [], layers, notes, record)


def _solve_until(system, v: Windowed, inp: dict, traffic: dict, seeds, close: float, solves: list) -> None:
    v.close = close
    for s in seeds:
        planner = system.planner(v, traffic["step_rad"], s)
        try:
            solves.append(planner.solve(inp["start"], inp["goal"], max_iters=traffic["max_iters"]))
        except WindowClosed:
            return


def bands(cfg: dict, inp: dict, states: np.ndarray, occupied: torch.Tensor, device):
    """(lo, hi) numpy [n]: the reference's count band of each state."""
    robot = cfg["robot"]
    lo, hi = [], []
    for i in range(0, len(states), CHUNK):
        pts = geometry.fk_points(robot, inp["clouds"], robot["base_m"], states[i:i + CHUNK], device)
        sure, cand = geometry.voxel_band(pts, cfg["map"]["side_m"], cfg["map"]["dims"])
        a, b = geometry.count_band(sure, cand, occupied)
        lo.append(a.cpu().numpy())
        hi.append(b.cpu().numpy())
    return (np.concatenate(lo), np.concatenate(hi)) if lo else (np.zeros(0, int), np.zeros(0, int))


def reference_env(cfg: dict, out: dict, device):
    """(occupied voxels, voxels where the program's map differs)."""
    env = workcell.env_map(cfg, device)
    differ = int((out["env"].to(device) != env).sum())
    return env.to(torch.int32) >= sensing.threshold(cfg["validity_threshold"]), differ


def judge(cfg: dict, traffic: dict, inp: dict, win: Window, out: dict, device) -> dict:
    """Every recorded check: its states against the reference's
    interpolation, each state's count against the reference's band, its
    answer against what the band allows; the endpoints' validity answers
    likewise; every state of every returned path free."""
    occupied, env_diff = reference_env(cfg, out, device)
    m, res = cfg["max_colliding_voxels"], cfg["motion_resolution_rad"]
    rec = win.record
    states_differ = 0
    ref_states, port_counts, owner = [], [], []
    for k, (a, b, ok, batch, _, _) in enumerate(rec["checks"]):
        want = workcell.segment_states(a, b, res)
        got, counts = rec["batches"][batch]
        states_differ += int(not np.array_equal(want, got))
        ref_states.append(want)
        port_counts.append(counts if len(counts) == len(want) else np.full(len(want), -1))
        owner.append(np.full(len(want), k))
    for cfg_state, _ in rec["valid"]:
        ref_states.append(cfg_state[None])
        port_counts.append(np.full(1, -2))  # an endpoint check gives an answer, no count
        owner.append(np.full(1, -1))
    states = np.concatenate(ref_states) if ref_states else np.zeros((0, 6), np.float32)
    counts, owner = np.concatenate(port_counts or [np.zeros(0)]), np.concatenate(owner or [np.zeros(0)])
    lo, hi = bands(cfg, inp, states, occupied, device)
    measured = counts != -2
    outside = int((measured & ((counts < lo) | (counts > hi))).sum())
    wrong = 0
    for k, (_, _, ok, _, _, _) in enumerate(rec["checks"]):
        sel = owner == k
        wrong += (ok and bool((lo[sel] > m).any())) or (not ok and bool((hi[sel] <= m).all()))
    ends = np.flatnonzero(owner == -1)
    for (_, ok), i in zip(rec["valid"], ends):
        wrong += bool((ok and lo[i] > m) or (not ok and hi[i] <= m))
    path_states = [workcell.segment_states(p[i], p[i + 1], res) for p in rec["paths"] for i in range(len(p) - 1)]
    colliding = 0
    if path_states:
        plo, _ = bands(cfg, inp, np.concatenate(path_states), occupied, device)
        colliding = int((plo > m).sum())
    win.notes.update(states_compared=int(measured.sum()), states_with_band=int((lo != hi).sum()),
                     paths_checked=len(rec["paths"]))
    return {
        "states_differ": (states_differ, 0),
        "counts_outside_band": (outside, 0),
        "answers_wrong": (wrong, 0),
        "path_states_colliding": (colliding, 0),
        "env_voxels_differ": (env_diff, 0),
    }
