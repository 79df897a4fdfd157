"""Reference ``.traj`` trajectory files (swept_fitter's format).

Counterpart of gpu_voxels_tpu/robot/trajectory.py: host code, numpy only.

The swept_fitter app ships per-robot trajectory files under
``models/trajectories/*.traj`` and parses them in
``examples/swept_fitter/swept_fitter/Robot.cpp:45-113``:

    Trajectory_Num: <N>
    [ per trajectory:
      Joint_Num: <J>
      Name: <name>
      <joint_name> <min> <max>     (J lines)
    ]

Each trajectory is a linear joint-space motion from the ``min`` to the
``max`` configuration; the reference renders it with 100 intermediate poses
(``Robot.cpp:132``). This loader reproduces that contract for users
migrating their ``.traj`` assets.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np

from .robot import interpolate_linear


@dataclass(frozen=True)
class Trajectory:
    """One linear joint-space motion (swept_fitter Trajectory)."""

    name: str
    start: Dict[str, float]  # joint -> min value
    end: Dict[str, float]  # joint -> max value

    @property
    def joint_names(self) -> List[str]:
        return list(self.start.keys())

    def interpolate(self, intermediate_poses: int = 100) -> np.ndarray:
        """float32[intermediate_poses + 1, J] linearly interpolated
        configurations (the reference uses 100 intermediate poses,
        Robot.cpp:131-133)."""
        lo = np.array([self.start[j] for j in self.joint_names], np.float32)
        hi = np.array([self.end[j] for j in self.joint_names], np.float32)
        ts = np.linspace(0.0, 1.0, intermediate_poses + 1, dtype=np.float32)
        # a*(1-t) + b*t: the SAME expression as interpolate_linear
        # (MathHelpers.cpp:84-115) so interpolate(N)[k] == joint_map_at(k/N)
        # bit-for-bit
        return lo[None, :] * (1.0 - ts[:, None]) + hi[None, :] * ts[:, None]

    def joint_map_at(self, t: float) -> Dict[str, float]:
        """Interpolated configuration as a joint-value map (for
        set_robot_configuration); delegates to the canonical
        interpolate_linear (MathHelpers.cpp:84-115 port)."""
        return interpolate_linear(self.start, self.end, t)


def load_trajectories(path, max_trajectories: int | None = None, use_model_path: bool = True) -> List[Trajectory]:
    """Parse a ``.traj`` file (Robot.cpp:45-113 format).

    With use_model_path, relative paths resolve against
    ``$GPU_VOXELS_MODEL_PATH/trajectories/`` exactly like the reference.
    """
    p = Path(path)
    if use_model_path and not p.is_absolute():
        env = os.environ.get("GPU_VOXELS_MODEL_PATH")
        if env:
            p = Path(env) / "trajectories" / p
    tokens = p.read_text().split()
    it = iter(tokens)
    _END = object()

    def take() -> str:
        tok = next(it, _END)
        if tok is _END:
            raise ValueError("illegal .traj format: unexpected end of file")
        return tok

    def expect(tag: str) -> None:
        tok = take()
        if tok != tag:
            raise ValueError(f"illegal .traj format: expected {tag!r}, got {tok!r}")

    expect("Trajectory_Num:")
    num = int(take())
    if max_trajectories is not None:
        num = min(num, max_trajectories)
    out: List[Trajectory] = []
    for _ in range(num):
        expect("Joint_Num:")
        joints = int(take())
        expect("Name:")
        name = take()
        start: Dict[str, float] = {}
        end: Dict[str, float] = {}
        for _ in range(joints):
            jname = take()
            start[jname] = float(take())
            end[jname] = float(take())
        out.append(Trajectory(name, start, end))
    return out
