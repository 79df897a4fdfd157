"""Sensor abstractions: depth-camera model and data sources.

Counterpart of gpu_voxels_tpu/sensors.py (octree/Sensor.{h,cu},
octree/SensorModel.h, helpers/Kinect). Frames are host numpy float32 arrays
made with numpy's generator, exactly as in the reference, and the pose is a
host numpy matrix computed as the reference computes it; the maps upload
both to their device. The streaming and socket sources are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .constants import SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED
from .geometry import transforms
from .ops.raycast import depth_image_to_point_cloud
from .utils import SENSING, not_ported, to_device


@dataclass
class SensorModel:
    """Probabilistic update magnitudes (octree/SensorModel.h:41-131)."""

    initial_probability: int = SENSOR_MODEL_OCCUPIED
    update_probability: int = SENSOR_MODEL_FREE


@dataclass
class Sensor:
    """Sensor pose + intrinsics + invalid-measure handling (Sensor.h:40-110)."""

    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    orientation_rpy: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    data_width: int = 640
    data_height: int = 480
    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    invalid_value: float = 0.0
    model: SensorModel = field(default_factory=SensorModel)

    def pose(self) -> np.ndarray:
        """Host float32 [4, 4] sensor-to-world transform."""
        return transforms.from_rpy_np(self.orientation_rpy, self.position)

    def process_depth_image(self, depth, device=None) -> torch.Tensor:
        """Depth image -> world-frame points [H*W, 3] on `device`
        (kernel_preprocess*DepthImage + pose transform). NaN rows mark
        invalid measurements."""
        depth = to_device(depth, torch.float32, device)
        pts = depth_image_to_point_cloud(depth, self.fx, self.fy, self.cx, self.cy, self.invalid_value)
        return transforms.transform_points(to_device(self.pose(), torch.float32, depth.device), pts)


class DepthSource:
    """Kinect-grabber contract: poll the latest frame (helpers/Kinect.h)."""

    def get_frame(self) -> Optional[np.ndarray]:
        raise NotImplementedError


class SyntheticDepthSource(DepthSource):
    """Procedural frames (moving wall + noise) for demos and tests."""

    def __init__(self, sensor: Sensor, seed: int = 0):
        self.sensor = sensor
        self.rng = np.random.default_rng(seed)
        self.t = 0

    def get_frame(self) -> np.ndarray:
        h, w = self.sensor.data_height, self.sensor.data_width
        depth = np.full((h, w), 4.0 + np.sin(self.t / 5.0), np.float32)
        depth += self.rng.normal(0, 0.01, (h, w)).astype(np.float32)
        self.t += 1
        return depth


class ReplayDepthSource(DepthSource):
    """Replays recorded frames (an .npy stack) in a loop."""

    def __init__(self, frames: np.ndarray):
        self.frames = np.asarray(frames, np.float32)
        self.i = 0

    def get_frame(self) -> np.ndarray:
        f = self.frames[self.i % len(self.frames)]
        self.i += 1
        return f


StreamingDepthSource = not_ported("StreamingDepthSource", SENSING)
SocketDepthSource = not_ported("SocketDepthSource", SENSING)
