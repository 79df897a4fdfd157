"""Logging shims (reference: icl_core_logging + gpu_voxels/logging/*).

Counterpart of gpu_voxels_tpu/utils/logging.py, under the port's own logger
root (`gpu_voxels_tpu_torch`).

Per-subsystem named streams with runtime level control, backed by Python
logging. LOGGING_*_C(Stream, Class, msg) maps to stream.info/.../error.
"""
from __future__ import annotations

import logging as _pylog
import sys
from typing import Dict

_STREAMS: Dict[str, _pylog.Logger] = {}
_initialized = False


def initialize(level=_pylog.INFO, stream=sys.stderr) -> None:
    """icl_core::logging::initialize equivalent."""
    global _initialized
    if not _initialized:
        handler = _pylog.StreamHandler(stream)
        handler.setFormatter(_pylog.Formatter("%(asctime)s %(name)s [%(levelname)s] %(message)s"))
        root = _pylog.getLogger("gpu_voxels_tpu_torch")
        root.addHandler(handler)
        root.setLevel(level)
        _initialized = True


def log_stream(name: str) -> _pylog.Logger:
    """DECLARE_LOG_STREAM equivalent: a named subsystem stream."""
    if name not in _STREAMS:
        _STREAMS[name] = _pylog.getLogger(f"gpu_voxels_tpu_torch.{name}")
    return _STREAMS[name]


def set_log_level(name: str, level) -> None:
    log_stream(name).setLevel(level)


# the reference's per-subsystem streams (gpu_voxels/logging/*)
Gpu_voxels = log_stream("Gpu_voxels")
VoxelmapLog = log_stream("Voxelmap")
VoxellistLog = log_stream("Voxellist")
OctreeLog = log_stream("Octree")
RobotLog = log_stream("Robot")
VisualizationLog = log_stream("Visualization")
DistanceLog = log_stream("DistanceMap")
