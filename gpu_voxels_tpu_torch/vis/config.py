"""Visualizer configuration (reference: gpu_visualization/XMLInterpreter.*).

The CUDA viewer reads an XML config with per-meaning colors, draw-type
visibility, camera setup and slicing; the TPU viewer consumes the same
information as a JSON document published next to the map snapshots
(`visconfig.json`). Counterpart of gpu_voxels_tpu/vis/config.py (the same
code). `VisConfig.from_xml` accepts the same conceptual tree:

    <visconfig>
      <camera><position>40 40 40</position><target>0 0 0</target></camera>
      <meaning id="10"><color>255 0 0</color><visible>true</visible></meaning>
      <slice axis="z" min="0" max="128"/>
      <background>17 17 17</background>
    </visconfig>
"""
from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple


@dataclass
class CameraPreset:
    name: str
    position: Tuple[float, float, float]
    target: Tuple[float, float, float] = (0.0, 0.0, 0.0)


@dataclass
class VisConfig:
    """Per-meaning colors/visibility + camera + slicing (XMLInterpreter)."""

    meaning_colors: Dict[int, Tuple[int, int, int]] = field(default_factory=dict)
    meaning_visible: Dict[int, bool] = field(default_factory=dict)
    cameras: List[CameraPreset] = field(default_factory=list)
    slice_axis: Optional[str] = None  # "x" | "y" | "z"
    slice_min: float = float("-inf")
    slice_max: float = float("inf")
    background: Tuple[int, int, int] = (17, 17, 17)

    # -- IO -------------------------------------------------------------------
    @staticmethod
    def from_xml(path) -> "VisConfig":
        cfg = VisConfig()
        root = ET.parse(str(path)).getroot()
        for cam in root.findall("camera"):
            pos = tuple(float(v) for v in cam.findtext("position", "40 40 40").split())
            tgt = tuple(float(v) for v in cam.findtext("target", "0 0 0").split())
            cfg.cameras.append(CameraPreset(cam.get("name", "camera"), pos, tgt))
        for m in root.findall("meaning"):
            mid = int(m.get("id"))
            color = m.findtext("color")
            if color:
                cfg.meaning_colors[mid] = tuple(int(v) for v in color.split())
            vis = m.findtext("visible")
            if vis is not None:
                cfg.meaning_visible[mid] = vis.strip().lower() in ("1", "true", "yes")
        sl = root.find("slice")
        if sl is not None:
            cfg.slice_axis = sl.get("axis", "z")
            cfg.slice_min = float(sl.get("min", "-inf"))
            cfg.slice_max = float(sl.get("max", "inf"))
        bg = root.findtext("background")
        if bg:
            cfg.background = tuple(int(v) for v in bg.split())
        return cfg

    def to_dict(self) -> dict:
        def clamp(v):
            if v == float("inf"):
                return 1e30
            if v == float("-inf"):
                return -1e30
            return v

        return {
            "meaning_colors": {str(k): list(v) for k, v in self.meaning_colors.items()},
            "meaning_visible": {str(k): v for k, v in self.meaning_visible.items()},
            "cameras": [
                {"name": c.name, "position": list(c.position), "target": list(c.target)}
                for c in self.cameras
            ],
            "slice": {
                "axis": self.slice_axis,
                "min": clamp(self.slice_min),
                "max": clamp(self.slice_max),
            },
            "background": list(self.background),
        }

    def publish(self, out_dir) -> Path:
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        p = out / "visconfig.json"
        p.write_text(json.dumps(self.to_dict()))
        return p

    # -- queries (host-side filtering, mirrors the viewer's logic) ------------
    def color_for(self, meaning: int, default) -> Tuple[int, int, int]:
        return self.meaning_colors.get(int(meaning), default)

    def visible(self, meaning: int) -> bool:
        return self.meaning_visible.get(int(meaning), True)

    def slice_keep(self, center, axis_index: Optional[int] = None) -> bool:
        if self.slice_axis is None:
            return True
        ai = {"x": 0, "y": 1, "z": 2}[self.slice_axis]
        return self.slice_min <= center[ai] <= self.slice_max
