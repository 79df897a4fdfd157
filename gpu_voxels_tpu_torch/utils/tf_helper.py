"""Transform-frame registry (reference: helpers/tfHelper.{h,cpp}).

The reference bridges ROS tf: publish(Matrix4f, parent, child) /
lookup(parent, child) -> Matrix4f. This standalone equivalent keeps a frame
graph of 4x4s and resolves lookups through it (no ROS dependency); a ROS
bridge can feed it by calling publish from a subscriber.

Counterpart of gpu_voxels_tpu/utils/tf_helper.py: host float32 4x4s, the
same numpy code.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..geometry import transforms


class TfHelper:
    def __init__(self):
        self._edges: Dict[Tuple[str, str], np.ndarray] = {}

    def publish(self, matrix, parent: str, child: str) -> None:
        m = np.asarray(matrix, np.float32).reshape(4, 4)
        self._edges[(parent, child)] = m
        self._edges[(child, parent)] = transforms.invert_np(m)

    def lookup(self, parent: str, child: str) -> Optional[np.ndarray]:
        """Transform of `child` expressed in `parent` (graph search)."""
        if parent == child:
            return np.eye(4, dtype=np.float32)
        # BFS over the frame graph
        frontier = [(parent, np.eye(4, dtype=np.float32))]
        seen = {parent}
        while frontier:
            node, acc = frontier.pop(0)
            for (a, b), m in self._edges.items():
                if a == node and b not in seen:
                    nxt = (acc @ m).astype(np.float32)
                    if b == child:
                        return nxt
                    seen.add(b)
                    frontier.append((b, nxt))
        return None
