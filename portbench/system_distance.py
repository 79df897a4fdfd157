"""The distance monitor's system under test: upstream's DistanceKinectDemo
loop through the port's public objects, beside the UR10. Its control twin
is in `control_distance.py`."""
from __future__ import annotations

from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap

from .system import Monitor


class Clearance(Monitor):
    """A safety-distance monitor: each frame's depth insert into the
    ProbVoxelMap (`Monitor.sense`), its occupied voxels as the obstacles of
    a new DistanceVoxelMap, `parallel_banding` (the demo's
    parallelBanding3D), then the arm's FK (`Monitor.place`) and
    `min_distance_to` its points, the clearance read on the host."""

    def __init__(self, cfg: dict, device):
        if cfg["edt"] != "parallel_banding":
            raise ValueError(f"the distance monitor runs parallel_banding, not {cfg['edt']!r}")
        super().__init__(cfg, device)
        self.occupancy = cfg["occupancy_threshold"]
        self.field = None

    def distance_field(self) -> None:
        self.field = (DistanceVoxelMap.create(self.dims, self.side, device=self.device)
                      .merge_occupied(self.env, self.occupancy).parallel_banding())

    def clearance(self, joints) -> float:
        """The least distance, in m, from the arm's points at `joints` to an obstacle."""
        return float(self.field.min_distance_to(self.place(joints)))

    def outputs(self) -> dict:
        """What the judge reads: the environment's log-odds and the last
        distance field's squared distances, in voxels."""
        return {"env": self.env.data.clone(), "d2": self.field.squared_distances()}
