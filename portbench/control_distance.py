"""The distance monitor's control: the reference in the program's place,
one precision down. The depth insert and FK take every matrix product's
operands in TF32 (`control.Monitor`); the EDT holds its squared distances
in bfloat16 between its passes. Each run of it must come out not correct:

    python -m portbench.control --workload distance.kinect30 --seeds 11,12,13
"""
from __future__ import annotations

import torch

from .control import Monitor, _keys
from .reference import distance, sensing


class Clearance(Monitor):
    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.occupied = sensing.threshold(cfg["occupancy_threshold"])
        self.d2 = None

    def distance_field(self) -> None:
        obstacles = self.env.to(torch.int32) >= self.occupied
        self.d2 = distance.squared_edt(obstacles, self.dims, torch.bfloat16).reshape(-1)

    def clearance(self, joints) -> float:
        keys = _keys(self.place(joints), self.side, self.dims)
        d2 = torch.where(keys >= 0, self.d2[keys.clamp(min=0)], distance.MAX).min()
        return float(distance.metres(d2, self.side))

    def outputs(self) -> dict:
        return {"env": self.env.clone(), "d2": self.d2}
