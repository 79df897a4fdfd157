"""DistanceVoxelMap (reference: voxelmap/DistanceVoxelMap.{h,hpp}).

Counterpart of gpu_voxels_tpu/maps/distance_map.py: a dense grid of packed
nearest-obstacle coordinates (int32[N], the reference's uint32 values; bit
31 is never set) with the EDT algorithms and the distance queries.
`parallel_banding` is the exact EDT through the Z flood kernel and CUDA
kernel K5 (ops/edt_envelope.py); `merge_occupied` and `min_distance_to` are
one kernel each on a CUDA map (ops/edt_cuda.py); `jump_flood` routes by
device as the reference routes by platform; `exact_separable` and
`exact_distances` are the oracles. Methods are functional, like the other
maps: each returns a new map (or a tensor) on the map's device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch

from ..constants import PBA_UNINITIALISED_PACKED, BitVoxelMeaning, MapType, float_to_probability
from ..ops import edt, edt_cuda, edt_envelope
from ..ops import insert as insert_ops
from ..utils import perfmon, resolve_device, to_device
from ..utils.logging import log_stream
from .voxelmap import ProbVoxelMap, _DenseMap, _n, takes_sharded_operand

_log = log_stream("voxelmap")

Dims = Tuple[int, int, int]


@dataclass(frozen=True, eq=False)
class DistanceVoxelMap(_DenseMap):
    """data: int32[N] DistanceVoxel-packed obstacle coordinates."""

    map_type = MapType.MT_DISTANCE_VOXELMAP
    _default_value = PBA_UNINITIALISED_PACKED  # print_voxel_map_data skips uninitialised voxels

    @staticmethod
    def create(dims: Dims, side_length: float = 1.0, device=None) -> "DistanceVoxelMap":
        data = torch.full((_n(dims),), PBA_UNINITIALISED_PACKED, dtype=torch.int32, device=resolve_device(device))
        return DistanceVoxelMap(data, tuple(int(d) for d in dims), float(side_length))

    def clear_map(self) -> "DistanceVoxelMap":
        return replace(self, data=torch.full_like(self.data, PBA_UNINITIALISED_PACKED))

    def fill_pba_uninit(self) -> "DistanceVoxelMap":
        """fill_pba_uninit (DistanceVoxelMap.h): every voxel back to the PBA
        uninitialised sentinel (the same as clear_map here)."""
        return self.clear_map()

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (stubbed NOT_SUPPORTED in the reference,
        DistanceVoxelMap.hpp:89-94): inserts the robot cloud as obstacles.
        Returns (new_map, ok device bool)."""
        clash = torch.zeros((), dtype=torch.bool, device=self.device)
        if with_self_collision_test:
            clash = insert_ops.self_collision_clash(robot_links, self.side_length, self.dims)
        return self.insert_point_cloud(robot_links.points), ~clash

    def clear_voxel_meaning(self, meaning) -> "DistanceVoxelMap":
        """clearBitVoxelMeaning (a NOP-with-TODO in the reference,
        DistanceVoxelMap.hpp:96-102): eBVM_OCCUPIED resets the map to
        uninitialised, anything else logs and leaves it."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            _log.error("DistanceVoxelMap only supports clearing eBVM_OCCUPIED")
            return self
        return self.clear_map()

    # -- obstacle insertion --------------------------------------------------
    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED) -> "DistanceVoxelMap":
        """DistanceVoxel::insert: obstacle voxels store their own coordinates
        (any meaning). Out-of-map points go to a spare slot N (F2)."""
        idx, _ = insert_ops.voxelize(to_device(points, torch.float32, self.device), self.side_length, self.dims)
        mask = insert_ops.occupancy_mask(idx, self.voxelmap_size).bool()
        return replace(self, data=edt.with_obstacles(self.data, mask, self.dims))

    @takes_sharded_operand
    def merge_occupied(self, prob_map: ProbVoxelMap, occupancy_threshold: float = 0.5) -> "DistanceVoxelMap":
        """mergeOccupied (DistanceVoxelMap.h:86-122): the prob map's occupied
        voxels become obstacles (one kernel launch on a CUDA map)."""
        with perfmon.span("distance.merge"):
            return replace(self, data=edt_cuda.merge_occupied(self.data, prob_map.data,
                                                              float_to_probability(occupancy_threshold), self.dims))

    # -- EDT algorithms ------------------------------------------------------
    def jump_flood(self, extra_rounds: int = 1) -> "DistanceVoxelMap":
        """jumpFlood3D (DistanceVoxelMap.hpp:136), routed as the reference
        routes it: large grids (extra_rounds == 1, min(dims) >= 128, every
        dim divisible by 4) take the exact envelope sweeps (K5) on a CUDA
        map, the reference's TPU route, and the multi-resolution JFA on a
        CPU map, its CPU route; small or non-divisible grids, and
        extra_rounds > 1, take the flat JFA with its step-1 repair. The CUDA
        route is exact. The two JFA routes stop their repair at 64 rounds,
        as the reference's do (gpu_voxels_tpu/ops/edt.py:189-203): where the
        cap binds, voxels keep a site farther than the nearest, and the
        result is the reference's, not the exact EDT.
        `ops.edt.jump_flood_multires_with_stats` and `jump_flood_with_stats`
        return the repair's round count (64: the cap was reached) and take
        a larger `max_iters`."""
        route = self._jump_flood_route(self.dims, extra_rounds, self.data.device)
        if route == "banding":
            return self.parallel_banding()
        if route == "multires":
            return replace(self, data=edt.jump_flood_multires(self.data, self.dims))
        return replace(self, data=edt.jump_flood(self.data, self.dims, extra_rounds))

    @staticmethod
    def _jump_flood_route(dims: Dims, extra_rounds: int, device: torch.device) -> str:
        """The route jump_flood takes for a map of `dims` on `device`:
        "banding" (the exact EDT, a CUDA map), "multires" (the
        multi-resolution JFA, any other device) or "flat" (the flat JFA)."""
        if extra_rounds == 1 and min(dims) >= 128 and all(d % 4 == 0 for d in dims):
            return "banding" if device.type == "cuda" else "multires"
        return "flat"

    def parallel_banding(self, m1: int = 1, m2: int = 1, m3: int = 1) -> "DistanceVoxelMap":
        """parallelBanding3D (DistanceVoxelMap.hpp:279): the exact EDT, PBA's
        banded phases as min-plus envelope passes (K5 on CUDA). The band
        counts m1/m2/m3 are accepted for API parity only."""
        del m1, m2, m3
        with perfmon.span("distance.edt"):
            return replace(self, data=edt_envelope.parallel_banding(self.data, self.dims))

    def exact_separable(self) -> "DistanceVoxelMap":
        """The exact EDT as two Z scans plus batched Meijster envelopes
        (ops/edt.exact_separable): an exactness reference."""
        return replace(self, data=edt.exact_separable(self.data, self.dims))

    def exact_distances(self, obstacle_coords) -> "DistanceVoxelMap":
        """exactDistances3D oracle (DistanceVoxelMap.hpp:203): brute force
        against int[M, 3] obstacle coordinates."""
        obs = to_device(obstacle_coords, torch.int32, self.device)
        return replace(self, data=edt.exact_distances(obs, self.dims))

    # -- queries ---------------------------------------------------------------
    def squared_distances(self) -> torch.Tensor:
        """int32[Z, Y, X] squared obstacle distances (MAX_OBSTACLE_DISTANCE
        where uninitialised)."""
        return edt.squared_distance_grid(self.data, self.dims)

    def get_squared_obstacle_distance(self, x: int, y: int, z: int) -> torch.Tensor:
        """getSquaredObstacleDistance (DistanceVoxelMap.hpp:699-717), a 0-d
        int32 tensor; computed for that voxel only."""
        dx, dy, _ = self.dims
        i = torch.full((), int(z) * dx * dy + int(y) * dx + int(x), dtype=torch.int64, device=self.device)
        return edt.squared_distance_at(self.data, i, self.dims)

    def get_obstacle_distance(self, x: int, y: int, z: int) -> torch.Tensor:
        return torch.sqrt(self.get_squared_obstacle_distance(x, y, z).to(torch.float32))

    def min_distance_to(self, points) -> torch.Tensor:
        """The least metric distance from any of the query points to its
        nearest obstacle (a proximity query batch), a 0-d float32 tensor;
        points outside the map count as MAX_OBSTACLE_DISTANCE. Reads the
        EDT at the query voxels only (one kernel launch on a CUDA map)."""
        with perfmon.span("distance.query"):
            points = to_device(points, torch.float32, self.device).reshape(-1, 3).contiguous()
            return edt_cuda.min_distance_to(self.data, points, self.side_length, self.dims)

    def extract_distances(self, robot_radius: int = 0) -> torch.Tensor:
        """int8 free-space bytes (extract_byte_distance functor)."""
        return edt.extract_byte_distances(self.data, self.dims, robot_radius)

    def init_floodfill(self) -> torch.Tensor:
        """Manhattan distance field for planners (getManhattanDistances)."""
        return edt.manhattan_distance(self.obstacle_mask(), self.dims)

    def obstacle_mask(self) -> torch.Tensor:
        return self.squared_distances().reshape(-1) == 0

    @takes_sharded_operand
    def differences(self, other: "DistanceVoxelMap") -> torch.Tensor:
        """differences3D cross-check (testing_distance.cu:79-119), a 0-d
        int64 count."""
        return edt.differences(self.data, other.data, self.dims)
