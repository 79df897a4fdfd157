"""The distance monitor (`distance.kinect30`) on the CPU at a small size:
the reference EDT against brute force over every pair of voxels, the
clearance band, whole runs correct with their metrics and the program's
spans, and planted faults and the control refused."""
import copy
from dataclasses import replace

import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch.constants import PBA_UNINITIALISED_PACKED
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.ops import edt
from portbench import harness, spans
from portbench.loops import distance as loop
from portbench.reference import distance, geometry

CPU = torch.device("cpu")
SEED = 2**31 + 777  # past 32 signed bits
CELL = "distance.kinect30"


def small(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell with a 160x120 frame of the Kinect's field of view into the
    same 2.56 m cube at 64^3 (0.04 m), a pool of 4 frames, 8 joint states."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["sensor"].update(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
    cfg["map"] = {"dims": [64, 64, 64], "side_m": 0.04}
    traffic["frame_pool"] = 4
    traffic["trajectory"]["states"] = 8
    return cfg, traffic


def run(seconds=0.3, control=False, trace=False, execute=harness.execute):
    spec = harness.load_spec()
    w = harness.find_cell(spec, CELL)
    cfg, traffic = small(harness.load_config(spec, w["config"]), harness.load_traffic(w["traffic"]))
    return execute(CELL, SEED, seconds, trace, CPU, 0.0, control=control, cfg=cfg, traffic=traffic)


def brute(obstacles: np.ndarray) -> np.ndarray:
    """int64 [dz, dy, dx]: every voxel against every obstacle voxel."""
    occ = np.argwhere(obstacles)
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in obstacles.shape], indexing="ij"), -1).reshape(-1, 1, 3)
    if not len(occ):
        return np.full(obstacles.shape, distance.MAX, np.int64)
    return ((grid - occ[None]) ** 2).sum(-1).min(-1).reshape(obstacles.shape)


def _grid(kind: str, shape=(6, 9, 11)) -> np.ndarray:
    g = np.zeros(shape, bool)
    if kind == "random":
        g = np.random.default_rng(5).random(shape) < 0.04
    elif kind == "corner":
        g[-1, 0, -1] = True
    elif kind == "faces":  # one voxel on each face of the box
        g[0, 4, 5] = g[-1, 2, 3] = g[3, 0, 7] = g[2, -1, 1] = g[1, 5, 0] = g[4, 3, -1] = True
    elif kind == "full":
        g[:] = True
    return g


@pytest.mark.parametrize("kind", ["random", "corner", "faces", "full", "none"])
def test_reference_edt_equals_brute_force(kind):
    g = _grid(kind)
    dims = g.shape[::-1]
    want = brute(g)
    assert np.array_equal(distance.squared_edt(torch.as_tensor(g), dims, block=200).numpy(), want)
    keys = torch.tensor([0, 17, 200, g.size - 1])
    got = distance.squared_edt_at(torch.as_tensor(g).reshape(-1), keys, dims, block=7)
    assert np.array_equal(got.numpy(), want.reshape(-1)[keys.numpy()])


def test_bfloat16_distances_lose_what_the_check_sees():
    g = np.zeros((1, 1, 40), bool)
    g[0, 0, 0] = True
    exact = distance.squared_edt(torch.as_tensor(g), (40, 1, 1))
    low = distance.squared_edt(torch.as_tensor(g), (40, 1, 1), torch.bfloat16)
    assert exact[0, 0, 19] == 361 and int((low != exact).sum()) > 0 and torch.equal(low[..., :17], exact[..., :17])


def test_clearance_band_holds_either_cell_of_a_boundary_point():
    """A point on a boundary between two cells, one of them an obstacle's
    neighbour: the band spans both cells' distances; a point outside the map
    leaves the upper bound to the others."""
    dims = (8, 8, 8)
    obstacles = torch.zeros(512, dtype=torch.bool)
    obstacles[(4 * 8 + 4) * 8 + 6] = True  # voxel (6, 4, 4)
    side = 0.5
    pts = torch.tensor([[[2.0 + 1e-9, 2.25, 2.25], [-3.0, 1.0, 1.0]]], dtype=torch.float64)  # x on the 3|4 boundary
    _, cand = geometry.voxel_band(pts, side, dims)
    lo, hi = distance.clearance_band(obstacles, obstacles, cand[0], side, dims)
    assert float(lo) == float(distance.metres(torch.tensor(4), side)) and float(hi) == 1.5


def test_the_world_offset_moves_the_workcell_into_the_map():
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "ur10_kinect_distance_256")
    moved, traffic = loop.world(cfg), loop.world_traffic(cfg, harness.load_traffic("distance30"))
    assert moved["robot"]["base_m"] == pytest.approx([1.28, 1.28, 0.5])
    assert moved["sensor"]["position_m"] == pytest.approx([-0.12, 2.68, 1.9])
    assert moved["boxes_m"][0][0] == pytest.approx([0.78, 0.78, 0.0])
    assert moved["boxes_m"][0][1] == pytest.approx([0.98, 0.98, 1.2])
    assert traffic["scene"]["moving_box"]["range_m"] == pytest.approx([-0.02, 2.58])
    assert cfg["robot"]["base_m"] == [1.5, 1.5, 0.5]  # the file's values are left as they are


def test_a_run_is_correct_and_reports_its_metrics():
    r = run(0.3)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 9, r["checks"]
    assert set(r["metrics"]) == {"update_p95_ms", "setup_s"}
    assert set(r["checks"]) == {"env_voxels_outside_band", "obstacles_differ", "edt_voxels_differ",
                                "clearances_outside_band"}
    n = r["notes"]
    assert n["answered"] == r["attempted"] and n["obstacle_voxels"] > 1000
    assert n["clearance_min_m"] is not None and "last_answer_s" in n


def test_a_traced_run_reads_its_layers_and_the_programs_spans():
    r = run(0.5, trace=True, execute=spans.execute)
    assert r["correct"] and {"sense_ms.distance", "edt_ms.distance", "query_ms.distance"} <= set(r["metrics"])
    assert "breakdown" in r and r["device"]["window_s"] > 0
    table = r["notes"]["program_spans"]
    assert table["distance.envelope"]["count"] == 2 * table["distance.edt"]["count"] > 0
    assert table["distance.edt"]["median_ms"] >= table["distance.flood_z"]["median_ms"]
    assert table["distance.merge"]["count"] == table["distance.query"]["count"] == table["distance.edt"]["count"]
    assert r["notes"]["program_slice"]["ranges_match_records"]


def _drop_one(self, prob_map, occupancy_threshold=0.5):
    out = merge(self, prob_map, occupancy_threshold)
    i = torch.nonzero(edt.squared_distance_grid(out.data, out.dims).reshape(-1) == 0)[0]
    return replace(out, data=out.data.index_fill(0, i, PBA_UNINITIALISED_PACKED))


def _one_farther(self):
    d2 = squared(self)
    return d2.reshape(-1).index_add(0, torch.tensor([d2.numel() // 2]), torch.ones(1, dtype=d2.dtype)).view_as(d2)


def _flat_jfa(self, *args):
    return replace(self, data=edt.jump_flood(self.data, self.dims, converge=False))


merge, squared = DistanceVoxelMap.merge_occupied, DistanceVoxelMap.squared_distances


@pytest.mark.parametrize("fault, attr, planted, check", [
    ("one obstacle dropped", "merge_occupied", _drop_one, "obstacles_differ"),
    ("one squared distance + 1", "squared_distances", _one_farther, "edt_voxels_differ"),
    ("the flat JFA, no repair", "parallel_banding", _flat_jfa, "edt_voxels_differ"),
    ("the control", None, None, "env_voxels_outside_band"),
])
def test_faults_and_the_control_are_refused(fault, attr, planted, check, monkeypatch):
    if attr:
        monkeypatch.setattr(DistanceVoxelMap, attr, planted)
    r = run(0.2, control=attr is None)
    assert not r["correct"] and r["checks"][check]["value"] > 0, (fault, r["checks"])


def test_a_clearance_one_voxel_farther_is_refused(monkeypatch):
    query = DistanceVoxelMap.min_distance_to
    monkeypatch.setattr(DistanceVoxelMap, "min_distance_to", lambda self, p: query(self, p) + self.side_length)
    r = run(0.2)
    assert not r["correct"] and r["checks"]["clearances_outside_band"]["value"] > 0
