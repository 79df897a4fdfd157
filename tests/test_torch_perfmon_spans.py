"""The port's program spans (utils/perfmon: span, request, enable_spans,
drain_spans, self_ms) and the sites that carry them: off they cost one
shared no-op and record nothing; on they nest, carry request ids, close on
exceptions, and under torch.profiler lie as "gv." ranges in the order and
nesting of the buffer. Also the monitor's series read, which inserts no
empty series."""
import json
import time
import types

import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.planning import GvlValidityChecker, JointSpace, MotionValidator, RRTConnect
from gpu_voxels_tpu_torch.robot import presets
from gpu_voxels_tpu_torch.sensors import Sensor
from gpu_voxels_tpu_torch.utils import perfmon
from gpu_voxels_tpu_torch.utils.perfmon import PerformanceMonitor

DIMS = (16, 16, 12)
SIDE = 0.25
BASE = torch.tensor([2.0, 2.0, 0.0])


@pytest.fixture(autouse=True)
def spans_off():
    perfmon.enable_spans(False, False)
    perfmon.drain_spans()
    yield
    perfmon.enable_spans(False, False)
    perfmon.drain_spans()


def names(records):
    return [r[0] for r in records]


def _scene():
    """A 16x16x12 map at 0.25 m holding a box, a 32x24 frame of a flat wall
    from a camera at (2, 2, 1.5), the UR10 (coarse clouds) at (2, 2, 0)."""
    env = ProbVoxelMap.create(DIMS, SIDE, device="cpu")
    box = np.stack(np.meshgrid(np.arange(2.6, 3.4, 0.1), np.arange(0.6, 1.4, 0.1), np.arange(0.1, 1.5, 0.1),
                               indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    env = env.insert_point_cloud(box)
    sensor = Sensor(position=np.asarray([2.0, 2.0, 1.5], np.float32),
                    orientation_rpy=np.asarray([-1.6, 0.0, 0.0], np.float32),
                    data_width=32, data_height=24, fx=26.0, fy=26.0, cx=15.5, cy=11.5)
    frame = np.full((24, 32), 1.5, np.float32)
    arm = presets.ur_robot("ur10", spacing=0.1, device="cpu")

    class Placed:  # the six joints at the base, tool0 fixed
        def transformed_clouds_for(self, cfg):
            full = torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1)
            return types.SimpleNamespace(points=arm.transformed_clouds_for(full).points + BASE)

    return env, sensor, frame, arm, Placed()


def _exercise():
    """One pass over every instrumented site."""
    env, sensor, frame, arm, placed = _scene()
    env = env.insert_depth_image(frame, sensor)
    pts = arm.transformed_clouds_for(np.zeros(7, np.float32)).points + BASE
    robot = BitVectorVoxelMap.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts)
    robot.collide_with(env, 0.7)
    env.collide_with(robot, 0.7)
    _distance(env, pts)
    checker = GvlValidityChecker(env, placed, 0.7, 0)
    validator = MotionValidator(checker, resolution=0.2)
    validator.check_motion(np.zeros(6, np.float32), np.full(6, 0.5, np.float32))
    checker.colliding_voxels(np.zeros(6, np.float32))
    space = JointSpace(np.full(6, -0.5, np.float32), np.full(6, 0.5, np.float32))
    RRTConnect(space, validator, step=0.5, seed=1).solve(np.zeros(6, np.float32), np.full(6, 0.3, np.float32),
                                                        max_iters=5)


def _distance(env, points):
    """The distance path: the map's occupied voxels as obstacles, the exact
    EDT, a clearance query."""
    dm = DistanceVoxelMap.create(DIMS, SIDE, device="cpu").merge_occupied(env, 0.7).parallel_banding()
    return dm.min_distance_to(points)


def test_off_is_one_shared_noop_that_reads_no_clock(monkeypatch):
    assert perfmon.span("a") is perfmon.span("b") is perfmon.request(7)

    def refuse(*a, **k):
        raise AssertionError("a clock read or a profiler range with spans off")

    monkeypatch.setattr(perfmon.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _exercise()
    monkeypatch.undo()
    assert perfmon.drain_spans() == []


def test_parents_requests_self_time_and_exceptions():
    perfmon.enable_spans(True, False)
    with perfmon.request(4):
        with perfmon.span("outer"):
            with perfmon.span("inner"):
                time.sleep(0.002)
            with pytest.raises(ValueError):
                with perfmon.span("fails"):
                    raise ValueError("closes all the same")
    with perfmon.request(5), perfmon.span("next"):
        pass
    with perfmon.span("loose"):
        pass
    recs = perfmon.drain_spans()
    assert names(recs) == ["outer", "inner", "fails", "next", "loose"]
    assert [r[3] for r in recs] == [-1, 0, 0, -1, -1]
    assert [r[4] for r in recs] == [4, 4, 4, 5, None]
    assert all(r[2] >= r[1] for r in recs)
    own = perfmon.self_ms(recs)
    whole = (recs[0][2] - recs[0][1]) / 1e6
    assert recs[1][2] - recs[1][1] >= 2e6 and own[1] == (recs[1][2] - recs[1][1]) / 1e6
    assert own[0] == pytest.approx(whole - (recs[1][2] - recs[1][1] + recs[2][2] - recs[2][1]) / 1e6)
    assert 0 <= own[0] < whole
    assert perfmon.drain_spans() == []


def test_a_span_open_at_the_drain_is_left_out():
    perfmon.enable_spans(True, False)
    with perfmon.span("open"):
        with perfmon.span("closed"):
            pass
        first = perfmon.drain_spans()
        with perfmon.span("after"):
            pass
    assert names(first) == ["closed"] and first[0][3] == -1
    assert names(perfmon.drain_spans()) == ["after"]


def test_annotated_spans_lie_in_the_profiler_trace_in_order(tmp_path):
    perfmon.enable_spans(True, True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _exercise()
    recs = perfmon.drain_spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted(((float(e["ts"]), -float(e["dur"]), e["name"][3:]) for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith("gv.")))
    assert [n for _, _, n in ranges] == names(recs)
    spans = [(ts, ts - d) for ts, d, _ in ranges]
    for i, r in enumerate(recs):  # each range lies inside its parent's, as the buffer nests them
        if r[3] >= 0:
            (s, e), (ps, pe) = spans[i], spans[r[3]]
            assert ps <= s and e <= pe


@pytest.mark.parametrize("site, want", [
    ("insert_depth_image", ["sense", "sense.upload", "sense.hits", "sense.carve", "sense.update"]),
    ("transformed_clouds_for", ["robot.fk", "robot.chain"]),
    ("maps", ["maps.create", "maps.insert", "maps.collide", "maps.create", "maps.insert", "maps.collide"]),
    ("check_motion", ["validity.check_motion", "validity.states", "validity.count", "robot.fk", "robot.chain",
                      "validity.gather", "validity.distinct", "validity.read"]),
    ("distance", ["distance.merge", "distance.edt", "distance.flood_z", "distance.envelope", "distance.envelope",
                  "distance.query"]),
    ("solve", ["plan.solve", "validity.count", "validity.read", "validity.count", "validity.read",
               "validity.check_motion"]),
])
def test_each_layer_emits_its_spans(site, want):
    env, sensor, frame, arm, placed = _scene()
    checker = GvlValidityChecker(env, placed, 0.7, 0)
    validator = MotionValidator(checker, resolution=0.2)
    perfmon.enable_spans(True, False)
    if site == "insert_depth_image":
        env.insert_depth_image(frame, sensor)
    elif site == "transformed_clouds_for":
        arm.transformed_clouds_for(np.zeros((2, 7), np.float32))
    elif site == "maps":
        pts = torch.tensor([[1.1, 1.1, 1.1], [2.1, 1.1, 0.6]])
        ProbVoxelMap.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts).collide_with(env, 0.7)
        BitVectorVoxelMap.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts).collide_with(env, 0.7)
    elif site == "distance":
        _distance(env, torch.tensor([[1.1, 1.1, 1.1], [2.1, 1.1, 0.6]]))
    elif site == "check_motion":
        validator.check_motion(np.zeros(6, np.float32), np.full(6, 0.5, np.float32))
    else:
        space = JointSpace(np.full(6, -0.5, np.float32), np.full(6, 0.5, np.float32))
        RRTConnect(space, validator, step=0.5, seed=1).solve(np.zeros(6, np.float32),
                                                            np.full(6, 0.3, np.float32), max_iters=5)
    recs = perfmon.drain_spans()
    got = names(recs)
    if site == "solve":  # the endpoints' checks, then the first motion check; the solve holds them all
        got = [n for n in got if not n.startswith(("robot.", "validity.states", "validity.gather",
                                                   "validity.distinct"))][: len(want)]
        assert all(r[3] >= 0 for r in recs[1:]) and recs[0][3] == -1
    assert got == want


def test_the_distance_spans_nest_as_named():
    """flood_z and both envelope passes inside distance.edt; merge and the
    query beside it; the query's answer is the untraced one."""
    env = _scene()[0]
    pts = torch.tensor([[1.1, 1.1, 1.1], [2.1, 1.1, 0.6]])
    want = _distance(env, pts)
    perfmon.enable_spans(True, False)
    got = _distance(env, pts)
    recs = perfmon.drain_spans()
    assert float(got) == float(want) > 0
    edt = names(recs).index("distance.edt")
    assert [(r[0], r[3]) for r in recs] == [
        ("distance.merge", -1), ("distance.edt", -1), ("distance.flood_z", edt), ("distance.envelope", edt),
        ("distance.envelope", edt), ("distance.query", -1)]


def test_series_of_a_missing_key_inserts_nothing():
    pm = PerformanceMonitor()
    pm.enable("p")
    pm.add_data("kept", 2.0, "p")
    assert pm.series("never", "p") == []
    assert "p::never" not in pm.data
    assert pm.summary("p").startswith("p::kept: n=1 avg=2.000")
