"""The program's spans in the benchmark's runs (portbench/spans.py, CPU):
a traced run of each cell reads the program-span metrics, the
`program_spans` note and a slice whose "gv." ranges match the drained
records; "gv." ranges in a trace leave every accepted reader and the
accepted idle gaps as they read without them; the idle gaps by program
span; and spans off again after a run."""
import pytest
import torch

from gpu_voxels_tpu_torch.utils import perfmon
from portbench import harness, loops, spans
from portbench.trace import Trace

CPU = torch.device("cpu")
SEED = 2**31 + 4321


def _cell(cell, small_monitor):
    spec = harness.load_spec()
    w = harness.find_cell(spec, cell)
    cfg, traffic = harness.load_config(spec, w["config"]), harness.load_traffic(w["traffic"])
    return small_monitor(cfg, traffic) if cell.startswith("monitor") else (cfg, traffic)


@pytest.mark.parametrize("cell, want", [
    ("monitor.kinect30", {"sense_upload_ms.monitor", "sense_hits_ms.monitor", "fk_chain_ms.monitor"}),
    ("plan.rrt_connect", {"fk_chain_ms.rrt", "read_wait_ms.rrt"}),
])
def test_a_traced_run_reads_the_program_spans(cell, want, small_monitor):
    cfg, traffic = _cell(cell, small_monitor)
    r = spans.execute(cell, SEED, 0.6, True, CPU, 0.0, cfg=cfg, traffic=traffic)
    assert r["correct"] and want <= set(r["metrics"])
    assert not {m for m in spans.METRICS if m.rsplit(".", 1)[1] != traffic["loop"]} & set(r["metrics"])
    table = r["notes"]["program_spans"]
    outer = "sense" if cell.startswith("monitor") else "validity.check_motion"
    assert table[outer]["count"] > 0 and table["robot.fk"]["median_ms"] >= table["robot.chain"]["median_ms"]
    assert all(0 <= v["self_median_ms"] <= v["median_ms"] for v in table.values())
    sl = r["notes"]["program_slice"]
    assert sl["records"] > 0 and sl["ranges_match_records"]
    assert r["breakdown"]["idle_gaps_program"]
    assert perfmon.span("a") is perfmon.span("b") and perfmon.drain_spans() == []


def test_an_untraced_run_records_the_window(small_monitor):
    cfg, traffic = _cell("plan.rrt_connect", small_monitor)
    r = spans.execute("plan.rrt_connect", SEED, 0.4, False, CPU, 0.0, cfg=cfg, traffic=traffic)
    assert r["correct"] and {"motion_checks_per_s", "read_wait_ms.rrt"} <= set(r["metrics"])
    assert "breakdown" not in r and "program_slice" not in r["notes"]
    assert perfmon.span("a") is perfmon.span("b")


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _launch(ts):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1)


BENCH = [  # a slice of two updates and two checks: the benchmark's ranges, launches and device work
    _x("user_annotation", "pb.slice", 0, 200),
    _x("user_annotation", "pb.update", 10, 60), _x("user_annotation", "pb.sense", 10, 30),
    _x("user_annotation", "pb.fk", 40, 20), _x("user_annotation", "pb.collide", 60, 10),
    _x("user_annotation", "pb.check", 100, 40), _x("user_annotation", "pb.check", 145, 35),
    _launch(12), _launch(20), _launch(45), _launch(50), _launch(105), _launch(120), _launch(160),
    _x("kernel", "carve_exact_kernel", 22, 4), _x("kernel", "index_add", 30, 6),
    _x("kernel", "gemv", 52, 3), _x("kernel", "sort", 122, 8), _x("gpu_memcpy", "Memcpy DtoH", 136, 2),
    _x("kernel", "sort", 162, 8),
]
PROGRAM = [  # the program's ranges inside them
    _x("user_annotation", "gv.sense", 10.5, 28.5), _x("user_annotation", "gv.sense.hits", 12, 12),
    _x("user_annotation", "gv.sense.carve", 24, 6), _x("user_annotation", "gv.robot.fk", 41, 18),
    _x("user_annotation", "gv.robot.chain", 41, 12), _x("user_annotation", "gv.validity.check_motion", 101, 38),
    _x("user_annotation", "gv.robot.fk", 102, 20), _x("user_annotation", "gv.validity.read", 130, 9),
    _x("user_annotation", "gv.validity.check_motion", 151, 28), _x("user_annotation", "gv.robot.fk", 152, 9),
]


def test_program_ranges_leave_the_accepted_readers_as_they_were():
    plain, both = Trace.from_events(BENCH), Trace.from_events(BENCH + PROGRAM)
    assert both.spans == plain.spans and both.launches == plain.launches and both.device_ops == plain.device_ops
    assert both.idle_by_span() == plain.idle_by_span() and both.top_ops() == plain.top_ops()
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "ur10_kinect_workcell_150")
    win = loops.Window(1.0, 1.0, 2, 0, 2, [5.0, 6.0], {"sense": [1.0], "fk": [2.0], "collide": [3.0],
                                                        "check": [4.0], "planner_host_per_check": [0.5]})
    read = 0
    for m in spec["per_layer"]:
        f = harness.reader(m["name"])
        got, want = f(harness.Context(win, both, cfg, {})), f(harness.Context(win, plain, cfg, {}))
        assert got == want, m["name"]
        read += want is not None
    assert read == len(spec["per_layer"])


def test_idle_gaps_by_program_span():
    t = Trace.from_events(BENCH + PROGRAM)
    gaps, share = spans.idle_by_program_span(t, spans.program_ranges(PROGRAM))
    got = {n: round(v * 1e6, 6) for n, v in gaps}
    # the busy intervals 22-26, 30-36, 52-55, 122-130, 136-138, 162-170 leave
    # gaps whose midpoints fall: 0-22 (11: gv.sense), 26-30 (28: sense.carve),
    # 36-52 (44: robot.chain), 55-122 (88.5: outside), 130-136 (133:
    # validity.read), 138-162 (150: pb.check), 170-200 (185: outside)
    assert got == {"sense": 22.0, "sense.carve": 4.0, "robot.chain": 16.0, "outside spans": 97.0,
                   "validity.read": 6.0, "pb.check": 24.0}
    assert share == pytest.approx(100 * (22 + 4 + 16 + 6) / (22 + 4 + 16 + 6 + 24))
    assert spans.launches_per_range(t, spans.program_ranges(PROGRAM), "robot.fk") == pytest.approx(5 / 3)
    assert spans.launches_per_range(t, spans.program_ranges(PROGRAM), "sense") == 2.0
    assert spans.launches_per_range(None, [], "sense") is None
