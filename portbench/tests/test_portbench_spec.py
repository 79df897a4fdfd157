"""BENCHMARK.json against the benchmark's contract, and the harness
finding configurations, traffic mixes and metrics by name, also ones a
later change adds as new files and entries only."""
import json
import re
import shutil

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and spec["command"] == ["python3", "portbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len(json.dumps(spec)) < 64 * 1024
    for group, keys in KEYS.items():
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))
        for e in spec[group]:
            assert set(e) - {"workloads"} == keys if group in ("end_to_end", "per_layer") else set(e) == keys
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                if k in e:
                    assert line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    cells = {w["name"]: w for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace") for m in e2e.values())
    for w in cells.values():
        assert w["chips"] == 1 and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert [m for m in e2e.values() if m["name"] != "setup_s" and w["name"] in m.get("workloads", [w["name"]])]
        assert harness.cell_metrics(spec, w["name"], True), w["name"]
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells and c in e2e[m["moves"]].get("workloads", [c])
    assert {c["name"] for c in spec["configs"]} == {w["config"] for w in cells.values()}


def test_configs_traffic_and_metrics_are_found_by_name(spec):
    for w in spec["workloads"]:
        cfg = harness.load_config(spec, w["config"])
        assert cfg["name"] == w["config"] and cfg["reduced"] == []
        traffic = harness.load_traffic(w["traffic"])
        assert harness.loops.loop_module(traffic["loop"]).run
        for trace in (False, True):
            for m in harness.cell_metrics(spec, w["name"], trace):
                assert callable(harness.reader(m["name"]))
    assert [m["name"] for m in harness.cell_metrics(spec, "plan.rrt_connect", False)] == [
        "motion_checks_per_s", "setup_s"]
    assert {m["name"] for m in harness.cell_metrics(spec, "monitor.kinect30", True)} == {
        "sense_ms.monitor", "k3_roofline_pct.monitor", "fk_ms.monitor", "collide_ms.monitor",
        "device_idle_pct.monitor"}
    with pytest.raises(SystemExit):
        harness.find_cell(spec, "no.such.cell")


def test_a_new_config_cell_and_metric_need_only_new_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by new files and new entries: the harness runs the
    new cell and reads the new metric with no file it had edited."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "ur10_ompl_workcell_150")
    cfg.update(name="ur10_workcell_small", map={"dims": [100, 100, 80], "side_m": 0.03})
    (tmp_path / "portbench/configs/ur10_workcell_small.json").write_text(json.dumps(cfg))
    traffic = harness.load_traffic("rrt_connect")
    traffic.update(step_rad=0.5, max_iters=200)
    (tmp_path / "portbench/traffic/rrt_short.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/checks_per_step.small.py").write_text(
        "def read(ctx):\n    return ctx.window.done / ctx.traffic['step_rad']\n")
    spec["configs"].append({"name": "ur10_workcell_small", "source": "https://example.org/x",
                            "file": "portbench/configs/ur10_workcell_small.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "plan.small", "config": "ur10_workcell_small", "traffic": "rrt_short",
                              "chips": 1, "why": "a test"})
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    e2e["motion_checks_per_s"]["workloads"].append("plan.small")
    spec["per_layer"].append({"name": "checks_per_step.small", "unit": "checks/rad", "better": "higher",
                              "source": "program_counter", "layer": "planning", "moves": "motion_checks_per_s",
                              "workloads": ["plan.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    import torch

    result = harness.execute("plan.small", 5, 0.3, True, torch.device("cpu"), 0.0, root=tmp_path)
    assert result["correct"] and result["metrics"]["checks_per_step.small"]["value"] >= 1
    assert [m["name"] for m in harness.cell_metrics(harness.load_spec(tmp_path), "plan.small", True)] == [
        "checks_per_step.small"]
