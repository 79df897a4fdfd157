"""Whole runs on the CPU at small sizes, past the harness's look for a
card: sound runs come out correct; runs with the timed path broken
underneath, and the control (the reference in TF32 in the program's
place), come out not correct; no run loads JAX or the JAX package."""
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.planning import GvlValidityChecker, MotionValidator
from portbench import harness

CPU = torch.device("cpu")
SEED = 2**31 + 12345  # past 32 signed bits


def run(cell, seconds, small_monitor=None, control=False, seed=SEED, trace=False):
    """A run of `cell`; the monitor's frames made small."""
    spec = harness.load_spec()
    w = harness.find_cell(spec, cell)
    cfg, traffic = harness.load_config(spec, w["config"]), harness.load_traffic(w["traffic"])
    if small_monitor is not None:
        cfg, traffic = small_monitor(cfg, traffic)
    return harness.execute(cell, seed, seconds, trace, CPU, 0.0, control=control, cfg=cfg, traffic=traffic)


def test_monitor_runs_correct_and_reports_its_metrics(small_monitor):
    r = run("monitor.kinect30", 0.4, small_monitor)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 10
    assert set(r["metrics"]) == {"update_p95_ms", "setup_s"}
    assert set(r["checks"]) == {"counts_outside_band", "env_voxels_outside_band", "robot_voxels_outside_band"}
    assert r["notes"]["updates_colliding"] > 0 and r["notes"]["env_voxels_occupied"] > 1000


def test_traced_monitor_reads_its_layers(small_monitor):
    r = run("monitor.kinect30", 0.6, small_monitor, trace=True)
    assert r["correct"] and {"sense_ms.monitor", "fk_ms.monitor", "collide_ms.monitor"} <= set(r["metrics"])
    assert "breakdown" in r and r["device"]["window_s"] > 0


def test_the_planner_runs_correct():
    r = run("plan.rrt_connect", 0.5)
    assert r["correct"] and r["attempted"] > 0 and set(r["metrics"]) == {"motion_checks_per_s", "setup_s"}


@pytest.mark.parametrize("cell", ["monitor.kinect30", "plan.rrt_connect"])
def test_the_control_is_refused(cell, small_monitor):
    r = run(cell, 0.5, small_monitor if cell.startswith("monitor") else None, control=True)
    assert not r["correct"], r["checks"]


def test_a_state_returned_unchanged_is_refused(monkeypatch, small_monitor):
    monkeypatch.setattr(ProbVoxelMap, "insert_depth_image", lambda self, *a, **k: self)
    r = run("monitor.kinect30", 0.3, small_monitor)
    assert not r["correct"] and r["checks"]["env_voxels_outside_band"]["value"] > 0


def test_an_altered_count_is_refused(monkeypatch, small_monitor):
    collide = BitVectorVoxelMap.collide_with
    monkeypatch.setattr(BitVectorVoxelMap, "collide_with", lambda self, *a, **k: collide(self, *a, **k) + 1)
    r = run("monitor.kinect30", 0.2, small_monitor)
    assert not r["correct"] and r["checks"]["counts_outside_band"]["value"] > 0


def test_half_the_batch_left_out_is_refused(monkeypatch):
    """The checker validates the first half of each motion check's states
    and gives its counts for the second half too."""
    counts = GvlValidityChecker.batch_colliding_voxels

    def half(self, cfgs):
        c = counts(self, np.asarray(cfgs)[: (len(cfgs) + 1) // 2])
        return np.concatenate([c, c])[: len(cfgs)]

    monkeypatch.setattr(GvlValidityChecker, "batch_colliding_voxels", half)
    r = run("plan.rrt_connect", 0.5)
    assert not r["correct"] and r["checks"]["counts_outside_band"]["value"] > 0


def test_an_altered_motion_answer_is_refused(monkeypatch):
    check = MotionValidator.check_motion
    monkeypatch.setattr(MotionValidator, "check_motion", lambda self, a, b: (True, check(self, a, b)[1]))
    r = run("plan.rrt_connect", 0.5)
    assert not r["correct"] and r["checks"]["answers_wrong"]["value"] > 0


def test_forbidden_modules_compare_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpu_voxels_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpu_voxels_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["gpu_voxels_tpu", "jax"]


def test_a_run_loads_no_jax():
    code = ("import sys, torch; sys.path.insert(0, '.'); from portbench import harness;"
            "r = harness.execute('plan.rrt_connect', 3, 0.2, False, torch.device('cpu'), 0.0);"
            "print(r['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert out.stdout.split() == ["True", "[]"], out.stderr[-2000:]


def test_without_a_card_run_py_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "plan.rrt_connect", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
