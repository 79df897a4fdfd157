"""The reference against the port at tiny sizes on the CPU, where the
port's kernels take their plain versions: the depth insert from a rotated
pose within its band (a 64x48 frame into 64x64x48) and the carve byte for
byte, the FK band holding the port's voxels and counts, the workcell map,
motion-check states. The reference imports
nothing of the program."""
import ast
from pathlib import Path

import numpy as np
import torch

from gpu_voxels_tpu_torch.planning import MotionValidator
from portbench import harness, inputs, system
from portbench.reference import geometry, sensing, workcell

def tiny_monitor():
    """The monitor's configuration with a 64x48 frame of the Kinect's field
    of view into 64x64x48 voxels of 0.05 m over the workcell: the camera's
    pose, rotated on every axis, as configured."""
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "ur10_kinect_workcell_150")
    cfg["map"] = {"dims": [64, 64, 48], "side_m": 0.05}
    cfg["sensor"].update(width=64, height=48, fx=52.5, fy=52.5, cx=31.5, cy=23.5)
    return cfg, harness.load_traffic("kinect30")["scene"]


def test_reference_imports_nothing_of_the_program():
    for path in Path(harness.BENCH_DIR, "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
            assert all(n.split(".")[0] in ("numpy", "torch", "__future__") for n in names), (path, names)


def test_depth_insert_lies_in_the_band_and_is_exact_outside_it():
    cfg, scene = tiny_monitor()
    m = system.Monitor(cfg, "cpu")
    side, dims = cfg["map"]["side_m"], cfg["map"]["dims"]
    lo = torch.full((64 * 64 * 48,), sensing.UNKNOWN, dtype=torch.int8)
    hi = lo.clone()
    for frame in inputs.depth_frames(cfg, scene, 6, 987654321012, "cpu"):
        m.sense(frame)
        lo, hi = sensing.fuse_band(lo, hi, torch.as_tensor(frame), cfg["sensor"], side, dims)
        env = m.env.data
        assert bool(((lo <= env) & (env <= hi)).all())
    assert int((lo != hi).sum()) < 0.01 * int((lo != sensing.UNKNOWN).sum())
    assert int((lo == 127).sum()) > 0 and int((lo == -127).sum()) > 0


def test_sensor_pose_and_exact_carve_equal_the_ports():
    from gpu_voxels_tpu_torch.geometry import transforms
    from gpu_voxels_tpu_torch.ops import raycast

    cfg, scene = tiny_monitor()
    s, side, dims = cfg["sensor"], cfg["map"]["side_m"], tuple(cfg["map"]["dims"])
    pose = transforms.from_rpy_np(s["rpy"], np.asarray(s["position_m"], np.float32))
    assert np.array_equal(sensing.pose(s), pose) and (pose[:3, :3] != 0).all()
    frame = torch.as_tensor(inputs.depth_frames(cfg, scene, 1, 3, "cpu")[0])
    want = raycast.projective_free_space(frame, torch.as_tensor(pose), s["fx"], s["fy"], s["cx"], s["cy"], side, dims)
    got = sensing.exact_carve(frame, s, side, dims)
    assert torch.equal(got, want) and int(got.sum()) > 1000


def test_depth_frames_see_the_workcell_and_move_with_the_seed():
    cfg, scene = tiny_monitor()
    a = inputs.depth_frames(cfg, scene, 3, 2**40 + 7, "cpu")
    b = inputs.depth_frames(cfg, scene, 3, 2**40 + 7, "cpu")
    c = inputs.depth_frames(cfg, scene, 3, 2**40 + 8, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and not np.array_equal(a[0], c[0])
    valid = a[0][a[0] > 0]
    assert 0.3 < valid.size / a[0].size < 0.95 and valid.min() >= 0.8 and valid.max() <= 4.0
    assert not np.array_equal(a[0], a[2])  # the box moves


def test_robot_voxels_and_counts_lie_in_the_band():
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "ur10_kinect_workcell_150")
    m = system.Monitor(cfg, "cpu")
    side, dims = cfg["map"]["side_m"], cfg["map"]["dims"]
    traj = inputs.trajectory(harness.load_traffic("kinect30")["trajectory"], 42)
    r = cfg["robot"]
    pts = geometry.fk_points(r, inputs.link_clouds(r), r["base_m"], traj[:4], "cpu")
    sure, cand = geometry.voxel_band(pts, side, dims)
    occupied = torch.zeros(150 * 150 * 100, dtype=torch.bool)
    occupied[cand[cand >= 0][::3]] = True  # a third of the robot's candidate voxels occupied
    for j in range(4):
        m.collide(m.place(traj[j]))
        got = m.outputs()["robot_voxels"]
        s_keys, u_keys = torch.unique(sure[j][sure[j] >= 0]), torch.unique(cand[j][cand[j] >= 0])
        assert torch.isin(s_keys, got).all() and torch.isin(got, u_keys).all()
        lo, hi = geometry.count_band(sure[j:j + 1], cand[j:j + 1], occupied)
        n = int(occupied[got].sum())
        assert 0 < int(lo) <= n <= int(hi)


def test_workcell_env_states_and_counts_match_the_port():
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "ur10_ompl_workcell_150")
    wc = system.Workcell(cfg, "cpu")
    env = workcell.env_map(cfg, "cpu")
    assert torch.equal(wc.checker.env.data, env)
    assert int((env == 127).sum()) == sum((x1 - x0) * (y1 - y0) * (z1 - z0) for (x0, x1), (y0, y1), (z0, z1)
                                          in workcell.box_voxels(cfg)) - 2 * 10 * 10  # two pillars stand on the floor
    v = MotionValidator(wc.checker, resolution=cfg["motion_resolution_rad"])
    a, b = np.array([-1.3, -0.2, 0, 0, 0, 0], np.float32), np.array([1.3, -0.5, 0, 0, 0, 0], np.float32)
    assert np.array_equal(v.segment_states(a, b), workcell.segment_states(a, b, cfg["motion_resolution_rad"]))
    states = inputs.uniform_states(cfg, 64, 11)
    got = wc.checker.batch_colliding_voxels(states)
    r = cfg["robot"]
    pts = geometry.fk_points(r, inputs.link_clouds(r), r["base_m"], states, "cpu")
    lo, hi = geometry.count_band(*geometry.voxel_band(pts, 0.02, cfg["map"]["dims"]),
                                 env.to(torch.int32) >= sensing.threshold(0.7))
    assert ((lo.numpy() <= got) & (got <= hi.numpy())).all() and (got > 0).sum() > 10


def test_tf32_emulation_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -3.0 - 2 ** -9, 0.0])
    assert geometry.emulated_tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0, -3.0 - 2 ** -9, 0.0]
