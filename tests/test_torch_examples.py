"""Port conformance of the example programs (gpu_voxels_tpu_torch/examples/)
whose reference runs are cheap, and of the live loop's frame.

Each port program runs with `main(device="cpu")` and must return what the
reference program (examples/, imported as tests/test_examples.py imports
it) returns: integers exactly, the distance demo's float clearance to 1e-6
relative (both are the square root of the same exact integer EDT distance,
times the side). tests/test_examples.py's own assertions hold on the port's
return too. Where a program returns only a flag, the library calls it makes
are kept in both packages and compared as well (ompl_planning_demo's pose
and motion checks). The costly programs are held against the reference's library
calls in test_torch_examples_costly.py.

`robot_vs_environment.frame_step` is replayed over 3 fixed 64x48 frames and
joint values, beside the example's base and at the box's depth (where the
robot collides), against the reference's insert_depth_image (its eager
op: F4) -> FK -> insert -> collide_with calls on the same inputs; every FK
point keeps 1e-3 voxel from a cell boundary (H4).
"""
import importlib
import sys
from dataclasses import replace
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
sys.path.insert(0, str(EXAMPLES))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: beside the other busy test processes its thread
    barriers cost far more than they save on these small grids."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_facades():
    """Both packages' GpuVoxels singletons start empty for each program
    (several examples add maps of fixed names to it) and are put back
    afterwards, so another test file in the same process sees what it
    left."""
    from gpu_voxels_tpu.api import GpuVoxels as JGvl
    from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl

    before = JGvl._instance, TGvl._instance
    JGvl._instance = TGvl._instance = None
    try:
        yield
    finally:
        JGvl._instance, TGvl._instance = before


def port(name):
    return importlib.import_module(f"gpu_voxels_tpu_torch.examples.{name}")


def reference(name):
    return importlib.import_module(name)


def equal_and(check):
    def compare(got, want):
        assert got == want
        assert check(got)
    return compare


def close_clearance(got, want):
    assert got is not None and got >= 0.0
    assert got == pytest.approx(want, rel=1e-6)


def live_loop(got, want):
    # the frames the loop gets depend on the host's timing (latest wins);
    # in this scene the robot never reaches the box, so every count is 0
    for out in (got, want):
        assert out["processed"] >= 5 and len(out["counts"]) >= 1
    assert set(got["counts"]) == set(want["counts"]) == {0}


CHEAP = {
    "collisions": equal_and(lambda v: v > 0),
    "counting_voxel_list": equal_and(lambda v: v >= 1),
    "shift_vs_transform": equal_and(lambda v: v > 0),
    "urdf_loader": equal_and(lambda v: v["mesh_points"] == 252 and v["total_collisions"] > 0),
    "heightmap_demo": equal_and(lambda v: v > 0),
    "primitive_array_test": equal_and(lambda v: v == 10),
    "ompl_planning_demo": equal_and(lambda v: v is True),
    "distance_kinect_demo": close_clearance,
    "octree_bench": equal_and(lambda v: v >= 0),
    "batch_worlds_demo": equal_and(lambda v: v >= 1),
    "tf_interface_demo": equal_and(lambda v: v > 0),
    "robot_vs_environment": live_loop,
}


def planner_calls(got, want):
    """ompl_planning_demo's pose checks (blocked, clear), its two motion
    checks (valid, states) and each motion's per-state counts equal the
    reference's (whose batch is padded to a bucket: its first n states)."""
    assert [int(v) for v in got["colliding_voxels"]] == [int(v) for v in want["colliding_voxels"]]
    motions = [(bool(v), int(n)) for v, n in got["check_motion"]]
    assert motions == [(bool(v), int(n)) for v, n in want["check_motion"]] and [v for v, _ in motions] == [False, True]
    assert len(got["batch_colliding_voxels"]) == len(want["batch_colliding_voxels"]) == 2
    for counts, ref_counts, (_, n) in zip(got["batch_colliding_voxels"], want["batch_colliding_voxels"], motions):
        np.testing.assert_array_equal(np.asarray(counts), np.asarray(ref_counts)[:n])
    assert int(np.asarray(got["batch_colliding_voxels"][0]).max()) > 0


# the library methods whose results a program's comparison also holds,
# kept in both packages by wrapping them: (module, ((class, method), ...), check)
INNER = {
    "ompl_planning_demo": ("planning.validity", (("GvlValidityChecker", "colliding_voxels"),
                                                 ("GvlValidityChecker", "batch_colliding_voxels"),
                                                 ("MotionValidator", "check_motion")), planner_calls),
}


def keep_inner(monkeypatch, package: str, name: str) -> dict:
    """Wrap the methods INNER names for `name` in `package`; their results,
    by method name, in call order."""
    kept = {}
    module, methods, _ = INNER.get(name, (None, (), None))
    for cls_name, attr in methods:
        cls = getattr(importlib.import_module(f"{package}.{module}"), cls_name)

        def keeping(*args, _real=getattr(cls, attr), _attr=attr, **kwargs):
            out = _real(*args, **kwargs)
            kept.setdefault(_attr, []).append(out)
            return out
        monkeypatch.setattr(cls, attr, keeping)
    return kept


@pytest.mark.parametrize("name", sorted(CHEAP))
def test_example_returns_the_reference_answer(name, monkeypatch):
    got_inner = keep_inner(monkeypatch, "gpu_voxels_tpu_torch", name)
    want_inner = keep_inner(monkeypatch, "gpu_voxels_tpu", name)
    got = port(name).main(device="cpu")
    want = reference(name).main()
    CHEAP[name](got, want)
    if name in INNER:
        INNER[name][2](got_inner, want_inner)


def test_example_modules_import_only_the_port():
    """Every reference program has its port, whose source names neither jax
    nor the reference package."""
    import gpu_voxels_tpu_torch.examples as pkg

    ported = sorted(p.stem for p in Path(pkg.__file__).parent.glob("*.py") if p.stem != "__init__")
    assert ported == sorted(p.stem for p in EXAMPLES.glob("*.py"))
    for name in ported:
        src = (Path(pkg.__file__).parent / f"{name}.py").read_text()
        assert "jax" not in src and "gpu_voxels_tpu." not in src and "import gpu_voxels_tpu\n" not in src, name


# -- the live loop's frame, replayed ---------------------------------------------
REPLAY_JOINTS = np.array([[2.9, 0.3], [3.0, -0.2], [3.05, 0.1]], np.float32)


def test_frame_step_replays_the_reference_calls():
    from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
    from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
    from gpu_voxels_tpu.ops import raycast as jrc
    from gpu_voxels_tpu.sensors import Sensor as JSensor
    from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap

    ex, ref = port("robot_vs_environment"), reference("robot_vs_environment")
    cpu = torch.device("cpu")
    dims, side, sensor, _, _ = ex.scene(cpu)
    assert dims == (64, 64, 64) and (sensor.data_width, sensor.data_height) == (64, 48)
    jsensor = JSensor(position=sensor.position, data_width=64, data_height=48, fx=sensor.fx, fy=sensor.fy,
                      cx=sensor.cx, cy=sensor.cy)
    frames = ex.make_frames(sensor, n=3, device=cpu)
    np.testing.assert_array_equal(np.stack([f.numpy() for f in frames]),
                                  np.stack([np.asarray(f) for f in ref.make_frames(jsensor, n=3)]))
    intr = (sensor.fx, sensor.fy, sensor.cx, sensor.cy)
    extent = dims[0] * side
    robot, jrobot = ex.make_robot(0.45 * extent, device=cpu), ref.make_robot(0.45 * extent)
    # a quarter voxel off the example's base (its first link lies on cell
    # boundaries there), then in the box's face (2.5 m from the camera), the
    # first link along a row the frames make occupied
    bases = (np.full(3, extent / 2 + side / 4, np.float32), np.array([0.8125, 2.0625, 2.5625], np.float32))
    counts = []
    for base in bases:
        env, jenv = ProbVoxelMap.create(dims, side, device=cpu), JProb.create(dims, side)
        for depth, joints in zip(frames, REPLAY_JOINTS):
            pts = robot.transformed_clouds_for(torch.from_numpy(joints)).points + torch.from_numpy(base)
            f = pts.double() / side
            assert ((f - torch.round(f)).abs() >= 1e-3).all(), "an FK point lies within 1e-3 voxel of a boundary"
            env, rob, cnt = ex.frame_step(env, depth, torch.from_numpy(joints), sensor, robot,
                                          torch.from_numpy(base), dims, side)
            # the reference's eager depth insert: compiled, XLA re-rounds its
            # projection and can move a voxel at a pixel edge (F4)
            jenv = replace(jenv, data=jrc.insert_depth_image(jenv.data, jnp.asarray(depth.numpy()),
                                                             jnp.asarray(jsensor.pose()), *intr, side, dims))
            jrob = JBit.create(dims, side).insert_point_cloud(
                jrobot.transformed_clouds_for(jnp.asarray(joints)).points + jnp.asarray(base))
            jcnt = jrob.collide_with(jenv, 0.7)
            np.testing.assert_array_equal(env.data.numpy(), np.asarray(jenv.data))
            np.testing.assert_array_equal(rob.data.numpy().view(np.uint32), np.asarray(jrob.data))
            assert isinstance(cnt, torch.Tensor) and cnt.ndim == 0
            assert int(cnt) == int(jcnt)
            counts.append(int(cnt))
    assert counts[:3] == [0, 0, 0] and max(counts[3:]) > 0, counts


@pytest.mark.parametrize("solution", [1, 2])
def test_to_rpy_np_matches_the_reference(solution):
    """tf_interface_demo's toRPY (geometry.transforms.to_rpy_np) equals the
    reference's `to_rpy(..., xp=np)` bit for bit: random rotations, batched
    and one at a time, and both gimbal-lock branches."""
    from gpu_voxels_tpu.geometry import transforms as jtf
    from gpu_voxels_tpu_torch.geometry import transforms as ttf

    rng = np.random.default_rng(11)
    rpy = rng.uniform(-3.0, 3.0, (64, 3)).astype(np.float32)
    rpy[:2, 1] = (np.pi / 2, -np.pi / 2)  # pitch +-90 degrees: gimbal lock
    mats = ttf.from_rpy_np(rpy, rng.uniform(-1, 1, (64, 3)))
    got = ttf.to_rpy_np(mats, solution=solution)
    np.testing.assert_array_equal(got, jtf.to_rpy(mats, solution=solution, xp=np))
    np.testing.assert_array_equal(ttf.to_rpy_np(mats[5, :3, :3], solution=solution), got[5])
    assert (got[:2, 2] == 0).all()  # locked: yaw pinned to 0
