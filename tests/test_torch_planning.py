"""Port conformance of planning/: the validity checker, the motion
validator, RRT-Connect and the path simplifier.

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch on the CPU. On tests/test_planning.py's wall world (a
point robot: no forward kinematics, so no ulp differences) the planner must
replay the reference's tree exactly for the same seed: the same path, the
same iteration, motion-check and state counts, the same simplified path.
With the UR10, forward kinematics differs between the frameworks by ulps
(F4): the states compared keep every point at least 1e-3 voxel from a cell
boundary, asserted, and the per-state counts are compared exactly.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.planning import GvlValidityChecker as JChecker
from gpu_voxels_tpu.planning import JointSpace as JSpace
from gpu_voxels_tpu.planning import MotionValidator as JMotion
from gpu_voxels_tpu.planning import Path as JPath
from gpu_voxels_tpu.planning import PathSimplifier as JSimplifier
from gpu_voxels_tpu.planning import RRTConnect as JRRT
from gpu_voxels_tpu.robot import presets as jpresets
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.planning import GvlValidityChecker, HierarchicalValidityChecker, JointSpace, MotionValidator
from gpu_voxels_tpu_torch.planning import Path, PathSimplifier, RRTConnect
from gpu_voxels_tpu_torch.robot import presets as tpresets


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


class _Cloud:
    def __init__(self, points):
        self.points = points


class JPointRobot:
    """cfg IS the end effector: one point at cfg (the reference's test robot)."""

    def transformed_clouds_for(self, cfg):
        return _Cloud(jnp.asarray(cfg, jnp.float32)[None, :])


class TPointRobot:
    """The same for a [3] or [T, 3] tensor of configurations."""

    def transformed_clouds_for(self, cfg):
        return _Cloud(cfg[..., None, :])


START = np.array([2.5, 8.5, 8.5], np.float32)
GOAL = np.array([14.5, 8.5, 8.5], np.float32)


def _wall_world(hole=True):
    """16^3 at 1 m: a y/z wall at x = 8 with a 2x2 hole at low y and z
    (tests/test_planning.py); the port's map is the reference's, copied."""
    ys, zs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    pts = np.stack([np.full(ys.size, 8.5), ys.ravel() + 0.5, zs.ravel() + 0.5], axis=1).astype(np.float32)
    keep = ~((pts[:, 1] < 3.0) & (pts[:, 2] < 3.0)) if hole else np.ones(len(pts), bool)
    jenv = JProb.create((16, 16, 16), 1.0).insert_point_cloud(pts[keep])
    tenv = interop.prob_map_from_numpy(np.asarray(jenv.data), (16, 16, 16), 1.0, device="cpu")
    space = (np.zeros(3, np.float32), np.full(3, 16.0, np.float32))
    j = JChecker(jenv, JPointRobot(), 0.7)
    t = GvlValidityChecker(tenv, TPointRobot(), 0.7)
    return (JSpace(*space), j, JMotion(j, resolution=0.5)), (JointSpace(*space), t, MotionValidator(t, resolution=0.5))


def test_point_robot_counts_single_and_batch():
    (_, jc, jm), (_, tc, tm) = _wall_world()
    rng = np.random.default_rng(0)
    states = rng.uniform(0.0, 16.0, (200, 3)).astype(np.float32)
    states[:20, 0] = 8.5  # in the wall
    states[20:25] = [[-1.0, 2.0, 2.0], [16.5, 3.0, 3.0], [8.5, 1.5, 1.5], [8.5, 15.5, 15.5], [8.2, 2.9, 3.1]]
    got, want = tc.batch_colliding_voxels(states), np.asarray(jc.batch_colliding_voxels(states))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int64 and 0 < got.sum() < len(states)
    for s in states[:30]:
        assert tc.colliding_voxels(s) == int(jc.colliding_voxels(jnp.asarray(s)))
        assert tc.is_valid(s) == jc.is_valid(jnp.asarray(s))
    assert tc.host_reads == 1 + 60


def test_check_motion_matches_reference():
    (_, _, jm), (_, _, tm) = _wall_world()
    rng = np.random.default_rng(1)
    segments = [(START, GOAL), (START, START), (np.array([2.5, 1.5, 1.5], np.float32), np.array([14.5, 1.5, 1.5],
                                                                                                np.float32))]
    segments += [tuple(rng.uniform(0.0, 16.0, (2, 3)).astype(np.float32)) for _ in range(12)]
    for a, b in segments:
        np.testing.assert_array_equal(tm.segment_states(a, b), jm.segment_states(a, b))
        assert tm.check_motion(a, b) == jm.check_motion(a, b)


@pytest.mark.parametrize("seed", [3, 11])
def test_rrt_connect_replays_reference_tree_and_simplifier(seed):
    (js, _, jm), (ts, _, tm) = _wall_world()
    want = JRRT(js, jm, step=2.0, seed=seed).solve(START, GOAL, max_iters=4000)
    got = RRTConnect(ts, tm, step=2.0, seed=seed).solve(START, GOAL, max_iters=4000)
    assert got.solved and want.solved
    np.testing.assert_array_equal(got.path.states, want.path.states)
    assert (got.iterations, got.motion_checks, got.states_checked) == (
        want.iterations, want.motion_checks, want.states_checked)
    # without the endpoint pre-check (the card's default) the tree is the
    # same and a solve reads the device once per motion check, plus the two
    # endpoint checks
    lean = RRTConnect(ts, tm, step=2.0, seed=seed, endpoint_precheck=False).solve(START, GOAL, max_iters=4000)
    np.testing.assert_array_equal(lean.path.states, got.path.states)
    assert lean.host_reads == lean.motion_checks + 2 < got.host_reads
    simp_t = PathSimplifier(tm, seed=5).simplify(got.path)
    simp_j = JSimplifier(jm, seed=5).simplify(want.path)
    np.testing.assert_array_equal(simp_t.states, simp_j.states)
    assert int(tm.checker.batch_colliding_voxels(simp_t.interpolate(0.5)).max()) == 0


def test_trivial_and_invalid_endpoints():
    (js, _, jm), (ts, _, tm) = _wall_world()
    free = GvlValidityChecker(replace(tm.checker.env, data=torch.full_like(tm.checker.env.data, -128)),
                              TPointRobot(), 0.7)
    result = RRTConnect(ts, MotionValidator(free, 0.5), seed=0).solve(START, GOAL)
    assert result.solved and result.iterations == 0 and len(result.path) == 2
    bad = np.array([8.5, 8.5, 8.5], np.float32)
    got, want = RRTConnect(ts, tm, seed=0).solve(bad, GOAL), JRRT(js, jm, seed=0).solve(bad, GOAL)
    assert not got.solved and got.iterations == want.iterations == 0
    with pytest.raises(ValueError):
        RRTConnect(ts, tm, seed=0).solve([-1.0, 0.0, 0.0], GOAL)


def test_joint_space_and_path_match_reference():
    for space in (JointSpace.symmetric(4, 2.0), JSpace.symmetric(4, 2.0)):
        assert space.dim == 4 and space.contains(np.zeros(4)) and not space.contains(np.full(4, 3.0))
        assert space.distance([0, 0, 0, 0], [1, -2, 0.5, 0]) == 2.0
    q = JointSpace.symmetric(4, 2.0).sample(np.random.default_rng(0))
    np.testing.assert_array_equal(q, JSpace.symmetric(4, 2.0).sample(np.random.default_rng(0)))
    with pytest.raises(ValueError):
        JointSpace(np.ones(3, np.float32), np.zeros(3, np.float32))
    states = np.array([[0.0, 0.0], [1.0, 0.0], [1.3, -0.7]], np.float32)
    np.testing.assert_array_equal(Path(states).interpolate(0.25), JPath(states).interpolate(0.25))
    assert Path(states).length() == JPath(states).length()
    assert Path(states[:1]).interpolate(0.1).shape == (1, 2)


def test_hierarchical_validity_checker_is_not_ported():
    """Named when the checker raised; since the hierarchical tier is ported
    it counts a point robot's colliding voxels against a dense hierarchy
    (tests/test_torch_octree_io.py holds it against the reference)."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap

    env = HierarchicalBitMap.create((16, 16, 16), 1.0, device="cpu").insert_point_cloud(
        np.array([[3.5, 4.5, 5.5], [3.5, 4.5, 6.5]], np.float32))

    class Point:
        def transformed_clouds_for(self, cfg):
            pts = torch.tensor([[0.5, 0.5, 0.5], [0.5, 0.5, 1.5], [0.5, 0.5, 1.7]]) + torch.as_tensor(cfg)[..., None, :]
            return MetaPointCloud(pts, torch.zeros(3, dtype=torch.int64), (0, 3), ("p",))

    checker = HierarchicalValidityChecker(env, Point())
    assert checker.colliding_voxels(np.array([3.0, 4.0, 5.0], np.float32)) == 2
    assert checker.batch_colliding_voxels(np.array([[3.0, 4.0, 5.0], [9.0, 9.0, 9.0]], np.float32)).tolist() == [2, 0]
    assert checker.host_reads == 2 and not checker.is_valid(np.array([3.0, 4.0, 4.0], np.float32))


# -- the UR10 (forward kinematics) ------------------------------------------------
BASE = np.array([1.6, 1.6, 0.4], np.float32)
UR_DIMS, UR_SIDE = (64, 64, 48), 0.05


class JArm:
    """The reference's 6-joint UR10 view of examples/ompl_planner_app.py:
    tool0 pinned to 0, based at BASE."""

    def __init__(self, chain):
        self.chain = chain

    def transformed_clouds_for(self, cfg):
        full = jnp.concatenate([jnp.asarray(cfg, jnp.float32), jnp.zeros((1,), jnp.float32)])
        c = self.chain.transformed_clouds_for(full)
        return replace(c, points=c.points + BASE)


class TArm:
    def __init__(self, chain):
        self.chain = chain

    def transformed_clouds_for(self, cfg):
        c = self.chain.transformed_clouds_for(torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1))
        return replace(c, points=c.points + torch.as_tensor(BASE))


def _boundary_margin(points):
    """Per state, the least distance of a point to a cell boundary, in voxels."""
    f = np.asarray(points, np.float64) / UR_SIDE
    return np.abs(f - np.round(f)).reshape(len(points), -1).min(axis=1)


def _safe_chains(states):
    """The UR10 at 0.05 m spacing in both packages, its link clouds pruned
    to the points that keep 2e-3 voxel from every cell boundary at every
    state (FK ulps must not move a point across one)."""
    from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
    from gpu_voxels_tpu.robot.dh import KinematicChain as JChain
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
    from gpu_voxels_tpu_torch.robot.dh import KinematicChain as TChain

    arm = tpresets.ur_robot("ur10", spacing=0.05, device="cpu")
    f = TArm(arm).transformed_clouds_for(torch.tensor(states)).points.numpy().astype(np.float64) / UR_SIDE
    keep = (np.abs(f - np.round(f)) >= 2e-3).all(axis=(0, 2))
    pts, offs, names = arm.clouds.points.numpy(), arm.clouds.offsets, arm.clouds.names
    clouds = [pts[lo:hi][keep[lo:hi]] for lo, hi in zip(offs, offs[1:])]
    jarm = jpresets.ur_robot("ur10", spacing=0.05)
    jchain = JChain(jarm.link_names, list(jarm.dh.values()), JMeta.from_clouds(clouds, names))
    tchain = TChain(arm.link_names, [arm.dh[n] for n in arm.link_names], TMeta.from_clouds(clouds, names, device="cpu"))
    return jchain, tchain, int(keep.sum()), len(keep)


def test_ur10_validity_counts_match_reference():
    """GvlValidityChecker with the UR10 among examples/ompl_planner_app.py's
    boxes, at 64x64x48 and 0.05 m: per-state counts, single and batched, on
    states whose FK points all keep 1e-3 voxel from a cell boundary
    (asserted)."""
    pts = np.concatenate([
        np.stack(np.meshgrid(*(np.arange(lo, hi, UR_SIDE) + UR_SIDE / 2 for lo, hi in zip(lo3, hi3)),
                          indexing="ij"), -1).reshape(-1, 3)
        for lo3, hi3 in (((1.0, 1.0, 0.0), (1.2, 1.2, 1.2)), ((1.8, 1.8, 0.0), (2.0, 2.0, 1.2)),
                         ((1.1, 1.1, 1.2), (1.9, 1.9, 1.3)), ((0.0, 0.0, 0.0), (3.0, 3.0, 0.05)))]).astype(np.float32)
    jenv = JProb.create(UR_DIMS, UR_SIDE).insert_point_cloud(pts)
    tenv = interop.prob_map_from_numpy(np.asarray(jenv.data), UR_DIMS, UR_SIDE, device="cpu")
    states = np.random.default_rng(2).uniform(-np.pi, np.pi, (16, 6)).astype(np.float32)
    jchain, tchain, kept, total = _safe_chains(states)
    assert kept > 0.8 * total, (kept, total)
    tarm, jarm = TArm(tchain), JArm(jchain)
    tpts = tarm.transformed_clouds_for(torch.tensor(states)).points.numpy()
    assert _boundary_margin(tpts).min() >= 1e-3
    np.testing.assert_allclose(tpts[0], np.asarray(jarm.transformed_clouds_for(states[0]).points), rtol=1e-6,
                               atol=1e-6)
    jc, tc = JChecker(jenv, jarm, 0.7), GvlValidityChecker(tenv, tarm, 0.7)
    got, want = tc.batch_colliding_voxels(states), np.asarray(jc.batch_colliding_voxels(states))
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any() and (got == 0).any(), got
    for s in states[:2]:
        assert tc.colliding_voxels(s) == int(jc.colliding_voxels(jnp.asarray(s)))
