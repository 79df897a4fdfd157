"""Port conformance of the example programs (gpu_voxels_tpu_torch/examples/)
whose reference runs are costly: sharded_world_demo, maps_demo,
full_pipeline_demo, ompl_planner_app, distance_voxel_test, swept_fitter and
swept_volume_vs_environment.

Each port program runs once with `device="cpu"` at the size
tests/test_examples.py uses, under that file's own assertions. Rather than
rerunning the reference program, every integer the port returns is held
against the reference's library calls on the same inputs or against a
numpy oracle: the world's tiles, probes and collides against the
reference's single-device PagedHierarchicalMap; the list count against the
cloud's distinct voxels; the planner's solution states against the boxes'
voxels; the EDT against scipy's; the fitter's orderings and
start delay against the reference fitter on the same swept maps; the
windowed swept-volume counts against the voxel sets of the sweep's steps;
the full pipeline's scans, list counts, probes, types collide and clearance
field against the reference's depth insert and types collide, numpy counts
and sets, and scipy's EDT. Where a program's inner values are needed, the
test wraps the program's own helper (`fit`, `visualize_solution`) or the
library methods it calls, to keep what they were given and returned. The
reference's N-robot fitter test runs against the port's `fit`.
"""
import importlib
import itertools
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.geometry import generation as jgen


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
def fresh_facade():
    """The port's GpuVoxels singleton starts empty (maps_demo adds maps of
    fixed names to it) and is put back afterwards."""
    from gpu_voxels_tpu_torch.api import GpuVoxels

    before = GpuVoxels._instance
    GpuVoxels._instance = None
    try:
        yield
    finally:
        GpuVoxels._instance = before


def port(name):
    return importlib.import_module(f"gpu_voxels_tpu_torch.examples.{name}")


def voxels(points, side) -> np.ndarray:
    """int64 [M, 3] voxel coordinates of float32 points, as both packages
    voxelize (times the f32 reciprocal of the side, then floor)."""
    pts = np.asarray(points, np.float32)
    return np.floor(pts * np.float32(1.0 / side)).astype(np.int64)


def voxel_keys(coords, dims) -> np.ndarray:
    """Linear keys of the in-map coordinates."""
    inside = ((coords >= 0) & (coords < np.asarray(dims))).all(axis=1)
    c = coords[inside]
    return (c[:, 2] * dims[1] + c[:, 1]) * dims[0] + c[:, 0]


def test_sharded_world_demo_against_the_reference_single_device_map():
    from gpu_voxels_tpu.maps.paged import PagedHierarchicalMap
    from gpu_voxels_tpu.maps.voxellist import VoxelList
    from gpu_voxels_tpu.sensors import Sensor

    out = port("sharded_world_demo").main(device="cpu")
    assert out["devices"] >= 1 and out["tiles"] > 0
    assert out["free_cells"] > 0 and out["unknown_cells"] > 0
    dims = out["dims"]
    assert out["devices"] == 1 and dims == (128, 128, 256)  # one slab on the CPU

    # the program's scene, through the reference's single-device paged map
    cam = Sensor(position=np.array([3.2, 3.2, 0.4], np.float32), data_width=64, data_height=64, fx=64.0, fy=64.0,
                 cx=32.0, cy=32.0)
    rng = np.random.default_rng(7)
    depth = rng.uniform(6.0, 0.05 * dims[2] * 0.9, (64, 64)).astype(np.float32)
    ref = PagedHierarchicalMap(dims, 0.05, probabilistic=True).insert_depth_image(depth, cam, max_steps=dims[2])
    zs = np.arange(16, dims[2], 32, np.int32)
    col = np.stack([np.full_like(zs, 64), np.full_like(zs, 64), zs], axis=-1)
    _, unknown, free = ref.probe(jnp.asarray(col))
    obstacles = (rng.uniform(0.2, 0.8, (500, 3)) * np.asarray(dims) * 0.05).astype(np.float32)
    lst = VoxelList.create(dims, 0.05, "bit", 2048, "linear").insert_point_cloud(obstacles)
    n_coll, n_unknown = ref.collide_with_counting_unknown(lst)
    want = {"devices": 1, "dims": dims, "tiles": ref.n_tiles(), "memory_mb": ref.memory_usage() / 2**20,
            "free_cells": int(np.asarray(free).sum()), "unknown_cells": int(np.asarray(unknown).sum()),
            "collisions": int(n_coll), "unknown_hits": int(n_unknown)}
    assert out == want


def test_maps_demo_counts_the_clouds_distinct_voxels():
    count = port("maps_demo").main(device="cpu")
    assert count > 0
    cloud = jgen.create_sphere_of_points((4.8, 4.8, 4.8), 1.0, 0.08)
    assert count == len(np.unique(voxel_keys(voxels(cloud, 0.1), (96, 96, 96))))


def test_full_pipeline_demo(monkeypatch):
    """The program returns True (test_examples' assertion), and its inner
    values, kept by wrapping the library methods it calls, hold against the
    reference's calls or a numpy / scipy oracle on the same inputs: the map
    after the three pooled-carve scans (carve_pool=8) against the
    reference's insert_depth_image; the counting list before and after
    remove_underpopulated(3) against the cloud's per-voxel point counts;
    every hierarchical probe (the motion's states and the dive) against the
    table's voxel set; the windowed types collide against the reference's on
    the same swept and mover planes; the distance map and the clearance
    against scipy's exact EDT of the merged obstacles."""
    from scipy import ndimage

    from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
    from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
    from gpu_voxels_tpu.ops import raycast as jrc
    from gpu_voxels_tpu.ops import raycast_pallas as rp
    from gpu_voxels_tpu.sensors import Sensor as JSensor
    from gpu_voxels_tpu_torch import interop
    from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
    from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalProbMap
    from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
    from gpu_voxels_tpu_torch.planning.validity import HierarchicalValidityChecker
    from gpu_voxels_tpu_torch.vis import export

    kept = {}

    def keep(owner, attr, key):
        real = getattr(owner, attr)

        def keeping(*args, **kwargs):
            out = real(*args, **kwargs)
            kept.setdefault(key, []).append((args, out))
            return out
        monkeypatch.setattr(owner, attr, keeping)

    keep(ProbVoxelMap, "insert_depth_image", "scan")
    keep(VoxelList, "insert_point_cloud", "list")
    keep(VoxelList, "remove_underpopulated", "filter")
    keep(HierarchicalProbMap, "insert_point_cloud", "table")
    keep(HierarchicalValidityChecker, "colliding_voxels_device", "probe")
    keep(BitVectorVoxelMap, "collide_with_types", "types")
    keep(DistanceVoxelMap, "min_distance_to", "clearance")
    keep(export, "write_html", "drawn")
    mod = port("full_pipeline_demo")
    assert mod.main(device="cpu") is True
    dims, side = mod.DIMS, mod.SIDE

    # sense: three scans with the pooled carve, against the reference's
    # insert with its pooled-carve spec: its Pallas kernel (interpret mode
    # here) differs from that spec in 124 voxels of this scene, whose voxel
    # centres project onto pool-cell edges (F23); the port follows the spec
    monkeypatch.setattr(rp, "projective_free_space_tpu", rp.projective_free_space_pooled)
    scans = kept["scan"]
    assert len(scans) == 3
    ref = JProb.create(dims, side)
    for (env, depth, sensor), kwargs_out in ((a[:3], o) for a, o in scans):
        jsensor = JSensor(position=np.asarray(sensor.position), data_width=sensor.data_width,
                          data_height=sensor.data_height, fx=sensor.fx, fy=sensor.fy, cx=sensor.cx, cy=sensor.cy)
        np.testing.assert_array_equal(env.data.numpy(), np.asarray(ref.data))
        # the reference's eager depth insert: compiled, XLA re-rounds its
        # projection and can move a voxel at a pixel edge (F4)
        ref = replace(ref, data=jrc.insert_depth_image(ref.data, jnp.asarray(np.asarray(depth)),
                                                       jnp.asarray(jsensor.pose()), jsensor.fx, jsensor.fy,
                                                       jsensor.cx, jsensor.cy, side, dims, carve_pool=8))
        np.testing.assert_array_equal(kwargs_out.data.numpy(), np.asarray(ref.data))
    env = scans[-1][1]
    ((_, drawn, *_), _), = kept["drawn"]
    assert drawn["env"] is env
    assert int(env.occupied_mask(0.6).sum()) > 0

    # filter: the list's count and the filtered count, from the cloud's
    # per-voxel point counts; a list keeps the linear ids past the map's top
    # (the noise reaches z 5 m), so the keys are taken unfiltered
    ((_, cloud), cvl), = kept["list"]
    ((_, _), solid), = kept["filter"]
    c = voxels(cloud, side)
    assert (c >= 0).all() and (c[:, :2] < np.asarray(dims[:2])).all() and (c[:, 2] >= dims[2]).any()
    keys, counts = np.unique((c[:, 2] * dims[1] + c[:, 1]) * dims[0] + c[:, 0], return_counts=True)
    assert int(cvl.count) == len(keys) and int(solid.count) == int((counts >= 3).sum()) < len(keys)

    # probes: each state's distinct colliding voxels against the table's set
    ((_, table), _), = kept["table"]
    table_keys = np.unique(voxel_keys(voxels(table, side), dims))
    probes = kept["probe"]
    assert len(probes) == 2
    for (checker, cfgs), hits in probes:
        pts = checker.robot.transformed_clouds_for(cfgs).points.numpy()
        pts = pts.reshape((-1,) + pts.shape[-2:]) if cfgs.ndim > 1 else pts[None].reshape(1, -1, 3)
        want = [np.isin(np.unique(voxel_keys(voxels(p.reshape(-1, 3), side), dims)), table_keys).sum() for p in pts]
        np.testing.assert_array_equal(hits.reshape(-1).numpy(), want)
    assert int(probes[0][1].sum()) == 0 and int(probes[1][1]) > 0  # the sweep is clear, the dive hits

    # the windowed types collide, on the reference's planes
    ((sweep, mover, *_), (cnt, meanings, marked)), = kept["types"]
    assert drawn["sweep"] is sweep

    def ref_map(m):
        planes, occ = interop.to_numpy(m)
        return JBit(jnp.asarray(planes), m.dims, m.side_length, occ=jnp.asarray(occ))

    jcnt, jmeanings, jmarked = ref_map(sweep).collide_with_types(ref_map(mover), 1.0, sv_window=2)
    assert int(cnt) == int(jcnt) > 0
    np.testing.assert_array_equal(meanings.numpy().view(np.uint32), np.asarray(jmeanings))
    np.testing.assert_array_equal(interop.to_numpy(marked)[0], np.asarray(jmarked.data))

    # the clearance field: scipy's exact EDT of the env's occupied voxels and the table
    ((dm, tool), clearance), = kept["clearance"]
    occupied = env.occupied_mask(0.6).numpy().reshape(dims[::-1])
    occupied.reshape(-1)[table_keys] = True
    want = np.rint(ndimage.distance_transform_edt(~occupied) ** 2).astype(np.int64)
    np.testing.assert_array_equal(dm.squared_distances().numpy().reshape(dims[::-1]), want)
    tool_keys = voxel_keys(voxels(tool, side), dims)
    assert float(clearance) == pytest.approx(np.sqrt(np.float32(want.reshape(-1)[tool_keys].min())) * side,
                                             rel=1e-6)


def test_ompl_planner_app_solution_is_free_of_the_boxes(monkeypatch):
    """One round solves (test_examples' assertion); every interpolated state
    of the simplified path hits none of the scene's box voxels (a numpy set
    oracle of the facade's box inserts), and the solution list holds the
    distinct in-map voxels of all those states' points."""
    mod = port("ompl_planner_app")
    seen = []
    real = mod.visualize_solution

    def keep(gvl, robot, states):
        seen.append((gvl, robot, np.asarray(states, np.float32)))
        return real(gvl, robot, states)

    monkeypatch.setattr(mod, "visualize_solution", keep)
    assert mod.main(rounds=1, device="cpu") == 1
    (gvl, robot, states), = seen
    dims, side = (150, 150, 100), 0.02
    boxes = [((1.0, 1.0, 0.0), (1.2, 1.2, 1.2)), ((1.8, 1.8, 0.0), (2.0, 2.0, 1.2)),
             ((1.1, 1.1, 1.2), (1.9, 1.9, 1.3)), ((0.0, 0.0, 0.0), (3.0, 3.0, 0.01))]
    env = np.unique(np.concatenate([voxel_keys(voxels(jgen.create_box_of_points(lo, hi, side / 2), side), dims)
                                    for lo, hi in boxes]))
    occupied = np.flatnonzero(gvl.get_map("myEnvironmentMap").occupied_mask(0.7).numpy())
    np.testing.assert_array_equal(occupied, env)
    pts = robot.transformed_clouds_for(torch.from_numpy(states)).points.numpy()
    for p in pts:
        assert not np.isin(voxel_keys(voxels(p, side), dims), env).any()
    assert int(gvl.get_map("mySolutionMap").count) == len(np.unique(voxel_keys(voxels(pts.reshape(-1, 3), side),
                                                                               dims)))


def test_distance_voxel_test_against_an_independent_edt(monkeypatch):
    """The program returns 0: its JFA and PBA both equal its exact EDT; that
    EDT (kept by wrapping `exact_distances`) equals scipy's exact Euclidean
    distance transform of the same obstacles (squared, on integer
    offsets)."""
    from scipy import ndimage

    from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap

    kept = []
    real = DistanceVoxelMap.exact_distances
    monkeypatch.setattr(DistanceVoxelMap, "exact_distances", lambda m, obs: kept.append(real(m, obs)) or kept[-1])
    assert port("distance_voxel_test").main(device="cpu") == 0
    dim = 64
    obs = np.unique(np.random.default_rng(0).integers(0, dim, (100, 3)), axis=0)
    free = np.ones((dim,) * 3, bool)
    free[obs[:, 2], obs[:, 1], obs[:, 0]] = False  # [z, y, x]
    want = np.rint(ndimage.distance_transform_edt(free) ** 2).astype(np.int64)
    (exact,) = kept
    np.testing.assert_array_equal(exact.squared_distances().numpy(), want)


def test_swept_fitter_against_the_reference_fitter(monkeypatch):
    """The UR10 pair at 96^3 (test_examples' size): exactly the two valid
    orderings and a positive start delay; the reference's fit_orderings and
    deconflict_slot over the same swept maps give the same answers."""
    from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
    from gpu_voxels_tpu.robot.fitter import deconflict_slot, fit_orderings
    from gpu_voxels_tpu_torch import interop

    mod = port("swept_fitter")
    seen = []
    real = mod.fit

    def keep(robots, all_solutions=True, verbose=True):
        solutions = real(robots, all_solutions=all_solutions, verbose=verbose)
        seen.append((robots, solutions))
        return solutions

    monkeypatch.setattr(mod, "fit", keep)
    n_solutions, delay = mod.main(dims=(96, 96, 96), side=0.04, verbose=False, device="cpu")
    assert n_solutions == 2 and delay > 0
    (robots, solutions), = seen

    def ref_map(m):
        planes, occ = interop.to_numpy(m)
        return JBit(jnp.asarray(planes), m.dims, m.side_length, occ=jnp.asarray(occ))

    ref_robots = [(name, [(t, ref_map(m)) for t, m in maps]) for name, maps in robots]
    assert fit_orderings(ref_robots, all_solutions=True) == solutions
    centers = [dict(maps)[t] for (_, maps), t in zip(ref_robots, ("A_reach_center", "B_reach_center"))]
    assert deconflict_slot(centers, margin=2, stride=4) == [0, delay]


def test_swept_volume_vs_environment_against_step_voxel_sets():
    """The windowed types collide's count (window 5, the program's return)
    and the count at every window equal a numpy oracle over the voxels of
    each trajectory step's FK points (the port's own, so no cell boundary
    separates the two sides)."""
    from gpu_voxels_tpu_torch.constants import SV_START
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_tpu_torch.robot.dh import DHParameters, KinematicChain
    from gpu_voxels_tpu_torch.robot.swept_volume import insert_swept_volume

    cnt = port("swept_volume_vs_environment").main(device="cpu")
    assert cnt >= 1

    # the program's arm and trajectory
    link = [np.linspace([0.1, 0, 0], [0.9, 0, 0], 9).astype(np.float32)] * 2
    arm = KinematicChain(["link1", "link2"], [DHParameters(0, 0, 1.0, 0)] * 2,
                         MetaPointCloud.from_clouds(link, names=("link1", "link2"), device="cpu"))
    traj = np.linspace(0, np.pi / 2, 20, dtype=np.float64)
    traj = np.stack([traj, traj / 2], axis=1).astype(np.float32)
    # one step at a time, as insert_swept_volume computes them
    steps = np.stack([arm.transformed_clouds_for(torch.from_numpy(c)).points.numpy() for c in traj])
    dims, side = (64, 64, 64), 0.125
    step_sets = [set(voxel_keys(voxels(p, side), dims).tolist()) for p in steps]
    obstacle = set(voxel_keys(voxels(steps[10][:3], side), dims).tolist())
    sweep = insert_swept_volume(BitVectorVoxelMap.create(dims, side, device="cpu"), arm, list(traj))
    env = BitVectorVoxelMap.create(dims, side, device="cpu").insert_point_cloud(steps[10][:3], SV_START + 10)
    for window in (0, 2, 5, 9):
        near = set().union(*step_sets[max(10 - window, 0):10 + window + 1])
        got = int(sweep.collide_with_types(env, 1.0, sv_window=window)[0])
        assert got == len(obstacle & near), window
        if window == 5:
            assert cnt == got


def test_swept_fitter_three_robots_vs_bruteforce():
    """Fitter::fitInternal is N-robot (Fitter.cpp:71-116): the port's `fit`
    for THREE robots against brute-force enumeration of all slot
    assignments, on synthetic maps with randomized pairwise collisions (the
    reference's test of its example, on the port's)."""
    mod = port("swept_fitter")

    class FakeMap:
        def __init__(self, key, table):
            self.key, self.table = key, table

        def collide_with(self, other):
            return self.table[frozenset((self.key, other.key))]

    rng = np.random.default_rng(5)
    n_robots, n_traj = 3, 2
    keys = [(r, t) for r in range(n_robots) for t in range(n_traj)]
    for _ in range(6):
        table = {
            frozenset((a, b)): int(rng.random() < 0.35)
            for a, b in itertools.combinations(keys, 2)
        }
        table.update({frozenset((k,)): 0 for k in keys})  # self-pairs unused
        robots = [
            (f"R{r}", [(f"R{r}T{t}", FakeMap((r, t), table)) for t in range(n_traj)])
            for r in range(n_robots)
        ]
        got = {tuple(map(tuple, s)) for s in mod.fit(robots, verbose=False)}

        # brute force: per-robot permutations of trajectory order; slot-mates
        # of every earlier robot must not collide (Fitter::collides)
        want = set()
        for perms in itertools.product(
            *[list(itertools.permutations(range(n_traj))) for _ in range(n_robots)]
        ):
            ok = all(
                table[frozenset(((r1, perms[r1][i]), (r2, perms[r2][i])))] == 0
                for i in range(n_traj)
                for r1 in range(n_robots)
                for r2 in range(r1)
            )
            if ok:
                want.add(tuple(map(tuple, perms)))
        assert got == want
