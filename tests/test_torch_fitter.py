"""Port conformance of the trajectory-scheduling path: `.traj` files ->
swept volumes -> raw-plane collides -> schedule fitter.

The loaders read the same files; the fitters run on the same swept maps
(the reference's, carried across by interop, with their occupancy summaries
and without: the raw-plane form whose bit x bit count is kernel K7's);
orderings, delays and schedules must be equal. The two-UR10 scene of
examples/swept_fitter.py runs at 96^3, the size the reference's CPU tests
use (orderings, the centre collide and the start delays; the schedules are
held at 32^3); both packages insert the reference's FK points there, so the
swept maps are equal bit for bit, and the port's own FK gives the same
answers.
"""
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.constants import BitVoxelMeaning
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.robot import fitter as jfit
from gpu_voxels_tpu.robot import trajectory as jtraj
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.robot import fitter as tfit
from gpu_voxels_tpu_torch.robot import load_trajectories as t_load_from_package
from gpu_voxels_tpu_torch.robot import swept_volume as tsv
from gpu_voxels_tpu_torch.robot import trajectory as ttraj
from gpu_voxels_tpu_torch.robot.presets import ur_robot as t_ur_robot

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import swept_fitter as example  # noqa: E402  (the reference's example: its .traj texts and scene)

LOADERS = {"reference": jtraj.load_trajectories, "port": ttraj.load_trajectories}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The fitter runs hundreds of small full-grid torch ops; beside other
    busy test processes their thread barriers cost far more than they save."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)

TRAJ = """Trajectory_Num: 2
Joint_Num: 3
Name: T1
shoulder 0.0 1.0
elbow -1.5 1.5
wrist 3.14 3.0
Joint_Num: 2
Name: T2
shoulder 1 2
elbow 0 0
"""


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_traj_file_roundtrip(tmp_path, monkeypatch, pkg):
    """tests/test_robot.py:228 through both loaders: header parsing, model-
    path resolution, the 100-intermediate-pose interpolation."""
    load = LOADERS[pkg]
    d = tmp_path / "trajectories"
    d.mkdir()
    (d / "arm.traj").write_text(TRAJ)
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(tmp_path))
    trajs = load("arm.traj")
    assert [t.name for t in trajs] == ["T1", "T2"]
    t1 = trajs[0]
    assert t1.joint_names == ["shoulder", "elbow", "wrist"]
    cfgs = t1.interpolate(100)
    assert cfgs.shape == (101, 3) and cfgs.dtype == np.float32
    np.testing.assert_allclose(cfgs[0], [0.0, -1.5, 3.14], rtol=1e-6)
    np.testing.assert_allclose(cfgs[-1], [1.0, 1.5, 3.0], rtol=1e-6)
    np.testing.assert_allclose(cfgs[50], [0.5, 0.0, 3.07], atol=1e-6)
    assert abs(t1.joint_map_at(0.5)["elbow"]) < 1e-6
    assert len(load("arm.traj", max_trajectories=1)) == 1
    # an absolute path, or use_model_path=False, skips the model path
    assert [t.name for t in load(d / "arm.traj")] == ["T1", "T2"]
    monkeypatch.chdir(d)
    assert len(load("arm.traj", use_model_path=False)) == 2
    (d / "bad.traj").write_text("Nope: 1")
    with pytest.raises(ValueError, match="expected 'Trajectory_Num:'"):
        load("bad.traj")


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_traj_truncated_file_raises_value_error(tmp_path, monkeypatch, pkg):
    """tests/test_robot.py:269 through both loaders."""
    d = tmp_path / "trajectories"
    d.mkdir()
    (d / "cut.traj").write_text("Trajectory_Num: 2\nJoint_Num: 3\nName: T1\nshoulder 0.0 1.0\n")
    (d / "empty.traj").write_text("")
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(tmp_path))
    for name in ("cut.traj", "empty.traj"):
        with pytest.raises(ValueError, match="unexpected end"):
            LOADERS[pkg](name)


def test_loaders_and_interpolation_are_bit_equal(tmp_path):
    """The example's two files through both loaders: the same trajectories,
    and interpolate(N) equal bit for bit, also to joint_map_at(k / N)."""
    assert t_load_from_package is ttraj.load_trajectories
    for fname, text in (("ur_a.traj", example.TRAJ_A), ("ur_b.traj", example.TRAJ_B)):
        (tmp_path / fname).write_text(text)
        ref, got = jtraj.load_trajectories(tmp_path / fname), ttraj.load_trajectories(tmp_path / fname)
        assert len(ref) == len(got) == 2
        for r, g in zip(ref, got):
            assert (r.name, r.start, r.end) == (g.name, g.start, g.end)
            for steps in (100, 7):
                np.testing.assert_array_equal(g.interpolate(steps), r.interpolate(steps))
            assert g.joint_map_at(0.37) == r.joint_map_at(0.37)
            cfgs = g.interpolate(8)
            at = g.joint_map_at(np.float32(3 / 8))
            np.testing.assert_array_equal(cfgs[3], np.asarray([at[j] for j in g.joint_names], np.float32))


# -- the five cases of tests/test_fitter.py on maps carried across ------------
SV = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)
DIMS = (32, 32, 32)


def _box_cloud(lo, hi):
    ax = [np.arange(lo[i], hi[i], dtype=np.float32) + 0.5 for i in range(3)]
    return np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)


def _swept_map(home_lo, shared_steps):
    """tests/test_fitter.py:30: a private home box at steps 0..4 plus the
    shared box (10..13)^3 during `shared_steps`; built by the port's inserts
    and carried to the reference, whose insert compiles a program per
    meaning (68 here). Both fitters search the same planes."""
    m = TBit.create(DIMS, 1.0, device="cpu")
    for s in range(5):
        m = m.insert_point_cloud(_box_cloud(home_lo, tuple(c + 3 for c in home_lo)), SV + s)
    for s in shared_steps:
        m = m.insert_point_cloud(_box_cloud((10, 10, 10), (13, 13, 13)), SV + s)
    planes, occ = interop.to_numpy(m)
    return JBit(jnp.asarray(planes), m.dims, m.side_length, occ=jnp.asarray(occ))


def _carry(jm, with_occ: bool) -> TBit:
    occ = np.asarray(jm.occ) if with_occ else None
    return interop.bit_map_from_numpy(np.asarray(jm.data), occ, jm.dims, jm.side_length, "cpu")


@pytest.fixture(scope="module")
def reference_maps():
    homes = {"a": (1, 1, 1), "b": (20, 1, 1), "c": (1, 20, 1)}
    maps = {k: _swept_map(lo, range(10, 13)) for k, lo in homes.items()}
    maps.update({"h" + k: _swept_map(homes[k], ()) for k in "ab"})
    maps.update({"w" + k: _swept_map(homes[k], range(0, 60)) for k in "ab"})
    return maps


@pytest.fixture(params=[True, False], ids=["summary", "raw-planes"])
def maps(request, reference_maps):
    """(reference maps, the same maps in the port, with or without summaries)."""
    return reference_maps, {k: _carry(m, request.param) for k, m in reference_maps.items()}


def test_deconflict_slot_greedy_minimal_delays(maps):
    j, t = maps
    assert int(t["a"].collide_with_bitcheck(t["b"], margin=1)) == int(j["a"].collide_with_bitcheck(j["b"], margin=1)) > 0
    delays = tfit.deconflict_slot([t["a"], t["b"], t["c"]], margin=1)
    assert delays == jfit.deconflict_slot([j["a"], j["b"], j["c"]], margin=1) == [0, 4, 8]
    for rel in (0, 3, 4, -4, -2):
        assert tfit._pair_window_conflicts(t["a"], t["b"], rel, 1) == jfit._pair_window_conflicts(j["a"], j["b"], rel, 1)
    assert tfit._pair_window_conflicts(t["a"], t["b"], delays[1] - 1, 1) > 0


def test_deconflict_slot_zero_for_compatible(maps):
    j, t = maps
    assert int(t["ha"].collide_with(t["hb"])) == int(j["ha"].collide_with(j["hb"])) == 0
    assert tfit.deconflict_slot([t["ha"], t["hb"]], margin=2) == [0, 0]
    assert tfit.deconflict_slot([t["a"], t["b"]], margin=0) == jfit.deconflict_slot([j["a"], j["b"]], margin=0) == [0, 3]


def test_deconflict_slot_infeasible_returns_none(maps):
    j, t = maps
    assert tfit.deconflict_slot([t["wa"], t["wb"]], margin=0, stride=8) is None
    assert jfit.deconflict_slot([j["wa"], j["wb"]], margin=0, stride=8) is None
    assert tfit.MAX_SV_SHIFT == jfit.MAX_SV_SHIFT
    with pytest.raises(ValueError):
        tfit.deconflict_slot([t["wa"], t["wb"]], max_shift=tfit.MAX_SV_SHIFT + 1)


def _robots(m, names):
    return [(r, [(name, m[key]) for name, key in trajs]) for r, trajs in names]


def test_fit_schedule_windows_rescue_boolean_rejects(maps):
    j, t = maps
    names = [("A", [("tA", "a")]), ("B", [("tB", "b")]), ("C", [("tC", "c")])]
    jr, tr = _robots(j, names), _robots(t, names)
    assert tfit.fit_orderings(tr) == jfit.fit_orderings(jr) == []
    assert tfit.fit_schedule(tr, margin=1) == []
    rescued = tfit.fit_schedule(tr, margin=1, windows_in_search=True)
    assert rescued == jfit.fit_schedule(jr, margin=1, windows_in_search=True) == [([[0], [0], [0]], [[0, 4, 8]])]


def test_fit_schedule_annotates_boolean_orderings(maps):
    j, t = maps
    names = [("A", [("center", "a"), ("home", "ha")]), ("B", [("center", "b"), ("home", "hb")])]
    jr, tr = _robots(j, names), _robots(t, names)
    sols = tfit.fit_orderings(tr)
    assert sols == jfit.fit_orderings(jr) and len(sols) == 2
    assert tfit.fit_orderings(tr, all_solutions=False) == sols[:1]
    assert list(tfit.iter_orderings(tr)) == sols
    res = tfit.fit_schedule(tr, margin=1)
    assert res == jfit.fit_schedule(jr, margin=1) and res[0][1] == [[0, 0], [0, 0]]
    assert tfit.fit_schedule(tr, margin=1, all_solutions=True) == jfit.fit_schedule(jr, margin=1, all_solutions=True)


# -- the example's scene at 96^3 ------------------------------------------------
SCENE_DIMS, SCENE_SIDE, STEPS, WINDOW = (96, 96, 96), 0.04, 100, 2


class _TableFK:
    """FK as the reference's table of points per step (config [step])."""

    def __init__(self, table):
        self.table = torch.tensor(table)

    def transformed_clouds_for(self, cfg):
        class _Clouds:
            points = self.table[cfg[..., 0].long()]

        return _Clouds()


class _PlacedUR:
    """The port's counterpart of the example's PlacedUR: a UR10 with its
    base at a world position, tool0's value pinned to 0."""

    def __init__(self, base):
        self.base = torch.tensor(np.asarray(base, np.float32))
        self.chain = t_ur_robot("ur10", 0.04, device="cpu")

    def transformed_clouds_for(self, cfg):
        full = torch.cat([cfg, torch.zeros_like(cfg[..., :1])], dim=-1)
        clouds = self.chain.transformed_clouds_for(full)
        return replace(clouds, points=clouds.points + self.base)


def _answers(fit, robots):
    """Everything the example asks of the fitter, as plain Python values."""
    a_center, b_center = robots[0][1][0][1], robots[1][1][0][1]
    return {
        "solutions": fit.fit_orderings(robots, all_solutions=True),
        "center_collide": int(a_center.collide_with(b_center)),
        "conflicts0": int(a_center.collide_with_bitcheck(b_center, margin=WINDOW)),
        "delays": fit.deconflict_slot([a_center, b_center], margin=WINDOW, stride=4),
    }


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("traj")
    jrobots, tables, files = [], {}, {}
    for name, fname, text in (("UR10_A", "ur_a.traj", example.TRAJ_A), ("UR10_B", "ur_b.traj", example.TRAJ_B)):
        files[name] = d / fname
        files[name].write_text(text)
        arm = example.PlacedUR(name, example.BASES[name])
        trajs = jtraj.load_trajectories(files[name])
        jrobots.append((name, example.render_swept_volumes(arm, trajs, SCENE_DIMS, SCENE_SIDE, STEPS)))
        for t in trajs:
            cfgs = jnp.asarray(t.interpolate(STEPS))
            tables[t.name] = np.asarray(jax.vmap(lambda c: arm.transformed_clouds_for(c).points)(cfgs))
    return {"robots": jrobots, "tables": tables, "files": files, "answers": _answers(jfit, jrobots)}


@pytest.mark.parametrize("with_occ", [True, False], ids=["summary", "raw-planes"])
def test_swept_fitter_scene_matches_reference(scene, with_occ):
    """examples/swept_fitter.py at 96^3: the port loads the files, renders
    each trajectory from the reference's FK points, and searches on maps
    with and without summaries."""
    ref = scene["answers"]
    assert len(ref["solutions"]) == 2 and ref["center_collide"] > 0 and ref["conflicts0"] > 0
    assert ref["delays"][0] == 0 and ref["delays"][1] > 0
    robots = []
    steps = np.arange(STEPS + 1, dtype=np.float32)[:, None]
    for (name, jmaps), path in zip(scene["robots"], scene["files"].values()):
        rendered = []
        for t, (jname, jm) in zip(ttraj.load_trajectories(path), jmaps):
            assert t.name == jname
            m = tsv.insert_swept_volume_batched(TBit.create(SCENE_DIMS, SCENE_SIDE, device="cpu"),
                                                _TableFK(scene["tables"][t.name]), steps)
            planes, occ = interop.to_numpy(m)
            np.testing.assert_array_equal(planes, np.asarray(jm.data))
            np.testing.assert_array_equal(occ, np.asarray(jm.occ))
            rendered.append((t.name, m if with_occ else TBit(m.data, m.dims, m.side_length)))
        robots.append((name, rendered))
    assert (robots[0][1][0][1].occ is None) == (not with_occ)
    assert _answers(tfit, robots) == ref


def test_swept_fitter_scene_with_the_ports_own_fk(scene):
    """The same scene end to end in the port (its loader, its UR10, its FK):
    the example's assertions hold and the answers equal the reference's."""
    robots = []
    for name, path in scene["files"].items():
        arm = _PlacedUR(example.BASES[name])
        robots.append((name, [
            (t.name, tsv.insert_swept_volume_batched(TBit.create(SCENE_DIMS, SCENE_SIDE, device="cpu"), arm,
                                                     t.interpolate(STEPS)))
            for t in ttraj.load_trajectories(path)]))
    got, ref = _answers(tfit, robots), scene["answers"]
    assert got["solutions"] == ref["solutions"] and len(got["solutions"]) == 2
    assert got["delays"] == ref["delays"]
    assert got["center_collide"] > 0 and got["conflicts0"] > 0
