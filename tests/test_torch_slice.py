"""Port conformance of the whole slice: sense -> insert -> collide.

Scenes run through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch with the same numpy inputs; maps and counts must be
equal. Also: map state handed from the reference to the port (interop), and
a scan proving the port never imports JAX or the JAX package.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpu_voxels_tpu_torch
from gpu_voxels_tpu import sensors as jsens
from gpu_voxels_tpu.api import GpuVoxels as JGvl
from gpu_voxels_tpu.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu.geometry import generation as jgen
from gpu_voxels_tpu.geometry import transforms as jtf
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import raycast as jrc
from gpu_voxels_tpu_torch import interop, sensors as tsens
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.geometry import generation as tgen
from gpu_voxels_tpu_torch.geometry import transforms as ttf
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import CountingVoxelMap as TCount
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.providers import Provider


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


def _linkage(gvl, **init):
    gvl.initialize(128, 128, 128, 0.01, **init)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bA")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bB")
    gvl.insert_box_into_map((0.4, 0.4, 0.4), (0.8, 0.8, 0.8), "bA", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.2, 0.2, 0.2), (0.6, 0.6, 0.6), "bB", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    return gvl.get_map("bA").collide_with(gvl.get_map("bB"), 0.1)


def test_linkage_scene_through_facade_counts_8000():
    """BASELINE config #1 (bench.py:255-279): the gvl_linkage_test boxes."""
    got = _linkage(TGvl(), device="cpu")
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert int(got) == int(_linkage(JGvl())) == 8000
    assert TGvl.get_instance() is TGvl.get_instance()


def test_facade_registry():
    gvl = TGvl()
    with pytest.raises(RuntimeError):
        gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "a")
    gvl.initialize(8, 8, 8, 0.5, device="cpu")
    m = gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "bits")
    assert m.device.type == "cpu"
    with pytest.raises(ValueError):
        gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "bits")
    for mt, cls in ((MapType.MT_PROBAB_OCTREE, "HierarchicalProbMap"),
                    (MapType.MT_BITVECTOR_OCTREE, "HierarchicalBitMap")):  # octrees since items 10b and 11
        octree = gvl.add_map(mt, mt.name)
        assert type(octree).__name__ == cls and octree.map_type == mt and octree.device.type == "cpu"
    for mt in (MapType.MT_COUNTING_VOXELLIST, MapType.MT_BITVECTOR_VOXELLIST):  # voxel lists since item 9
        lst = gvl.add_map(mt, mt.name)
        assert lst.map_type == mt and lst.device.type == "cpu" and lst.capacity == 0
    dist = gvl.add_map(MapType.MT_DISTANCE_VOXELMAP, "dist")
    assert dist.map_type == MapType.MT_DISTANCE_VOXELMAP and dist.device.type == "cpu"
    gvl.insert_point_cloud_into_map(np.asarray([[1.2, 1.2, 1.2]], np.float32), "bits", 9)
    assert int(gvl.get_map("bits").occ.sum()) == 1
    gvl.set_map("bits", gvl.get_map("bits").clear_map())
    assert int(gvl.get_map("bits").occ.sum()) == 0
    gvl.update_map("bits", lambda mm: mm.insert_point_cloud(np.zeros((1, 3), np.float32)))
    gvl.clear_map("bits")
    assert not gvl.get_map("bits").data.any()
    assert gvl.del_map("bits") and "bits" not in gvl._maps


def _frame(rng, h=48, w=64):
    depth = np.full((h, w), 2.6, np.float32)
    depth[8:28, 14:40] = 1.9  # an obstacle the robot reaches into
    depth[30:40, 50:60] = 0.0  # invalid patch
    return depth + rng.normal(0, 0.01, depth.shape).astype(np.float32)


def test_sense_insert_collide_scene_matches_reference():
    """64^3 at 5 cm: two 64x48 depth frames fused into a ProbVoxelMap, a
    transformed sphere robot inserted into a BitVectorVoxelMap and a
    ProbVoxelMap, then every collide of the slice."""
    dims, side = (64, 64, 64), 0.05
    sensor_kw = dict(position=np.asarray([1.6, 1.6, 0.02], np.float32), data_width=64, data_height=48,
                     fx=52.0, fy=52.0, cx=32.0, cy=24.0)
    jsensor, tsensor = jsens.Sensor(**sensor_kw), tsens.Sensor(**sensor_kw)
    rng = np.random.default_rng(5)
    from tests.test_torch_raycast import _boundary_safe, _min_boundary_distance

    # the reference frames run op by op: see tests/test_torch_raycast.py
    jdata, tenv = JProb.create(dims, side).data, TProb.create(dims, side, device="cpu")
    for _ in range(2):
        depth = _boundary_safe(_frame(rng), tsensor.pose(), side, (52.0, 52.0, 32.0, 24.0))
        assert _min_boundary_distance(np.asarray(jsensor.process_depth_image(depth)), side) >= 1e-3
        jdata = jrc.insert_depth_image(jdata, jnp.asarray(depth), jnp.asarray(jsensor.pose()), 52.0, 52.0, 32.0, 24.0, side, dims)
        tenv = tenv.insert_depth_image(depth, tsensor)
    np.testing.assert_array_equal(tenv.data.numpy(), np.asarray(jdata))
    jenv = JProb(jdata, dims, side)

    sphere = tgen.create_sphere_of_points((0.0, 0.0, 0.0), 0.35, 0.05)
    np.testing.assert_array_equal(sphere, jgen.create_sphere_of_points((0.0, 0.0, 0.0), 0.35, 0.05))
    rpy, t = np.asarray([0.2, -0.1, 0.7], np.float32), np.asarray([1.613, 1.571, 1.937], np.float32)
    pose = ttf.from_rpy_np(rpy, t)
    # drop the sphere points that land within 2e-3 voxel of a cell boundary
    f = (sphere.astype(np.float64) @ pose[:3, :3].astype(np.float64).T + pose[:3, 3]) / side
    sphere = sphere[(np.abs(f - np.round(f)) >= 2e-3).all(axis=1)]
    jpts = np.asarray(jtf.transform_points(jnp.asarray(pose), jnp.asarray(sphere)))
    tpts = ttf.transform_points(torch.tensor(pose), torch.tensor(sphere)).numpy()
    np.testing.assert_allclose(tpts, jpts, rtol=1e-6, atol=1e-6)
    assert _min_boundary_distance(jpts, side) >= 1e-3 and _min_boundary_distance(tpts, side) >= 1e-3

    jbot = JBit.create(dims, side).insert_point_cloud(jpts, BitVoxelMeaning.eBVM_OCCUPIED)
    tbot = TBit.create(dims, side, device="cpu").insert_point_cloud(tpts, BitVoxelMeaning.eBVM_OCCUPIED)
    jbot = jbot.insert_point_cloud(jpts[::3], 40)
    tbot = tbot.insert_point_cloud(tpts[::3], 40)
    np.testing.assert_array_equal(tbot.data.numpy().view(np.uint32), np.asarray(jbot.data))
    np.testing.assert_array_equal(tbot.occ.numpy(), np.asarray(jbot.occ))
    jpbot = JProb.create(dims, side).insert_point_cloud(jpts)
    tpbot = TProb.create(dims, side, device="cpu").insert_point_cloud(tpts)

    counts = []
    for thr in (0.55, 0.7):
        pairs = [
            (tbot.collide_with(tenv, thr), jbot.collide_with(jenv, thr)),  # bit x prob
            (tenv.collide_with(tbot, thr), jenv.collide_with(jbot, thr)),  # prob x bit
            (tenv.collide_with(tpbot, thr), jenv.collide_with(jpbot, thr)),  # prob x prob (K1)
            (tenv.collide_with(tpbot, thr, (1, -1, 2)), jenv.collide_with(jpbot, thr, (1, -1, 2))),
        ]
        for got, ref in pairs:
            assert got.dtype == torch.int64 and int(got) == int(ref)
            counts.append(int(got))
    assert min(counts) > 0
    cnt, marked = tenv.collide_with_marking(tpbot, 0.55)  # K2
    ref_c, ref_m = jenv.collide_with_marking(jpbot, 0.55)
    assert int(cnt) == int(ref_c) > 0
    np.testing.assert_array_equal(marked.data.numpy(), np.asarray(ref_m.data))
    np.testing.assert_array_equal(tenv.data.numpy(), np.asarray(jenv.data))  # inputs untouched


def test_interop_round_trip():
    """A reference map continues in the port; both go on; states stay equal."""
    dims, side = (24, 20, 16), 0.1
    rng = np.random.default_rng(8)
    ext = np.asarray(dims, np.float32) * side
    c1, c2 = (rng.uniform(0, 1, (900, 3)).astype(np.float32) * ext for _ in range(2))
    jprob = JProb.create(dims, side).insert_point_cloud(c1).update_occupancy(c2, -30)
    tprob = interop.prob_map_from_numpy(np.asarray(jprob.data), dims, side, "cpu")
    jbit = JBit.create(dims, side).insert_point_cloud(c1, 3).insert_point_cloud(c2, 250)
    tbit = interop.bit_map_from_numpy(np.asarray(jbit.data), np.asarray(jbit.occ), dims, side, "cpu")
    # no summary in, no summary out; from_planes is the call that computes one
    tbit_no_occ = interop.bit_map_from_numpy(np.asarray(jbit.data), None, dims, side, "cpu")
    assert tbit_no_occ.occ is None and interop.to_numpy(tbit_no_occ)[1] is None
    np.testing.assert_array_equal(TBit.from_planes(tbit_no_occ.data, dims, side).occ.numpy(), np.asarray(jbit.occ))

    jprob, tprob = jprob.insert_point_cloud(c2[:300], 2), tprob.insert_point_cloud(c2[:300], 2)
    jbit, tbit = jbit.insert_point_cloud(c2[:100], 0), tbit.insert_point_cloud(c2[:100], 0)
    got = interop.to_numpy(tprob)
    assert got.dtype == np.int8
    np.testing.assert_array_equal(got, np.asarray(jprob.data))
    planes, occ = interop.to_numpy(tbit)
    assert planes.dtype == np.uint32 and occ.dtype == np.uint8
    np.testing.assert_array_equal(planes, np.asarray(jbit.data))
    np.testing.assert_array_equal(occ, np.asarray(jbit.occ))
    assert int(tprob.collide_with(tbit, 0.6)) == int(jprob.collide_with(jbit, 0.6))
    assert tprob.memory_usage() == jprob.memory_usage()
    assert tbit.memory_usage() == jbit.memory_usage()

    ref_sensor = jsens.Sensor(position=np.asarray([1.0, 2.0, 3.0], np.float32), fx=500.0, cy=200.0)
    s = interop.sensor_from_reference(ref_sensor)
    np.testing.assert_array_equal(s.pose(), ref_sensor.pose())
    assert (s.fx, s.cy, s.model.update_probability) == (500.0, 200.0, ref_sensor.model.update_probability)
    with pytest.raises(ValueError):
        interop.prob_map_from_numpy(np.zeros(5, np.int16), dims, side, "cpu")


def test_left_out_methods_raise(tmp_path, monkeypatch):
    m = TProb.create((4, 4, 4), device="cpu")
    b = TBit.create((4, 4, 4), device="cpu")
    # what item 12 brought: URDF robots, the map dump, the facade's and the
    # Provider's visualization, each as the reference's; item 13 the
    # facade's mesh, whose sharded values answer as the single-device maps
    # (the dense maps' slab forms, item 13b-i; the pyramids', 13b-ii)
    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / "vis"))
    urdf = pathlib.Path(__file__).resolve().parent.parent / "examples" / "models" / "pan_tilt.urdf"
    tg, jg = TGvl(), JGvl()
    tg.initialize(4, 4, 4, 1.0, device="cpu")
    jg.initialize(4, 4, 4, 1.0)
    assert tg.add_robot("arm", urdf) and jg.add_robot("arm", urdf)
    np.testing.assert_array_equal(tg.get_robot("arm").clouds.points.numpy(), np.asarray(jg.get_robot("arm").clouds.points))
    pts = np.full((1, 3), 1.5, np.float32)
    jm = JProb.create((4, 4, 4)).insert_point_cloud(pts)
    assert m.insert_point_cloud(pts).print_voxel_map_data() == jm.print_voxel_map_data()
    tg.add_map(MapType.MT_PROBAB_VOXELMAP, "m")
    assert tg.visualize_map("m") and (tmp_path / "vis" / "m.ply").exists()
    prov = Provider("p")
    prov.init(m)
    assert prov.visualize() and prov.finish_visualization() == 0 and (tmp_path / "vis" / "p.cubes.json").exists()
    from gpu_voxels_tpu_torch.parallel import make_grid_mesh

    sharded = tg.add_map(MapType.MT_PROBAB_VOXELMAP, "sharded", mesh=make_grid_mesh(4, devices=["cpu"]))
    got = sharded.insert_sensor_data(pts, sensor_origin=(0.5, 0.5, 0.5))
    assert torch.equal(got.gather().data, TProb.create((4, 4, 4), device="cpu").insert_sensor_data(
        pts, sensor_origin=(0.5, 0.5, 0.5)).data)
    octree = tg.add_map(MapType.MT_PROBAB_OCTREE, "sharded_octree", mesh=make_grid_mesh(4, devices=["cpu"]))
    camera = tsens.Sensor(position=np.asarray([2.0, 2.0, 0.0], np.float32), data_width=2, data_height=2, fx=1.0,
                          fy=1.0, cx=1.1, cy=1.1)
    got = octree.insert_depth_image(np.full((2, 2), 3.3, np.float32), camera).gather()
    want = tg.add_map(MapType.MT_PROBAB_OCTREE, "octree").insert_depth_image(np.full((2, 2), 3.3, np.float32), camera)
    assert torch.equal(got.occupancy, want.occupancy) and int((want.occupancy != -128).sum()) > 0
    assert all(torch.equal(a, b) for a, b in zip(got.pyramid, want.pyramid, strict=True))
    # what earlier slices left out and the dense-map tier now has: the disk
    # files (item 9) among them
    assert b.write_to_disk(tmp_path / "b.bin") and torch.equal(b.read_from_disk(tmp_path / "b.bin").data, b.data)
    assert int(m.insert_sensor_data(np.full((1, 3), 1.5, np.float32), sensor_origin=(0.5, 0.5, 0.5)).data.max()) == -128 + 72
    assert int(m.collide_with_resolution(m)) == int(b.collide_with_resolution(b)) == 0
    b.init_sensor_settings(tsens.Sensor())
    assert TCount.create((4, 4, 4), device="cpu").data.shape == (64,)
    src = tsens.SyntheticDepthSource(tsens.Sensor(data_width=8, data_height=6), seed=3)
    ref = jsens.SyntheticDepthSource(jsens.Sensor(data_width=8, data_height=6), seed=3)
    for _ in range(2):
        np.testing.assert_array_equal(src.get_frame(), ref.get_frame())
    frames = np.arange(12, dtype=np.float32).reshape(3, 2, 2)
    rep = tsens.ReplayDepthSource(frames)
    assert [float(rep.get_frame()[0, 0]) for _ in range(4)] == [0.0, 4.0, 8.0, 0.0]


def test_port_never_imports_jax():
    """AST scan of every module of the port and of the card scripts beside
    it: no `import jax`, `from jax`, and no import of the JAX package
    (sys.modules cannot tell here, where the test process has jax loaded
    already)."""
    root = pathlib.Path(gpu_voxels_tpu_torch.__file__).parent
    files = sorted(p for p in root.rglob("*.py") if "_build" not in p.relative_to(root).parts)
    scanned = {str(p.relative_to(root)) for p in files}
    assert {"bitops.py", "geometry/pointcloud.py", "robot/dh.py", "robot/presets.py", "robot/robot.py",
            "robot/swept_volume.py", "ops/collide_cuda.py", "interop.py", "ops/edt.py", "ops/edt_envelope.py",
            "ops/edt_cuda.py", "ops/raycast_cuda.py", "maps/distance_map.py", "converters.py", "providers.py",
            "sensors.py", "robot/trajectory.py", "robot/fitter.py", "ops/raycast.py", "ops/insert.py",
            "maps/voxelmap.py"} <= scanned
    files += [root.parent / "chip_smoke.py", root.parent / "chip_profile.py", root.parent / "chip_compare.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "gpu_voxels_tpu"):
                    bad.append(f"{path.relative_to(root.parent)}:{node.lineno} {name}")
    assert not bad, bad
