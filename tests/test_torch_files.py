"""Port conformance of the point-cloud files, the generators, heightmaps,
URDF robots and the host utilities (config, logging, perf monitor, tf).

The same inputs, made from a numpy seed, go through gpu_voxels_tpu (JAX,
the reference) and gpu_voxels_tpu_torch: every reader's arrays, every
generator's points and the URDF link poses are equal element for element;
the URDF link clouds after FK are equal to rtol 1e-6 (`transform_points`
differs by ulps between the frameworks, F4).
"""
import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_voxels_tpu.geometry import files as jfiles
from gpu_voxels_tpu.geometry import generation as jgen
from gpu_voxels_tpu.geometry import heightmap as jheight
from gpu_voxels_tpu.geometry import transforms as jtf
from gpu_voxels_tpu.robot.urdf import UrdfRobot as JUrdf
from gpu_voxels_tpu.utils.config import ConfigManager as JConfig
from gpu_voxels_tpu.utils.perfmon import PerformanceMonitor as JPerf
from gpu_voxels_tpu.utils.tf_helper import TfHelper as JTf

from gpu_voxels_tpu_torch.constants import BitVoxelMeaning
from gpu_voxels_tpu_torch.geometry import files as tfiles
from gpu_voxels_tpu_torch.geometry import generation as tgen
from gpu_voxels_tpu_torch.geometry import heightmap as theight
from gpu_voxels_tpu_torch.geometry import transforms as ttf
from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap
from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.robot.urdf import UrdfRobot as TUrdf
from gpu_voxels_tpu_torch.utils import logging as tlog
from gpu_voxels_tpu_torch.utils.config import ConfigManager as TConfig
from gpu_voxels_tpu_torch.utils.config import initialize as tconfig_initialize
from gpu_voxels_tpu_torch.utils.perfmon import PerformanceMonitor as TPerf
from gpu_voxels_tpu_torch.utils.tf_helper import TfHelper as TTf

MODELS = Path(__file__).resolve().parent.parent / "examples" / "models"
PAN_TILT = MODELS / "pan_tilt.urdf"


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


def _binvox_bytes(grid: np.ndarray, translate=(1.0, 2.0, 3.0), scale=8.0) -> bytes:
    """A binvox file of a [depth, height, width] uint8 grid, RLE encoded."""
    d, h, w = grid.shape
    flat = grid.reshape(-1)
    rle, i = bytearray(), 0
    while i < flat.size:
        j = i
        while j < flat.size and flat[j] == flat[i] and j - i < 255:
            j += 1
        rle += bytes([int(flat[i]), j - i])
        i = j
    header = f"#binvox 1\ndim {d} {h} {w}\ntranslate {translate[0]} {translate[1]} {translate[2]}\nscale {scale}\ndata\n"
    return header.encode() + bytes(rle)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def test_readers_equal_reference(tmp_path):
    """xyz, pcd (ascii and binary, with a COUNT > 1 field), binvox (a random
    grid and the shipped tilt link): the port's arrays equal the
    reference's element for element."""
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    tfiles.write_xyz(tmp_path / "port.xyz", pts)
    jfiles.write_xyz(tmp_path / "ref.xyz", pts)
    assert (tmp_path / "port.xyz").read_bytes() == (tmp_path / "ref.xyz").read_bytes()
    _same(tfiles.read_xyz(tmp_path / "ref.xyz"), jfiles.read_xyz(tmp_path / "ref.xyz"))

    header = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z normal\nSIZE 4 4 4 4\nTYPE F F F F\nCOUNT 1 1 1 3\n"
              "WIDTH 40\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS 40\n")
    rows = rng.normal(size=(40, 6)).astype(np.float32)
    (tmp_path / "a.pcd").write_text(header + "DATA ascii\n" + "\n".join(" ".join(f"{v:.6f}" for v in r) for r in rows))
    (tmp_path / "b.pcd").write_bytes((header + "DATA binary\n").encode() + rows.astype("<f4").tobytes())
    for name in ("a.pcd", "b.pcd"):
        _same(tfiles.read_pcd(tmp_path / name), jfiles.read_pcd(tmp_path / name))
    np.testing.assert_array_equal(tfiles.read_pcd(tmp_path / "b.pcd"), rows[:, :3])

    grid = (rng.random((6, 5, 7)) < 0.3).astype(np.uint8)
    (tmp_path / "g.binvox").write_bytes(_binvox_bytes(grid))
    for path in (tmp_path / "g.binvox", MODELS / "tilt_link.binvox"):
        _same(tfiles.read_binvox(path), jfiles.read_binvox(path))
    assert tfiles.read_binvox(MODELS / "tilt_link.binvox").shape == (252, 3)
    (tmp_path / "bad.binvox").write_bytes(b"#notbinvox\n")
    with pytest.raises(ValueError):
        tfiles.read_binvox(tmp_path / "bad.binvox")


def test_load_point_cloud_options(tmp_path, monkeypatch):
    """load_point_cloud's dispatch and shift / offset / scaling (scalar and
    per axis), the model path, load_point_clouds with per-path scalings and
    an explicit reader, center_point_cloud: equal to the reference."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 5, (64, 3)).astype(np.float32)
    jfiles.write_xyz(tmp_path / "c.xyz", pts)
    (tmp_path / "c.pcd").write_bytes(("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\nWIDTH 64\nHEIGHT 1\n"
                                      "POINTS 64\nDATA binary\n").encode() + pts.astype("<f4").tobytes())
    (tmp_path / "c.binvox").write_bytes(_binvox_bytes((rng.random((4, 4, 4)) < 0.5).astype(np.uint8)))
    for name in ("c.xyz", "c.pcd", "c.binvox"):
        for kw in ({}, dict(shift_to_zero=True, offset_xyz=(10, 0, -1), scaling=2.0),
                   dict(scaling=np.asarray([1.0, 0.5, 3.0], np.float32))):
            _same(tfiles.load_point_cloud(tmp_path / name, **kw), jfiles.load_point_cloud(tmp_path / name, **kw))
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(tmp_path))
    _same(tfiles.load_point_cloud("c.xyz", use_model_path=True), jfiles.load_point_cloud("c.xyz", use_model_path=True))
    with pytest.raises(ValueError):
        tfiles.load_point_cloud(tmp_path / "c.unknown")
    monkeypatch.delenv("GPU_VOXELS_MODEL_PATH")
    with pytest.raises(FileNotFoundError):
        tfiles.model_path(True)
    paths = [tmp_path / "c.binvox", MODELS / "tilt_link.binvox"]
    kw = dict(scalings=[2.0, (1.0, 2.0, 0.5)], reader=tfiles.read_binvox, shift_to_zero=True, max_workers=2)
    got = tfiles.load_point_clouds(paths, **kw)
    want = jfiles.load_point_clouds(paths, **dict(kw, reader=jfiles.read_binvox))
    for a, b in zip(got, want, strict=True):
        _same(a, b)
    assert tfiles.load_point_clouds([]) == []
    with pytest.raises(ValueError):
        tfiles.load_point_clouds(paths, scalings=[1.0])
    _same(tfiles.center_point_cloud(pts), jfiles.center_point_cloud(pts))


def test_generators_equal_reference():
    """The cylinder, the oriented box and its edges, point for point."""
    _same(tgen.create_cylinder_of_points((1.0, 2.0, 3.0), 0.4, 1.2, 0.05),
          jgen.create_cylinder_of_points((1.0, 2.0, 3.0), 0.4, 1.2, 0.05))
    for rot in ((0.0, 0.0, 0.0), (0.3, -0.7, 1.1)):
        tp = tgen.OrientedBoxParams(np.asarray([1.0, 2.0, 0.5]), np.asarray([0.3, 0.2, 0.1]), np.asarray(rot))
        jp = jgen.OrientedBoxParams(tp.center, tp.dim, tp.rot)
        _same(tgen.create_oriented_box(tp, 0.05), jgen.create_oriented_box(jp, 0.05))
        _same(tgen.create_oriented_box_edges(tp, 0.05), jgen.create_oriented_box_edges(jp, 0.05))


def test_heightmaps_equal_reference(tmp_path):
    """heightmap_to_point_cloud (columns and surface only) and the .npy /
    .npz loader; the extruded columns land in a map as the reference's
    test expects (ground layer everywhere, the h = 2 column reaches z = 2)."""
    rng = np.random.default_rng(2)
    h = rng.uniform(0, 4, (5, 7)).astype(np.float32)
    for kw in ({}, dict(pixel_size=0.5, height_scale=2.0, height_offset=0.25), dict(fill_columns=False)):
        _same(theight.heightmap_to_point_cloud(h, **kw), jheight.heightmap_to_point_cloud(h, **kw))
    np.save(tmp_path / "h.npy", h)
    np.savez(tmp_path / "h.npz", a=h)
    for name in ("h.npy", "h.npz"):
        _same(theight.load_height_array(tmp_path / name), jheight.load_height_array(tmp_path / name))
    small = np.array([[0, 2], [1, 0]], np.float32)
    m = ProbVoxelMap.create((2, 2, 3), device="cpu").insert_point_cloud(theight.heightmap_to_point_cloud(small) + 0.25)
    occ = m.occupied_mask(0.5).reshape(3, 2, 2).numpy()
    assert occ[0].all() and occ[2, 0, 1] and not occ[2, 1, 0]


ARM_URDF = """<?xml version="1.0"?>
<robot name="arm">
  <link name="base"/>
  <link name="upper"/>
  <link name="hand"><visual><origin xyz="0.1 0 0" rpy="0 0.2 0"/>
    <geometry><mesh filename="package://hand.stl" scale="1 2 1"/></geometry></visual></link>
  <joint name="shoulder" type="revolute">
    <parent link="base"/> <child link="upper"/>
    <origin xyz="0 0 1" rpy="0.1 0 0.3"/>
    <axis xyz="0 0 1"/>
    <limit lower="-3.14" upper="3.14"/>
  </joint>
  <joint name="wrist" type="prismatic">
    <parent link="upper"/> <child link="hand"/>
    <origin xyz="1 0 0" rpy="0 0 0"/>
    <axis xyz="1 0 0"/>
    <limit lower="0" upper="0.5"/>
  </joint>
</robot>
"""


def _urdf_pair(path, **kw):
    return TUrdf(path, device="cpu", **kw), JUrdf(path, **kw)


def _same_robot_clouds(t, j):
    got = t.get_transformed_clouds().points.numpy()
    want = np.asarray(j.get_transformed_clouds().points)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_urdf_pan_tilt_equals_reference():
    """The shipped pan/tilt unit: 252 mesh points on the tilt link, link
    poses equal bit for bit and FK clouds to rtol 1e-6 at several joint
    values; names, limits and the configuration round trip."""
    t, j = _urdf_pair(PAN_TILT)
    assert t.clouds.names == j.clouds.names == ("tilt",)
    assert t.clouds.accumulated_size == 252 and t.clouds.device.type == "cpu"
    np.testing.assert_array_equal(t.clouds.points.numpy(), np.asarray(j.clouds.points))
    assert t.get_joint_names() == j.get_joint_names() == ["pan_joint", "tilt_joint"]
    assert t.get_lower_joint_limits() == j.get_lower_joint_limits()
    assert t.get_upper_joint_limits() == j.get_upper_joint_limits()
    _same_robot_clouds(t, j)
    rng = np.random.default_rng(3)
    for pan, tilt in [(0.0, 0.0), (0.5, -0.3)] + [tuple(v) for v in rng.uniform(-1.5, 1.5, (4, 2))]:
        cfg = {"pan_joint": float(pan), "tilt_joint": float(tilt), "not_a_joint": 1.0}
        t.set_configuration(cfg)
        j.set_configuration(cfg)
        assert t.get_configuration() == j.get_configuration()
        for name, pose in j.link_poses().items():
            np.testing.assert_array_equal(t.link_poses()[name], pose)
        np.testing.assert_array_equal(t.link_cloud_matrices(), j.link_cloud_matrices())
        _same_robot_clouds(t, j)


def test_urdf_arm_prismatic_visual_origin_and_updates(tmp_path):
    """A revolute and a prismatic joint, an RPY joint origin, a visual
    origin and a per-axis mesh scale, a `package://` mesh name; a geometry-
    less robot; update_point_cloud of a link with and without geometry."""
    (tmp_path / "hand.binvox").write_bytes(_binvox_bytes(np.ones((2, 2, 2), np.uint8), (0, 0, 0), 2.0))
    (tmp_path / "arm.urdf").write_text(ARM_URDF)
    t, j = _urdf_pair(tmp_path / "arm.urdf")
    assert t.clouds.names == j.clouds.names == ("hand",)
    for cfg in ({"shoulder": 0.0, "wrist": 0.0}, {"shoulder": np.pi / 2, "wrist": 0.2}, {"shoulder": -1.0, "wrist": 0.45}):
        t.set_configuration(cfg)
        j.set_configuration(cfg)
        _same_robot_clouds(t, j)
        for name, pose in j.link_poses().items():
            np.testing.assert_array_equal(t.link_poses()[name], pose)
    new = np.asarray([[0.0, 0.0, 0.0], [0.1, 0.2, 0.3], [0.5, 0.5, 0.5]], np.float32)
    t.update_point_cloud("upper", new)
    j.update_point_cloud("upper", new)
    t.update_point_cloud("hand", new[:2])
    j.update_point_cloud("hand", new[:2])
    assert t.clouds.names == j.clouds.names == ("hand", "upper")
    _same_robot_clouds(t, j)
    with pytest.raises(KeyError):
        t.update_point_cloud("nowhere", new)
    bare_t, bare_j = _urdf_pair(tmp_path / "arm.urdf", load_clouds=False)
    assert bare_t.clouds.names == bare_j.clouds.names == ("base",) and bare_t.clouds.accumulated_size == 0
    bare_t.update_point_cloud("hand", new)
    bare_j.update_point_cloud("hand", new)
    assert bare_t.clouds.names == bare_j.clouds.names == ("hand",)
    _same_robot_clouds(bare_t, bare_j)


def test_urdf_binvox_under_xyz_named_dir(tmp_path):
    """Mesh paths never go through the format dispatcher's whole-path
    substring test: a model root named xyz_models still decodes binvox."""
    root = tmp_path / "xyz_models"
    root.mkdir()
    (root / "hand.binvox").write_bytes(_binvox_bytes(np.eye(2, dtype=np.uint8)[None].repeat(2, 0), (0, 0, 0), 2.0))
    (root / "arm.urdf").write_text(ARM_URDF.replace("package://hand.stl", "hand.stl"))
    t, j = _urdf_pair(root / "arm.urdf")
    np.testing.assert_array_equal(t.clouds.points.numpy(), np.asarray(j.clouds.points))


def test_tf_helper_equals_reference():
    rng = np.random.default_rng(4)
    tt, jt = TTf(), JTf()
    frames = ["world", "base", "arm", "camera", "tool"]
    for parent, child in zip(frames, frames[1:]):
        m = jtf.from_rpy(rng.uniform(-1, 1, 3), rng.uniform(-2, 2, 3), xp=np)
        tt.publish(m, parent, child)
        jt.publish(m, parent, child)
    for a in frames + ["unknown"]:
        for b in frames:
            got, want = tt.lookup(a, b), jt.lookup(a, b)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tt.lookup("world", "tool") @ tt.lookup("tool", "world"), np.eye(4), atol=1e-5)


def test_config_manager_equals_reference(tmp_path):
    xml = tmp_path / "cfg.xml"
    xml.write_text("<cfg><camera><fov>90</fov><name>kinect</name></camera><on>yes</on></cfg>")
    out = []
    for cls in (TConfig, JConfig):
        cls._instance = None
        cm = cls.instance()
        seen = []
        cm.set("/scene/dimX", 64)
        cm.observe("/scene", lambda k, v: seen.append((k, v)))
        cm.set("/scene/dimY", 32)
        cm.load_xml(xml)
        cm.add_parameter("--dim-z", "/scene/dimZ", type_=int)
        cm.parse(["--dim-z", "77", "--other", "1"])
        out.append((seen, sorted(cm.keys()), cm.get("/cfg/camera/fov", int), cm.get("/cfg/on", bool),
                    cm.get("/scene/dimZ", int), cm.has("/missing"),
                    cm.get_batch([("/scene/dimX", int, 0), ("/missing", str, "d")])))
        cls._instance = None
    assert out[0] == out[1]
    assert out[0][0] == [("/scene/dimY", 32), ("/scene/dimZ", 77)] and out[0][2] == 90 and out[0][4] == 77
    TConfig._instance = None
    assert tconfig_initialize([]) is TConfig.instance()
    TConfig._instance = None


def test_perfmon_and_log_streams(caplog):
    """The perf monitor's prefixes, series and summary lines as the
    reference's; `block_on` takes tensors (CPU tensors need no wait); the
    maps log on the reference's stream names, under the port's root."""
    for cls in (TPerf, JPerf):
        cls.initialize()
        pm = cls.instance()
        pm.enable("test")
        pm.start("t")
        assert pm.measure("t", "phase1", "test", silent=False, block_on=None) >= 0.0
        pm.add_data("counts", 42.0, "test")
        pm.measure("t", "phase1", "disabled_prefix")
        assert pm.measure("never", "x") == 0.0
        assert "test::phase1" in pm.summary("test") and "test::counts" in pm.summary("test")
        assert pm.series("counts", "test") == [42.0] and pm.series("phase1", "disabled_prefix") == []
        assert len(pm.events) == 1
    pm = TPerf.instance()
    pm.start("t")
    pm.measure("t", "tensors", "test", block_on=[torch.zeros(3), torch.ones(2)])
    pm.measure("t", "tensor", "test", block_on=torch.zeros(3))
    pm.enable_all()
    pm.add_data("anything", 1.0, "other")
    assert pm.series("anything", "other") == [1.0]
    TPerf.initialize()

    assert tlog.log_stream("voxelmap").name == "gpu_voxels_tpu_torch.voxelmap"
    assert tlog.Gpu_voxels is tlog.log_stream("Gpu_voxels")
    tlog.initialize()
    with caplog.at_level(logging.ERROR, logger="gpu_voxels_tpu_torch"):
        m = ProbVoxelMap.create((4, 4, 4), device="cpu")
        assert m.clear_voxel_meaning(BitVoxelMeaning.eBVM_COLLISION) is m
        h = HierarchicalBitMap.create((8, 8, 8), device="cpu")
        assert h.clear_voxel_meaning(BitVoxelMeaning.eBVM_COLLISION) is h
        p = PagedHierarchicalMap((64, 64, 64), device="cpu")
        assert p.clear_voxel_meaning(BitVoxelMeaning.eBVM_COLLISION) is p
    names = [r.name for r in caplog.records]
    assert names == ["gpu_voxels_tpu_torch.voxelmap", "gpu_voxels_tpu_torch.octree", "gpu_voxels_tpu_torch.octree"]
    tlog.set_log_level("voxelmap", logging.WARNING)
    assert tlog.log_stream("voxelmap").level == logging.WARNING
    tlog.set_log_level("voxelmap", logging.NOTSET)
    assert isinstance(ttf.invert_np(np.eye(4, dtype=np.float32)), np.ndarray)
