"""The port's facade (gpu_voxels_tpu_torch.api.GpuVoxels) against the
reference facade and a set oracle, on the CPU.

* The 8x8 type x type collision matrix of tests/test_collision_matrix.py
  on the torch facade: every supported ordered pair counts exactly
  |occupied(A) n occupied(B)| (the set oracle on floor-voxelized coords),
  every unsupported pair raises TypeError; bit maps without an occupancy
  summary (raw planes) count the same.
* save_map / load_map over every tier: each file byte-equal to the
  reference facade's save of the same scene, each loaded map equal to the
  saved one; ascii octree files load through the port's facade (F16: the
  reference's read_map takes "GPU_" for a MapType).
* insert_point_cloud_from_file, add_robot from a URDF, the primitive
  arrays, visualize_map and print_voxel_map_data against the reference,
  and the camelCase alias tables name for name.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_voxels_tpu import compat as jcompat
from gpu_voxels_tpu.api import GpuVoxels as JGvl
from gpu_voxels_tpu.geometry import files as jfiles
from gpu_voxels_tpu.maps.distance_map import DistanceVoxelMap as JDist
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import CountingVoxelMap as JCount
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.primitive_array import PrimitiveType as JPrimType

from gpu_voxels_tpu_torch import compat as tcompat
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap as TDist
from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap, _PyramidQueries
from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import CountingVoxelMap as TCount
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.primitive_array import PrimitiveType
from gpu_voxels_tpu_torch.utils import io as tio

MODELS = Path(__file__).resolve().parent.parent / "examples" / "models"

MATRIX_DIMS = 48
TYPES = [
    ("prob", MapType.MT_PROBAB_VOXELMAP),
    ("bit", MapType.MT_BITVECTOR_VOXELMAP),
    ("bitlist", MapType.MT_BITVECTOR_VOXELLIST),
    ("mortonlist", MapType.MT_BITVECTOR_MORTON_VOXELLIST),
    ("problist", MapType.MT_PROBAB_VOXELLIST),
    ("countlist", MapType.MT_COUNTING_VOXELLIST),
    ("hierbit", MapType.MT_BITVECTOR_OCTREE),
    ("hierprob", MapType.MT_PROBAB_OCTREE),
]
DENSE = {"prob", "bit"}
FACADE_TYPES = [MapType.MT_PROBAB_VOXELMAP, MapType.MT_BITVECTOR_VOXELMAP, MapType.MT_DISTANCE_VOXELMAP,
                MapType.MT_BITVECTOR_VOXELLIST, MapType.MT_BITVECTOR_MORTON_VOXELLIST, MapType.MT_PROBAB_VOXELLIST,
                MapType.MT_PROBAB_MORTON_VOXELLIST, MapType.MT_COUNTING_VOXELLIST, MapType.MT_BITVECTOR_OCTREE,
                MapType.MT_PROBAB_OCTREE]


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


def _supported(a: str, b: str) -> bool:
    if a in DENSE:
        return b in DENSE  # BitVoxelMap.h:37-38 / ProbVoxelMap.h:36-37
    return True  # lists and hierarchies collide with every tier


def _port_gvl(dims, side, **kw):
    g = TGvl()
    g.initialize(*dims, side, device="cpu", **kw)
    return g


def _ref_gvl(dims, side):
    g = JGvl()
    g.initialize(*dims, side)
    return g


def _count(r) -> int:
    return int(r[0] if isinstance(r, tuple) else r)


@pytest.mark.parametrize("seed", [3, 11])
def test_collision_matrix_vs_set_oracle(seed):
    """tests/test_collision_matrix.py's scene on the torch facade: every
    supported ordered pair == the set oracle, every unsupported pair raises
    TypeError; the bit maps without a summary (K7's form on the card)
    count the same."""
    rng = np.random.default_rng(seed)
    pts_a = rng.uniform(2.0, MATRIX_DIMS - 2.0, (400, 3)).astype(np.float32)
    pts_b = rng.uniform(2.0, MATRIX_DIMS - 2.0, (400, 3)).astype(np.float32)
    pts_b[:80] = pts_a[:80]  # guarantee overlap: share a slab of points

    def vox_set(pts):
        return {tuple(r) for r in np.floor(pts).astype(np.int64)}

    want = len(vox_set(pts_a) & vox_set(pts_b))
    assert want >= 80 - 5
    g = _port_gvl((MATRIX_DIMS,) * 3, 1.0)
    amaps, bmaps = {}, {}
    for n, t in TYPES:
        for side, pts, maps in (("A_", pts_a, amaps), ("B_", pts_b, bmaps)):
            g.add_map(t, side + n, capacity=2048)
            g.insert_point_cloud_into_map(pts, side + n)
            maps[n] = g.get_map(side + n)
    for an, _ in TYPES:
        for bn, _ in TYPES:
            if _supported(an, bn):
                assert _count(amaps[an].collide_with(bmaps[bn])) == want, (an, bn)
            else:
                with pytest.raises(TypeError):
                    amaps[an].collide_with(bmaps[bn])
    raw_a, raw_b = (TBit(m.data, m.dims, m.side_length) for m in (amaps["bit"], bmaps["bit"]))
    assert raw_a.occ is None and _count(raw_a.collide_with(raw_b)) == want


def _scene(dims, seed=5, n=200):
    rng = np.random.default_rng(seed)
    return (np.floor(rng.uniform(1, np.asarray(dims) - 1, (n, 3))) + 0.5).astype(np.float32)


def _insert(g, mt, name, pts):
    g.add_map(mt, name, capacity=16)
    meaning = 20 if mt in (MapType.MT_BITVECTOR_VOXELMAP, MapType.MT_BITVECTOR_VOXELLIST,
                           MapType.MT_BITVECTOR_MORTON_VOXELLIST) else BitVoxelMeaning.eBVM_OCCUPIED
    g.insert_point_cloud_into_map(pts, name, meaning)
    g.insert_point_cloud_into_map(pts[:30] + 1.0, name, BitVoxelMeaning.eBVM_FREE)
    if mt == MapType.MT_DISTANCE_VOXELMAP:
        g.set_map(name, g.get_map(name).parallel_banding())


def _same_map(a, b):
    na, nb = interop.to_numpy(a), interop.to_numpy(b)
    if isinstance(a, PagedHierarchicalMap):
        for k in interop.PAGED_ARRAYS:
            assert (na[k] is None and nb[k] is None) or np.array_equal(na[k], nb[k]), k
        assert na["slot_of"] == nb["slot_of"] and na["page_of"] == nb["page_of"]
        return
    if isinstance(a, VoxelList):  # a loaded list holds its entries without the spare capacity
        n = na[3]
        na, nb = (tuple(v[..., :n] for v in x[:3]) + (x[3],) for x in (na, nb))
    for x, y in zip(na if isinstance(na, tuple) else (na,), nb if isinstance(nb, tuple) else (nb,), strict=True):
        if isinstance(x, list):
            for p, q in zip(x, y, strict=True):
                np.testing.assert_array_equal(p, q)
        elif x is None or np.isscalar(x) or isinstance(x, int):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


def test_save_load_every_tier_byte_equal(tmp_path, monkeypatch):
    """save_map of every facade map type writes the reference facade's file
    byte for byte; load_map binds a map equal to the saved one; the paged
    tier through a second facade at 4096^3 (the dims are the facade's). The
    reference facade builds the dense maps and the counting list from the
    same scene; for the other tiers, whose inserts the other port test
    files hold against the reference's, it loads the port's file and saves
    it again (its compiles would cost ~12 s here)."""
    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / "vis"))
    dims, side = (32, 32, 32), 1.0
    pts = _scene(dims)
    tg, jg = _port_gvl(dims, side), _ref_gvl(dims, side)
    ref_built = (MapType.MT_PROBAB_VOXELMAP, MapType.MT_BITVECTOR_VOXELMAP, MapType.MT_COUNTING_VOXELLIST)
    for mt in FACADE_TYPES:
        tfile, jfile = tmp_path / f"t_{mt.name}.bin", tmp_path / f"j_{mt.name}.bin"
        _insert(tg, mt, mt.name, pts)
        assert tg.save_map(mt.name, tfile)
        if mt in ref_built:
            _insert(jg, mt, mt.name, pts)
        else:
            jg.load_map(mt.name, tfile)
        jg.save_map(mt.name, jfile)
        assert tfile.read_bytes() == jfile.read_bytes(), mt.name
        assert tg.load_map("loaded", jfile)
        loaded = tg.get_map("loaded")
        assert type(loaded) is type(tg.get_map(mt.name)) and loaded.map_type == mt
        _same_map(loaded, tg.get_map(mt.name))
        assert tg.visualize_map("loaded") and (tmp_path / "vis" / "loaded.cubes.json").exists()
    assert isinstance(tg.get_map(MapType.MT_BITVECTOR_OCTREE.name), HierarchicalBitMap)

    big = (4096, 4096, 4096)
    far = np.concatenate([pts * 100, pts[:20] * 7]).astype(np.float32)
    tp, jp = _port_gvl(big, side), _ref_gvl(big, side)
    for prob, mt in ((False, MapType.MT_BITVECTOR_OCTREE), (True, MapType.MT_PROBAB_OCTREE)):
        tp.add_map(mt, "paged")
        tp.insert_point_cloud_into_map(far, "paged")
        assert isinstance(tp.get_map("paged"), PagedHierarchicalMap) and tp.get_map("paged").probabilistic == prob
        tp.save_map("paged", tmp_path / "t_paged.bin")
        jp.load_map("paged", tmp_path / "t_paged.bin")
        jp.save_map("paged", tmp_path / "j_paged.bin")
        assert (tmp_path / "t_paged.bin").read_bytes() == (tmp_path / "j_paged.bin").read_bytes(), mt.name
        tp.load_map("back", tmp_path / "j_paged.bin")
        _same_map(tp.get_map("back"), tp.get_map("paged"))
        assert tp.del_map("paged") and tp.del_map("back") and "back" not in tp._vis


def test_ascii_octree_loads_through_the_facade(tmp_path):
    """F16 through the facade: the port's load_map reads an ascii octree
    file; the reference facade's cannot (its read_map takes "GPU_" for a
    MapType), and stays as it is."""
    dims = (32, 32, 32)
    tg, jg = _port_gvl(dims, 1.0), _ref_gvl(dims, 1.0)
    tg.add_map(MapType.MT_PROBAB_OCTREE, "h")
    tg.insert_point_cloud_into_map(_scene(dims), "h")
    tio.write_hierarchical_map(tg.get_map("h"), tmp_path / "h.txt", ascii=True)
    assert tg.load_map("back", tmp_path / "h.txt")
    _same_map(tg.get_map("back"), tg.get_map("h"))
    with pytest.raises(ValueError):
        jg.load_map("back", tmp_path / "h.txt")


def test_insert_point_cloud_from_file(tmp_path, monkeypatch):
    """xyz and binary pcd files through insert_point_cloud_from_file, with
    and without the model path and the shift / offset / scaling options:
    the map equals a direct insert of the same points and the reference
    facade's map."""
    dims = (32, 32, 32)
    rng = np.random.default_rng(9)
    pts = rng.uniform(0.5, 15.5, (500, 3)).astype(np.float32)
    jfiles.write_xyz(tmp_path / "c.xyz", pts)
    (tmp_path / "c.pcd").write_bytes(("FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\nWIDTH 500\nHEIGHT 1\n"
                                      "POINTS 500\nDATA binary\n").encode() + pts.astype("<f4").tobytes())
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(tmp_path))
    tg, jg = _port_gvl(dims, 1.0), _ref_gvl(dims, 1.0)
    opts = dict(shift_to_zero=True, offset_xyz=(1.25, 2.5, 0.75), scaling=1.5)
    for k, (fname, kw) in enumerate((("c.xyz", {}), ("c.pcd", opts), ("c.pcd", dict(use_model_path=True)))):
        path = fname if kw.get("use_model_path") else tmp_path / fname
        for g in (tg, jg):
            g.add_map(MapType.MT_BITVECTOR_VOXELMAP, f"m{k}")
            assert g.insert_point_cloud_from_file(f"m{k}", path, voxel_meaning=30, **kw)
        direct = TBit.create(dims, 1.0, device="cpu").insert_point_cloud(
            jfiles.load_point_cloud(path, kw.get("use_model_path", False), kw.get("shift_to_zero", False),
                                    kw.get("offset_xyz", (0, 0, 0)), kw.get("scaling", 1.0)), 30)
        got = tg.get_map(f"m{k}")
        assert torch.equal(got.data, direct.data) and int(got.occ.sum()) > 0
        np.testing.assert_array_equal(interop.to_numpy(got)[0], np.asarray(jg.get_map(f"m{k}").data))


def _boundary_gap(points: np.ndarray, side: float) -> float:
    v = points / side
    return float(np.abs(v - np.round(v)).min())


def test_add_robot_urdf_insert_and_collide(tmp_path, monkeypatch):
    """add_robot of examples/models/pan_tilt.urdf (252 mesh points) through
    the model path, swept through joint configurations into a bit map and
    collided with a box: the maps and counts equal the reference facade's.
    Every FK point keeps >= 1e-3 voxel from a cell boundary (F4), so the
    ulps between the frameworks cannot move a point across one."""
    monkeypatch.setenv("GPU_VOXELS_MODEL_PATH", str(MODELS))
    dims, side = (40, 40, 40), 0.023
    tg, jg = _port_gvl(dims, side), _ref_gvl(dims, side)
    configs = [{"pan_joint": 0.22, "tilt_joint": 0.47}, {"pan_joint": 0.58, "tilt_joint": -0.1},
               {"pan_joint": 0.88, "tilt_joint": 0.0}]
    for g in (tg, jg):
        assert g.add_robot("pt", "pan_tilt.urdf", use_model_path=True)
        g.add_map(MapType.MT_BITVECTOR_VOXELMAP, "sweep")
        g.add_map(MapType.MT_BITVECTOR_VOXELMAP, "box")
        g.insert_box_into_map((0.45, 0.1, 0.45), (0.62, 0.5, 0.6), "box", BitVoxelMeaning.eBVM_OCCUPIED, 2)
    assert tg.get_robot("pt").clouds.accumulated_size == 252
    for k, cfg in enumerate(configs):
        for g in (tg, jg):
            g.set_robot_configuration("pt", cfg)
            g.insert_robot_into_map("pt", "sweep", 30 + k)
        pts = tg.get_robot("pt").get_transformed_clouds().points.numpy()
        assert _boundary_gap(pts, side) >= 1e-3, cfg
    assert tg.get_robot_configuration("pt") == jg.get_robot_configuration("pt")
    got, want = tg.get_map("sweep"), jg.get_map("sweep")
    np.testing.assert_array_equal(interop.to_numpy(got)[0], np.asarray(want.data))
    count = int(got.collide_with(tg.get_map("box")))
    assert count == int(want.collide_with(jg.get_map("box"))) > 0
    with pytest.raises(FileNotFoundError):
        _port_gvl(dims, side).add_robot("x", tmp_path / "missing.urdf")


def test_primitives_reach_the_viewer_manifest(tmp_path, monkeypatch):
    """add / modify / get / del primitives and visualize_primitives_array:
    the layer equals the reference facade's byte for byte."""
    pd3 = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    for name, g in (("port", _port_gvl((8, 8, 8), 1.0)), ("ref", _ref_gvl((8, 8, 8), 1.0))):
        monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / name))
        assert g.add_primitives(PrimitiveType.ePRIM_SPHERE if name == "port" else JPrimType.ePRIM_SPHERE, "balls")
        assert g.get_primitives("balls").size == 0
        g.modify_primitives("balls", pd3, diameter=0.5)
        g.add_primitives(1, "boxes")
        g.modify_primitives("boxes", np.array([[[1, 1, 1, 2]]], np.float32))
        assert g.visualize_primitives_array("balls") and g.visualize_primitives_array("boxes")
        assert g.del_primitives("boxes") and g.del_primitives("never")
    tg = _port_gvl((8, 8, 8), 1.0)
    tg.add_primitives(PrimitiveType.ePRIM_CUBOID, "c")
    with pytest.raises(ValueError):
        tg.modify_primitives("c", pd3)
    arr, kind = interop.to_numpy(tg.get_primitives("c"))
    assert arr.shape == (0, 4) and kind == 1
    for fname in ("balls.cubes.json", "boxes.cubes.json"):
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "ref" / fname).read_bytes()
    layer = json.loads((tmp_path / "port" / "balls.cubes.json").read_text())
    assert layer["prim"] == "sphere" and layer["centers"] == [[1, 2, 3], [4, 5, 6]] and layer["scales"] == [0.5, 0.5]
    assert json.loads((tmp_path / "port" / "manifest.json").read_text())["maps"] == ["balls", "boxes"]


def test_visualize_map(tmp_path, monkeypatch):
    """visualize_map of a dense and an octree map through both facades:
    the same files byte for byte; an unchanged map repaints only when
    forced."""
    dims = (32, 32, 32)
    pts = _scene(dims, seed=8)
    for name, g in (("port", _port_gvl(dims, 0.5)), ("ref", _ref_gvl(dims, 0.5))):
        monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / name))
        for mt in (MapType.MT_PROBAB_VOXELMAP, MapType.MT_BITVECTOR_OCTREE):
            g.add_map(mt, mt.name)
            g.insert_point_cloud_into_map(pts * 0.5, mt.name)
            assert g.visualize_map(mt.name)
            assert not g.visualize_map(mt.name, force_repaint=False)
    for fname in sorted(p.name for p in (tmp_path / "ref").iterdir() if p.name != "manifest.json"):
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "ref" / fname).read_bytes(), fname


def test_print_voxel_map_data_equals_reference(capsys):
    """The dump of every dense map type equals the reference's string (bit
    planes and packed distances print as the reference's uint32)."""
    dims = (6, 5, 4)
    pts = np.array([[0.5, 0.5, 0.5], [3.5, 2.5, 1.5], [5.5, 4.5, 3.5]], np.float32)
    jb = JBit.create(dims, 1.0).insert_point_cloud(pts, 255).insert_point_cloud(pts[1:], 5)
    pairs = [
        (TProb.create(dims, 1.0, device="cpu").insert_point_cloud(pts),
         JProb.create(dims, 1.0).insert_point_cloud(pts)),
        (interop.bit_map_from_numpy(np.asarray(jb.data), np.asarray(jb.occ), dims, 1.0, "cpu"), jb),
        (TCount.create(dims, 1.0, device="cpu").insert_point_cloud(pts), JCount.create(dims, 1.0).insert_point_cloud(pts)),
        (TDist.create(dims, 1.0, device="cpu").insert_point_cloud(pts), JDist.create(dims, 1.0).insert_point_cloud(pts)),
    ]
    for t, j in pairs:
        want = j.print_voxel_map_data()
        capsys.readouterr()
        got = t.print_voxel_map_data()
        assert got == want and capsys.readouterr().out == want + "\n"
        assert t.print_voxel_map_data(max_entries=1) == j.print_voxel_map_data(max_entries=1)
    assert "4294967295" not in pairs[1][0].print_voxel_map_data() and "2147483648" in pairs[1][0].print_voxel_map_data()


def test_camelcase_alias_tables():
    """The alias tables equal the reference's name for name; every alias
    installs on at least one port class that has its target; the facade's
    camelCase spelling drives a scene."""
    for name in ("_FACADE_ALIASES", "_MAP_ALIASES", "_LIST_ALIASES", "_DISTANCE_ALIASES"):
        assert getattr(tcompat, name) == getattr(jcompat, name), name
    map_classes = (TProb, TBit, TCount, HierarchicalProbMap, HierarchicalBitMap, PagedHierarchicalMap, TDist)
    tables = [(tcompat._FACADE_ALIASES, (TGvl,)), (tcompat._MAP_ALIASES, map_classes),
              (tcompat._LIST_ALIASES, (VoxelList,)), (tcompat._DISTANCE_ALIASES, (TDist,))]
    for aliases, classes in tables:
        for camel, snake in aliases.items():
            holders = [c for c in classes if hasattr(c, snake)]
            assert holders, f"{camel} -> {snake}: no port class has it"
            for c in holders:
                assert getattr(c, camel) == getattr(c, snake), (c.__name__, camel)
    g = _port_gvl((150, 150, 150), 0.01)
    g.addMap(MapType.MT_PROBAB_VOXELMAP, "camelA")
    g.addMap(MapType.MT_PROBAB_VOXELMAP, "camelB")
    g.insertBoxIntoMap((0.4,) * 3, (0.8,) * 3, "camelA", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    g.insertBoxIntoMap((0.2,) * 3, (0.6,) * 3, "camelB", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    assert int(g.getMap("camelA").collideWith(g.getMap("camelB"))) == 8000
    assert g.getDimensions() == (150, 150, 150)


def test_multi_device_branch_names_item_13():
    """The facade's mesh (item 13) builds a slab-sharded value; its octree x
    octree collide (item 13b-ii) answers as the single-device map's."""
    from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh

    g = _port_gvl((8, 8, 8), 1.0)
    mesh = make_grid_mesh(8, devices=["cpu"])
    g.add_map(MapType.MT_PROBAB_OCTREE, "sharded", mesh=mesh)
    assert isinstance(g.add_map(MapType.MT_PROBAB_OCTREE, "h"), _PyramidQueries)
    pts = np.asarray([[0.5, 0.5, 0.5], [3.5, 2.5, 6.5], [7.5, 7.5, 7.5]], np.float32)
    for name in ("sharded", "h"):
        g.insert_point_cloud_into_map(pts, name)
    sharded, single = g.get_map("sharded"), g.get_map("h")
    assert_sharded(sharded, mesh)
    for level in (0, 2):
        assert int(sharded.collide_with(sharded, level)) == int(single.collide_with(single, level)) > 0


def test_sharded_pyramid_takes_the_camelcase_aliases():
    """compat.install gives a sharded pyramid the map aliases, as it gives
    the sharded dense maps: collideWith answers as the single map's."""
    from gpu_voxels_tpu_torch.parallel import make_grid_mesh, shard_map_value
    from gpu_voxels_tpu_torch.parallel.shard_value import ShardedPyramid

    single = HierarchicalBitMap.create((16, 16, 16), device="cpu").insert_point_cloud(
        np.asarray([[1.5, 2.5, 3.5], [9.5, 9.5, 14.5]], np.float32))
    sharded = shard_map_value(single, make_grid_mesh(8, devices=["cpu"]))
    assert ShardedPyramid.collideWith is ShardedPyramid.collide_with
    assert int(sharded.collideWith(single)) == int(single.collideWith(single)) == 2
    assert int(sharded.insertPointCloud(np.full((1, 3), 5.5, np.float32)).collideWith(single)) == 2


def test_mesh_dense_maps_answer_like_the_single_facade(tmp_path):
    """Dense maps added with mesh= (item 13b-i) answer every facade call as
    the unsharded facade's maps do, and stay sharded: a distance map's
    insert, jump_flood and queries; a prob map's meta insert and
    self-collision-aware robot insert; a bit map's meaning clear; save_map
    bytes and load_map."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh

    dims, mesh = (16, 16, 32), make_grid_mesh(8, devices=["cpu"])
    rng = np.random.default_rng(23)
    pts = (rng.uniform(0, 1, (300, 3)) * np.asarray(dims)).astype(np.float32)
    meta = MetaPointCloud.from_clouds([pts[:100], pts[50:150]], device="cpu")
    facades = {}
    for key, kw in (("sharded", {"mesh": mesh}), ("single", {})):
        g = _port_gvl(dims, 1.0)
        g.add_robot("arm", MODELS / "pan_tilt.urdf")
        for name, mt in (("dist", MapType.MT_DISTANCE_VOXELMAP), ("prob", MapType.MT_PROBAB_VOXELMAP),
                         ("bit", MapType.MT_BITVECTOR_VOXELMAP)):
            g.add_map(mt, name, **kw)
        g.insert_point_cloud_into_map(pts, "dist")
        g.update_map("dist", lambda m: m.jump_flood())
        g.insert_meta_point_cloud_into_map(meta, "prob", [BitVoxelMeaning.eBVM_OCCUPIED, 40])
        facades[key] = (g, g.insert_robot_into_map_self_collision_aware("arm", "prob"))
        g.insert_point_cloud_into_map(pts, "bit", 7)
        g.insert_point_cloud_into_map(pts[:40], "bit", 9)
        g.clear_map("bit", 7)
        for name in ("dist", "prob", "bit"):
            g.save_map(name, tmp_path / f"{key}_{name}.bin")
            g.load_map(name, tmp_path / f"{key}_{name}.bin")
    (gs, clash_s), (g1, clash_1) = facades["sharded"], facades["single"]
    assert bool(clash_s) == bool(clash_1)
    queries = (rng.uniform(0, 1, (40, 3)) * np.asarray(dims)).astype(np.float32)
    assert torch.equal(gs.get_map("dist").min_distance_to(queries), g1.get_map("dist").min_distance_to(queries))
    assert torch.equal(gs.get_map("dist").squared_distances(), g1.get_map("dist").squared_distances())
    for name in ("dist", "prob", "bit"):
        assert_sharded(gs.get_map(name), mesh)
        assert (tmp_path / f"sharded_{name}.bin").read_bytes() == (tmp_path / f"single_{name}.bin").read_bytes()
        assert torch.equal(gs.get_map(name).gather().data, g1.get_map(name).data), name
