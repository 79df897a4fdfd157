"""Port conformance: the slab forms of a sharded hierarchy
(parallel/shard_value.ShardedPyramid).

Every public method of HierarchicalBitMap and HierarchicalProbMap runs on a
pyramid split into 8 z-slabs of a CPU mesh (`make_grid_mesh(8,
devices=["cpu"])`) and must give exactly the port's single-device call on
the same inputs: every level's status bytes, the prob tier's occupancy,
counts, coordinate arrays in order, booleans and file bytes. The grid is
30 x 30 x 56 voxels, padded to 32 x 32 x 64 (4 levels): levels 0-3 split
into slabs, level 4 kept whole. The single-device calls are held against
the JAX package by the other test_torch_* files; three cases are also held
against the reference's own sharded value (`shard_map_value` on its
8-device virtual CPU mesh): the bit tier's depth image at carve_pool 1,
build(free_bounding_box=True) on the prob tier, and a sharded x sharded
collide.
"""
import inspect
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps.hierarchical import HierarchicalBitMap as JBitH
from gpu_voxels_tpu.maps.hierarchical import HierarchicalProbMap as JProbH
from gpu_voxels_tpu.parallel import make_grid_mesh as jmake_grid_mesh
from gpu_voxels_tpu.parallel import shard_map_value as jshard_map_value
from gpu_voxels_tpu.sensors import Sensor as JSensor
from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.ops import raycast_cuda
from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld, assert_sharded, make_grid_mesh, shard_map_value
from gpu_voxels_tpu_torch.parallel import shard_value
from gpu_voxels_tpu_torch.parallel.shard_value import ShardedPyramid, read_sharded_map
from gpu_voxels_tpu_torch.sensors import Sensor
from gpu_voxels_tpu_torch.utils import io


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


DIMS = (30, 30, 56)  # padded to 32 x 32 x 64 at 4 levels: 8 slabs of 8 rows
PADDED = (32, 32, 64)
SIDE = 0.125  # exact in f32
MESH = make_grid_mesh(8, devices=["cpu"])
TIERS = (HierarchicalBitMap, HierarchicalProbMap)
# tests/test_torch_shard_forms.py's edge-safe camera over the padded grid:
# axis-aligned at (16, 16, 0) voxels looking +z, every voxel centre
# projecting >= 1 / 508 pixel off a pixel and a pool-cell edge
INTR = (40.0, 40.0, 56.25, 56.25)
IMAGE = (112, 112)


def _sensor(cls=Sensor):
    fx, fy, cx, cy = INTR
    return cls(position=np.asarray([16 * SIDE, 16 * SIDE, 0.0], np.float32), data_width=IMAGE[1],
               data_height=IMAGE[0], fx=fx, fy=fy, cx=cx, cy=cy)


def _frame(seed: int = 0) -> np.ndarray:
    """Two planes and an invalid patch; every pixel whose world point lies
    within 2e-3 voxel of a cell boundary made invalid."""
    rng = np.random.default_rng(seed)
    h, w = IMAGE
    depth = np.full(IMAGE, 5.03, np.float32)
    depth[30:70, 20:60] = 3.07
    depth += rng.uniform(-0.01, 0.01, IMAGE).astype(np.float32)
    depth[80:95, 85:100] = 0.0
    fx, fy, cx, cy = INTR
    z = depth.astype(np.float64)
    u, v = np.arange(w, dtype=np.float64)[None, :], np.arange(h, dtype=np.float64)[:, None]
    world = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], axis=-1) + _sensor().position.astype(np.float64)
    f = world / SIDE
    depth[(np.abs(f - np.round(f)) < 2e-3).any(axis=-1)] = 0.0
    return depth


def _edge_margin(pool: int) -> float:
    """The least distance, in pixels, of a padded voxel centre's projection
    to a multiple of `pool`, over the voxels in front of the camera."""
    fx, fy, cx, cy = INTR
    dx, dy, dz = PADDED
    x = (np.arange(dx)[None, None, :] + 0.5) * SIDE - 16 * SIDE
    y = (np.arange(dy)[None, :, None] + 0.5) * SIDE - 16 * SIDE
    z = (np.arange(dz)[:, None, None] + 0.5) * SIDE
    least = np.inf
    for coord, f, c in ((x, fx, cx), (y, fy, cy)):
        p = f * coord / z + c
        least = min(least, float(np.abs(p / pool - np.round(p / pool)).min() * pool))
    return least


def _cloud(n, seed, lo=0.0, hi=1.0, dims=DIMS):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)) * np.asarray(dims) * SIDE).astype(np.float32)


def _map(cls, *clouds, dims=DIMS, device="cpu"):
    m = cls.create(dims, SIDE, device=device)
    for pts in clouds:
        m = m.insert_point_cloud(torch.tensor(pts))
    return m


def same(got, want, mesh=MESH) -> bool:
    """A sharded result against the single-device one: pyramids level by
    level (and the occupancy) through gather(), tensors, numbers, arrays and
    tuples of them exactly."""
    if isinstance(got, ShardedPyramid):
        if mesh is MESH:
            assert_sharded(got, mesh)
        g = got.gather()
        ok = type(g) is type(want) and g.dims == want.dims and len(g.pyramid) == len(want.pyramid)
        ok = ok and all(torch.equal(a, b) for a, b in zip(g.pyramid, want.pyramid))
        return ok and (not isinstance(want, HierarchicalProbMap) or torch.equal(g.occupancy, want.occupancy))
    if isinstance(got, tuple):
        return len(got) == len(want) and all(same(a, b, mesh) for a, b in zip(got, want))
    if isinstance(got, torch.Tensor):
        return got.device == mesh.first and got.dtype == want.dtype and torch.equal(got, want)
    if isinstance(got, np.ndarray):
        return got.dtype == want.dtype and np.array_equal(got, want)
    return type(got) is type(want) and got == want


@pytest.mark.parametrize("pool", [1, 2, 8])
def test_depth_image_slab_forms(pool, monkeypatch):
    """insert_depth_image of both tiers over the padded grid's slabs (K3 at
    carve_pool 1, K6's carve against one pooled table a frame past it),
    twice in a row, equals the single-device call; check_tree holds."""
    assert _edge_margin(pool) >= 1e-3
    pools = []
    real = raycast_cuda.min_pool_depth
    monkeypatch.setattr(raycast_cuda, "min_pool_depth", lambda *a, **k: pools.append(1) or real(*a, **k))
    sensor = _sensor()
    for cls in TIERS:
        single = _map(cls, _cloud(300, 1))
        sharded = shard_map_value(single, MESH)
        for seed in (0, 1):
            single = single.insert_depth_image(_frame(seed), sensor, carve_pool=pool)
            sharded = sharded.insert_depth_image(_frame(seed), sensor, carve_pool=pool)
            assert same(sharded, single), (cls.__name__, seed)
            assert sharded.check_tree()
        free = single.probe(torch.tensor(np.indices(PADDED).reshape(3, -1).T.astype(np.int32)))[2]
        assert int(free.sum()) > 1000
    # the sharded values' pools: once a frame, never once a slab
    assert len(pools) == (4 if pool > 1 else 0)


def test_dda_slab_forms():
    """insert_point_cloud_with_free_space of both tiers: the rays walked
    once for all slabs over the padded grid, with a short max_steps too."""
    pts = _cloud(400, 2, 0.1, 0.9)
    origin = (1.94, 2.06, 0.33)
    for cls in TIERS:
        single = _map(cls, _cloud(200, 3))
        sharded = shard_map_value(single, MESH)
        for steps in (256, 40):
            assert same(sharded.insert_point_cloud_with_free_space(pts, origin, steps),
                        single.insert_point_cloud_with_free_space(pts, origin, steps)), (cls.__name__, steps)


def test_build_and_point_inserts():
    """build with and without the free box (the box's rows cross slabs, the
    points reach the padding), point inserts at every meaning kind, the meta
    insert (the first meaning), propagate and clear_map."""
    pts = np.concatenate([_cloud(150, 4, 0.2, 0.7), [[3.9, 3.9, 7.9]]]).astype(np.float32)
    meta = MetaPointCloud.from_clouds([_cloud(60, 5), _cloud(40, 6)], device="cpu")
    for cls in TIERS:
        single = _map(cls, _cloud(200, 7))
        sharded = shard_map_value(single, MESH)
        for box in (False, True):
            assert same(sharded.build(pts, box), single.build(pts, box)), (cls.__name__, box)
        for meaning in (BitVoxelMeaning.eBVM_OCCUPIED, BitVoxelMeaning.eBVM_FREE, 12):
            assert same(sharded.insert_point_cloud(pts, meaning), single.insert_point_cloud(pts, meaning))
        for meanings in (None, [0, 4], [12, 0]):
            assert same(sharded.insert_meta_point_cloud(meta, meanings), single.insert_meta_point_cloud(meta, meanings))
        for name in ("propagate", "clear_map"):
            assert same(getattr(sharded, name)(), getattr(single, name)()), name
    bit = shard_map_value(_map(HierarchicalBitMap), MESH)
    assert same(bit.insert_point_cloud(pts, static_map=False),
                _map(HierarchicalBitMap).insert_point_cloud(pts, static_map=False))


def test_robot_configuration_with_a_clash_across_a_slab_boundary():
    """insert_robot_configuration: the clash (the OR of the slabs') where two
    sub-clouds share a voxel in slab 1's first row, none where they only
    touch across the boundary (rows 7 and 8)."""
    z7, z8 = 7.5 * SIDE, 8.5 * SIDE
    a = [[1.5 * SIDE, 1.5 * SIDE, z8], [4.5 * SIDE, 2.5 * SIDE, z7]]
    clash = MetaPointCloud.from_clouds([a, [[1.5 * SIDE, 1.5 * SIDE, z8]]], device="cpu")
    touch = MetaPointCloud.from_clouds([a, [[4.5 * SIDE, 2.5 * SIDE, z8]]], device="cpu")
    for cls in TIERS:
        single = _map(cls, _cloud(100, 8))
        sharded = shard_map_value(single, MESH)
        for robot, ok in ((clash, False), (touch, True)):
            for test in (False, True):
                got, want = sharded.insert_robot_configuration(robot, test), single.insert_robot_configuration(robot, test)
                assert same(got, want) and bool(want[1]) == (ok or not test)


def test_octree_collides_every_operand():
    """collide_with / collide_with_counting_unknown / collide_with_resolution
    / collide_with_hierarchical: sharded x sharded and sharded x plain both
    ways at levels 0-4 (split and whole), x a paged octree both ways, x a
    voxel list and a dense map with offsets; octree pairs refuse an offset,
    a paged world (which the reference's pyramid cannot pair) and padded
    dims that differ raise as the single call does."""
    for cls in TIERS:
        single, other = _map(cls, _cloud(500, 9)), _map(cls, _cloud(500, 10), _cloud(30, 11, 0.2, 0.3))
        sharded, sh_other = shard_map_value(single, MESH), shard_map_value(other, MESH)
        for level in range(5):
            want = single.collide_with(other, level)
            assert int(want) > 0
            for got in (sharded.collide_with(sh_other, level), sharded.collide_with(other, level),
                        sharded.collide_with_hierarchical(sh_other, level)):
                assert same(got, want), (cls.__name__, level)
            assert same(other.collide_with(sharded, level), other.collide_with(single, level))
            assert same(sharded.collide_with_resolution(sh_other, 1.0, level), single.collide_with_resolution(other, 1.0, level))
        with pytest.raises(ValueError, match="offset"):
            sharded.collide_with(sh_other, offset=(0, 0, 1))
        with pytest.raises(ValueError, match="greater than octree height"):
            sharded.collide_with_resolution(sh_other, 1.0, single.levels + 1)
        for m in (single, sharded):
            with pytest.raises(ValueError, match="share dimensions"):
                m.collide_with_hierarchical(_map(cls, dims=(30, 30, 80)))
        paged = PagedHierarchicalMap((64, 64, 64), SIDE, device="cpu").insert_point_cloud(_cloud(400, 12))
        for level in (0, 2):
            assert same(sharded.collide_with(paged, level), single.collide_with(paged, level))
            assert int(paged.collide_with(sharded, level)) == int(paged.collide_with(single, level)) > 0
        lst = VoxelList.create(DIMS, SIDE, "bit", 2048, device="cpu").insert_point_cloud(torch.tensor(_cloud(800, 13)))
        prob = ProbVoxelMap.create(DIMS, SIDE, device="cpu").insert_point_cloud(torch.tensor(_cloud(800, 14)))
        for op in (lst, prob):
            for level, off in ((0, (0, 0, 0)), (1, (1, -2, 9)), (3, (0, 0, -17))):
                assert same(sharded.collide_with(op, level, off), single.collide_with(op, level, off)), cls.__name__
                assert same(sharded.collide_with_counting_unknown(op, level, off),
                            single.collide_with_counting_unknown(op, level, off))
                assert same(sharded.collide_with_resolution(op, 1.0, level, off),
                            single.collide_with_resolution(op, 1.0, level, off))
        assert int(lst.collide_with(sharded, offset=(1, 0, -8))) == int(lst.collide_with(single, offset=(1, 0, -8))) > 0
        world = ShardedPagedWorld((64, 64, 128), SIDE, devices=["cpu"] * 2)
        for m in (single, sharded):
            with pytest.raises(TypeError):
                m.collide_with(world)


def test_maintenance_queries_and_properties():
    """padded_dims, status (level 0 joined on the first device), memory_usage,
    probes, extract_occupied_coords in z, y, x order, the no-op maintenance,
    clear_voxel_meaning's eBVM_OCCUPIED-only rule, check_tree against a level
    corrupted on one slab and on the whole tail; `to` raises."""
    for cls in TIERS:
        single = _map(cls, _cloud(500, 15), np.asarray([[3.9, 3.9, 7.9], [0.01, 0.01, 6.99]], np.float32))
        sharded = shard_map_value(single, MESH)
        assert sharded.padded_dims == single.padded_dims == PADDED
        assert sharded.memory_usage() == single.memory_usage()
        if cls is HierarchicalBitMap:
            assert same(sharded.status, single.status)
        else:
            with pytest.raises(AttributeError):
                sharded.status  # noqa: B018 - the prob tier has none, as the single map
        coords = torch.tensor(np.concatenate([np.indices((32, 32, 64)).reshape(3, -1).T[::7], [[-3, 2, 70]]]),
                              dtype=torch.int32)
        for level in (0, 2, 4):
            assert same(sharded.probe(coords, level), single.probe(coords, level))
            assert same(sharded.probe_status(coords, level), single.probe_status(coords, level))
        got = sharded.extract_occupied_coords()
        assert same(got, single.extract_occupied_coords()) and len(got) > 400
        assert sharded.needs_rebuild() is single.needs_rebuild() is False
        assert sharded.rebuild() is sharded and sharded.clear_collision_flags() is sharded
        for meaning in (BitVoxelMeaning.eBVM_OCCUPIED, 4):
            assert same(sharded.clear_voxel_meaning(meaning), single.clear_voxel_meaning(meaning))
        assert sharded.check_tree() is single.check_tree() is True
        for level in (2, 4):  # split (slab 5 of level 2), whole (level 4)
            broken = shard_map_value(single, MESH)
            lv = broken.pyramid[level]
            part = lv[5] if isinstance(lv, list) else lv
            part.view(-1)[3] ^= 0xFF
            assert broken.check_tree() is False, level
        with pytest.raises(TypeError, match="gather"):
            sharded.to("cpu")


def test_files_byte_equal_slab_by_slab(tmp_path, monkeypatch):
    """write_to_disk and io.write_hierarchical_map(ascii=True): the single
    map's bytes, written slab by slab (gather() never called, one host read
    a slab); read_from_disk and read_sharded_map read every slab onto its
    device; the facade's mesh octree saves and loads slab by slab."""
    for cls in TIERS:
        single = _map(cls, _cloud(400, 16))
        sharded = shard_map_value(single, MESH)
        io.write_hierarchical_map(single, tmp_path / "single.bin")
        io.write_hierarchical_map(single, tmp_path / "single.txt", ascii=True)
        with monkeypatch.context() as mp:
            mp.setattr(ShardedPyramid, "gather", lambda *a: pytest.fail("a file is written slab by slab"))
            reads = []
            real_cpu = torch.Tensor.cpu
            mp.setattr(torch.Tensor, "cpu", lambda t, *a: reads.append(t.shape[0]) or real_cpu(t, *a))
            assert sharded.write_to_disk(tmp_path / "sharded.bin")
            assert reads == [8] * 8
            io.write_map(sharded, tmp_path / "sharded2.bin")
            io.write_hierarchical_map(sharded, tmp_path / "sharded.txt", ascii=True)
        for name in ("sharded.bin", "sharded2.bin"):
            assert (tmp_path / name).read_bytes() == (tmp_path / "single.bin").read_bytes()
        assert (tmp_path / "sharded.txt").read_bytes() == (tmp_path / "single.txt").read_bytes()
        for path in ("single.bin", "single.txt"):
            back = sharded.read_from_disk(tmp_path / path)
            assert isinstance(back, ShardedPyramid) and back.mesh is MESH and same(back, single)
            assert same(read_sharded_map(tmp_path / path, MESH), single.read_from_disk(tmp_path / path))
        other = HierarchicalProbMap if cls is HierarchicalBitMap else HierarchicalBitMap
        with pytest.raises(ValueError, match="file holds"):
            shard_map_value(_map(other), MESH).read_from_disk(tmp_path / "single.bin")
    paged = PagedHierarchicalMap((64, 64, 64), SIDE, device="cpu").insert_point_cloud(_cloud(50, 17))
    paged.write_to_disk(tmp_path / "paged.bin")
    back = shard_map_value(_map(HierarchicalBitMap), MESH).read_from_disk(tmp_path / "paged.bin")
    assert isinstance(back, PagedHierarchicalMap) and back.n_tiles() == paged.n_tiles()
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(*DIMS, SIDE, device="cpu")
    gvl.add_map(MapType.MT_PROBAB_OCTREE, "octree", mesh=MESH)
    gvl.insert_point_cloud_into_map(_cloud(300, 18), "octree")
    assert gvl.save_map("octree", tmp_path / "facade.bin")
    want = _map(HierarchicalProbMap, _cloud(300, 18))
    io.write_map(want, tmp_path / "want.bin")
    assert (tmp_path / "facade.bin").read_bytes() == (tmp_path / "want.bin").read_bytes()
    gvl.clear_map("octree")
    assert gvl.load_map("octree", tmp_path / "facade.bin")
    assert isinstance(gvl.get_map("octree"), ShardedPyramid) and same(gvl.get_map("octree"), want)
    GpuVoxels._instance = None


def test_level_zero_that_does_not_split():
    """A padded z extent that does not divide the mesh (12 rows padded to 16
    over 6 slabs): the bit tier keeps every level whole on the first device,
    as the reference replicates it, and answers as the single map (it fails
    assert_sharded, as the reference's value does); the prob tier raises
    ValueError, as the reference's device_put of its occupancy does."""
    mesh = make_grid_mesh(6, devices=["cpu"])
    dims = (8, 8, 12)
    pts = _cloud(60, 19, dims=dims)
    single = _map(HierarchicalBitMap, pts[:30], dims=dims)
    sharded = shard_map_value(single, mesh)
    assert not any(isinstance(lv, list) for lv in sharded.pyramid) and single.padded_dims == (8, 8, 16)
    with pytest.raises(AssertionError, match="slabs"):
        assert_sharded(sharded, mesh)
    origin = (0.5, 0.5, 0.1)
    for got, want in ((sharded.insert_point_cloud(pts), single.insert_point_cloud(pts)),
                      (sharded.build(pts, True), single.build(pts, True)),
                      (sharded.insert_point_cloud_with_free_space(pts, origin), single.insert_point_cloud_with_free_space(pts, origin)),
                      (sharded.collide_with(single, 1), single.collide_with(single, 1)),
                      (sharded.extract_occupied_coords(), single.extract_occupied_coords()),
                      (sharded.check_tree(), single.check_tree())):
        assert same(got, want, mesh)
    with pytest.raises(ValueError, match="padded z extent"):
        shard_map_value(_map(HierarchicalProbMap, dims=dims), mesh)


def test_every_pyramid_method_has_a_slab_form():
    """Reflection: every public instance method and property of both
    classes is an attribute of ShardedPyramid and answers (`to`, the port's
    placement helper, raises TypeError instead); shard_value.py holds no
    NotImplementedError."""
    for cls in TIERS:
        names = [n for n, v in inspect.getmembers(cls) if not n.startswith("_")
                 and (callable(v) or isinstance(inspect.getattr_static(cls, n), property))
                 and not isinstance(inspect.getattr_static(cls, n), staticmethod)]
        assert len(names) >= 24, cls
        sharded = shard_map_value(_map(cls), MESH)
        for name in names:
            assert hasattr(ShardedPyramid, name), (cls.__name__, name)
            if name != "to":
                getattr(sharded, name)
    src = pathlib.Path(inspect.getsourcefile(shard_value)).read_text()
    assert "NotImplementedError" not in src and "ITEM_13B" not in src


@pytest.fixture(scope="module")
def reference_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jmake_grid_mesh(8)


def test_slab_forms_match_the_reference_sharded_value(reference_mesh):
    """Three slab forms against the reference's shard_map_value on its
    8-device mesh: the bit tier's depth image at carve_pool 1 (edge-safe
    camera), build(free_bounding_box=True) on the prob tier, and a sharded x
    sharded collide at levels 0 and 3; and the reference's refusal of a prob
    pyramid whose padded z extent does not divide its mesh."""
    frame, base = _frame(3), _cloud(300, 20)
    j = jshard_map_value(JBitH.create(DIMS, SIDE).insert_point_cloud(jnp.asarray(base)), reference_mesh)
    j = j.insert_depth_image(frame, _sensor(JSensor))
    t = shard_map_value(_map(HierarchicalBitMap, base), MESH).insert_depth_image(frame, _sensor())
    for got, want in zip(t.gather().pyramid, j.pyramid, strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    pts = _cloud(200, 21, 0.2, 0.7)
    j = jshard_map_value(JProbH.create(DIMS, SIDE), reference_mesh).build(jnp.asarray(pts), free_bounding_box=True)
    t = shard_map_value(_map(HierarchicalProbMap), MESH).build(pts, free_bounding_box=True)
    np.testing.assert_array_equal(t.gather().occupancy.numpy(), np.asarray(j.occupancy))
    for got, want in zip(t.gather().pyramid, j.pyramid, strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    a, b = _cloud(500, 22), _cloud(500, 23)
    ja = jshard_map_value(JBitH.create(DIMS, SIDE).insert_point_cloud(jnp.asarray(a)), reference_mesh)
    jb = jshard_map_value(JBitH.create(DIMS, SIDE).insert_point_cloud(jnp.asarray(b)), reference_mesh)
    sa, sb = shard_map_value(_map(HierarchicalBitMap, a), MESH), shard_map_value(_map(HierarchicalBitMap, b), MESH)
    for level in (0, 3):
        assert int(sa.collide_with(sb, level)) == int(ja.collide_with(jb, level)) > 0
    with pytest.raises(ValueError):
        jshard_map_value(JProbH.create((8, 8, 12), 1.0), jmake_grid_mesh(6))
