"""Port conformance: the slab forms of a sharded dense map
(parallel/shard_value.ShardedDenseMap).

Every public instance method of ProbVoxelMap, BitVectorVoxelMap,
CountingVoxelMap and DistanceVoxelMap runs on a value split into 8 z-slabs
of a CPU mesh (`make_grid_mesh(8, devices=["cpu"])`) and must give exactly
the port's single-device call on the same inputs: counts, marked maps,
masks, meanings, EDT distances and payloads, strings and file bytes. The
single-device calls are held against the JAX package by the other
test_torch_* files; three cases are also held against the reference's own
sharded value (`shard_map_value` on its 8-device virtual CPU mesh): a depth
image at carve_pool 1, a marking collide whose offset crosses a slab, and
parallel_banding. The pooled carve's `z_index_offset` is checked in its
plain spec: the slabs stacked equal the whole grid's mask.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps.distance_map import DistanceVoxelMap as JDist
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.parallel import make_grid_mesh as jmake_grid_mesh
from gpu_voxels_tpu.parallel import shard_map_value as jshard_map_value
from gpu_voxels_tpu.sensors import Sensor as JSensor
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import raycast, raycast_cuda
from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh, shard_map_value
from gpu_voxels_tpu_torch.parallel.shard_value import ShardedDenseMap
from gpu_voxels_tpu_torch.sensors import Sensor


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


DIMS = (32, 32, 64)  # 8 slabs of 8 rows
SIDE = 0.125  # exact in f32: voxel centres are exact multiples of 1/16
MESH = make_grid_mesh(8, devices=["cpu"])
# the camera: axis-aligned at (16, 16, 0) voxels, looking +z; voxel (x, z)
# projects to u - 56 = (4 fx (2x - 31) + 2z + 1) / (4 (2z + 1)) (cx = 56.25,
# fx = 40; 56 divides by every P below), an odd numerator over an even
# denominator, so every voxel centre projects >= 1 / 508 pixel off a pixel
# and a pool-cell edge (v likewise)
INTR = (40.0, 40.0, 56.25, 56.25)
IMAGE = (112, 112)
POOLS = (2, 4, 7, 8)


def _sensor(cls=Sensor):
    fx, fy, cx, cy = INTR
    return cls(position=np.asarray([16 * SIDE, 16 * SIDE, 0.0], np.float32), data_width=IMAGE[1],
               data_height=IMAGE[0], fx=fx, fy=fy, cx=cx, cy=cy)


def _frame(seed: int = 0) -> np.ndarray:
    """A depth frame of two planes and an invalid patch, every pixel whose
    world point lies within 2e-3 voxel of a cell boundary made invalid."""
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
    """The least distance, in pixels, of a voxel centre's projection to a
    multiple of `pool` (a pool-cell edge), over the voxels in front."""
    fx, fy, cx, cy = INTR
    dx, dy, dz = DIMS
    x = (np.arange(dx)[None, None, :] + 0.5) * SIDE - 16 * SIDE
    y = (np.arange(dy)[None, :, None] + 0.5) * SIDE - 16 * SIDE
    z = (np.arange(dz)[:, None, None] + 0.5) * SIDE
    least = np.inf
    for coord, f, c in ((x, fx, cx), (y, fy, cy)):
        p = f * coord / z + c
        least = min(least, float(np.abs(p / pool - np.round(p / pool)).min() * pool))
    return least


def _cloud(n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, (n, 3)) * np.asarray(DIMS) * SIDE).astype(np.float32)


def _maps(cls, *clouds):
    m = cls.create(DIMS, SIDE, device="cpu")
    for pts in clouds:
        m = m.insert_point_cloud(torch.tensor(pts))
    return m


def same(got, want) -> bool:
    """A sharded result against the single-device one: maps field by field
    through gather(), tensors, numbers and tuples of them exactly."""
    if isinstance(got, ShardedDenseMap):
        assert_sharded(got, MESH)
        g = got.gather()
        if type(g) is not type(want) or g.dims != want.dims or not torch.equal(g.data, want.data):
            return False
        occ_g, occ_w = getattr(g, "occ", None), getattr(want, "occ", None)
        return (occ_g is None) == (occ_w is None) and (occ_w is None or torch.equal(occ_g, occ_w))
    if isinstance(got, tuple):
        return len(got) == len(want) and all(same(a, b) for a, b in zip(got, want))
    if isinstance(got, torch.Tensor):
        return got.device == MESH.first and got.dtype == want.dtype and torch.equal(got, want)
    return got == want


@pytest.mark.parametrize("pool", POOLS)
def test_pooled_carve_slabs_stack_to_the_whole_mask(pool):
    """The pooled carve's plain spec with `z_index_offset`: the 8 slabs'
    masks stacked equal the whole grid's bit for bit, and offset 0 is the
    call without one; against a prebuilt table as well."""
    assert _edge_margin(pool) >= 1e-3
    depth, pose = torch.tensor(_frame()), torch.tensor(_sensor().pose())
    args = (depth, pose, *INTR, SIDE)
    whole = raycast.projective_free_space_pooled(*args, DIMS, pool=pool)
    assert int(whole.sum()) > 1000
    slab = (DIMS[0], DIMS[1], 8)
    stacked = torch.cat([raycast.projective_free_space_pooled(*args, slab, pool=pool, z_index_offset=z0)
                         for z0 in range(0, DIMS[2], 8)])
    assert torch.equal(stacked, whole)
    pm = raycast.min_pool_depth(depth, pool)
    on_table = torch.cat([raycast_cuda.carve_against_pooled(pm, pool, IMAGE, pose, *INTR, SIDE, slab, z_index_offset=z0)
                          for z0 in range(0, DIMS[2], 8)])
    assert torch.equal(on_table, whole)
    assert torch.equal(raycast.projective_free_space_pooled(*args, slab, pool=pool, z_index_offset=0),
                       raycast.projective_free_space_pooled(*args, slab, pool=pool))


@pytest.mark.parametrize("pool", [1, 8])
def test_depth_image_slab_form(pool, monkeypatch):
    """insert_depth_image slab by slab (K3, or K6 against one pooled table a
    frame), twice in a row, equals the single-device call."""
    pools = []
    real = raycast_cuda.min_pool_depth
    monkeypatch.setattr(raycast_cuda, "min_pool_depth", lambda *a, **k: pools.append(1) or real(*a, **k))
    sensor = _sensor()
    single = _maps(ProbVoxelMap, _cloud(500, 1))
    sharded = shard_map_value(single, MESH)
    for seed in (0, 1):
        frame = _frame(seed)
        single = single.insert_depth_image(frame, sensor, carve_pool=pool)
        sharded = sharded.insert_depth_image(frame, sensor, carve_pool=pool)
        assert same(sharded, single)
    assert len(pools) == (2 if pool > 1 else 0)  # the sharded value's pool: once a frame, never once a slab
    assert int((single.data != _maps(ProbVoxelMap, _cloud(500, 1)).data).sum()) > 1000


def test_sensor_data_slab_form():
    """insert_sensor_data (the DDA walked once for all slabs), with and
    without the stored sensor, raycasting and a cut-out robot given as a
    sharded map, a plain map and a mask; update_occupancy; the stored
    sensor rides on every derived value."""
    pts = _cloud(400, 2, 0.2, 0.8)
    robot = _maps(ProbVoxelMap, pts[:60])
    single = _maps(ProbVoxelMap, _cloud(300, 3))
    sharded = shard_map_value(single, MESH)
    origin = (2.06, 1.94, 0.33)
    for kw in ({}, {"enable_raycasting": False}, {"max_steps": 40}):
        assert same(sharded.insert_sensor_data(pts, sensor_origin=origin, **kw),
                    single.insert_sensor_data(pts, sensor_origin=origin, **kw))
    want = single.insert_sensor_data(pts, sensor_origin=origin, cut_real_robot=True, robot_map=robot)
    for r in (robot, shard_map_value(robot, MESH), robot.occupied_mask()):
        assert same(sharded.insert_sensor_data(pts, sensor_origin=origin, cut_real_robot=True, robot_map=r), want)
    sensor = Sensor(position=np.asarray([1.9, 2.1, 0.4], np.float32),
                    orientation_rpy=np.asarray([0.2, -0.1, 0.5], np.float32))
    with pytest.raises(RuntimeError, match="Initialize Sensor first"):
        sharded.update_sensor_pose(sensor)
    single.init_sensor_settings(sensor)
    sharded.init_sensor_settings(sensor)
    got, want = sharded.insert_sensor_data(pts), single.insert_sensor_data(pts)
    assert same(got, want) and got.clear_map()._sensor is sensor and got.gather()._sensor is sensor
    sharded.update_sensor_pose(Sensor(position=np.asarray([0.4, 0.4, 0.4], np.float32)))
    assert same(sharded.insert_sensor_data(pts), single.insert_sensor_data(pts))
    assert same(sharded.update_occupancy(pts, -7), single.update_occupancy(pts, -7))


def _meta():
    """Three sub-clouds; the second and third share voxels with the first."""
    a = _cloud(200, 4, 0.3, 0.7)
    return MetaPointCloud.from_clouds([a, np.concatenate([a[:30], _cloud(50, 5)]), a[100:140]], device="cpu")


def test_robot_slab_forms():
    """The meta inserts (the prob tier's later point wins through global
    ranks), the self-collision clash (the OR of the slabs') and
    insert_robot_configuration on every tier that has it, get_bit_mask."""
    meta = _meta()
    apart = MetaPointCloud.from_clouds([_cloud(40, 6, 0.0, 0.4), _cloud(40, 7, 0.6, 1.0)], device="cpu")
    meanings = [4, 12, 40]
    for cls in (ProbVoxelMap, BitVectorVoxelMap, DistanceVoxelMap):
        single = _maps(cls, _cloud(100, 8))
        sharded = shard_map_value(single, MESH)
        if cls is not DistanceVoxelMap:
            assert same(sharded.insert_meta_point_cloud(meta, meanings), single.insert_meta_point_cloud(meta, meanings))
            assert same(sharded.insert_meta_point_cloud(meta), single.insert_meta_point_cloud(meta))
        for m in (meta, apart):
            for test in (False, True):
                got = sharded.insert_robot_configuration(m, test)
                want = single.insert_robot_configuration(m, test)
                assert same(got, want)
            assert bool(want[1]) == (m is apart)
        if cls is ProbVoxelMap:
            got = sharded.insert_meta_point_cloud_with_self_collision_check(meta)
            assert same(got, single.insert_meta_point_cloud_with_self_collision_check(meta)) and bool(got[1])
        if cls is BitVectorVoxelMap:
            bits = single.insert_meta_point_cloud(meta, meanings)
            for meaning in (4, 12, 1):
                assert same(shard_map_value(bits, MESH).get_bit_mask(meaning), bits.get_bit_mask(meaning))


# a[i + off] against b[i]: within a slab, one and two slab boundaries away, negative
OFFSETS = [(0, 0, 0), (1, -2, 5), (0, 0, 9), (3, 1, -17), (-5, 3, -9), (2, 0, 23)]


@pytest.mark.parametrize("offset", OFFSETS)
def test_marking_collide_and_collides_with(offset):
    """collide_with_marking: K2 once per run of slabs the offset pairs, the
    marks on a's slab, the count summed; collides_with; against a plain
    and a sharded operand."""
    a, b = _maps(ProbVoxelMap, _cloud(3000, 9)), _maps(ProbVoxelMap, _cloud(3000, 10))
    sa = shard_map_value(a, MESH)
    want = a.collide_with_marking(b, 0.5, offset)
    assert int(want[0]) > 0
    for other in (b, shard_map_value(b, MESH)):
        assert same(sa.collide_with_marking(other, 0.5, offset), want)
        assert same(sa.collides_with(other, 0.5, offset), a.collides_with(b, 0.5, offset))
    assert same(sa.collides_with(_maps(ProbVoxelMap), 0.5, offset), torch.tensor(False))


@pytest.mark.parametrize("dz", [64, 48])  # 8- and 6-deep slabs: 2^level cubes cross them from level 3 / 1 on
def test_resolution_collide(dz):
    """collide_with_resolution for prob x prob, prob x bit, bit x bit and
    bit x prob at levels 0-4 and geometric offsets that cross slabs: the
    cubes a slab boundary cuts are ORed from the slabs' partial cubes."""
    dims = (32, 32, dz)
    rng = np.random.default_rng(11)
    clouds = [(rng.uniform(0, 1, (1500, 3)) * np.asarray(dims) * SIDE).astype(np.float32) for _ in range(2)]
    maps = {}
    for cls in (ProbVoxelMap, BitVectorVoxelMap):
        maps[cls] = [cls.create(dims, SIDE, device="cpu").insert_point_cloud(torch.tensor(c)) for c in clouds]
    for ca in maps:
        sa = shard_map_value(maps[ca][0], MESH)
        for cb in maps:
            for level in range(5):
                for off in ((0, 0, 0), (1, -2, 7), (0, 3, -13)):
                    want = maps[ca][0].collide_with_resolution(maps[cb][1], 0.5, level, off)
                    assert same(sa.collide_with_resolution(maps[cb][1], 0.5, level, off), want), (ca, cb, level, off)


def test_distance_tier_slab_forms():
    """Every DistanceVoxelMap method slab by slab: obstacles store their
    global coordinates; the EDTs (parallel_banding, the flat JFA route of
    jump_flood, exact_separable, exact_distances) equal the single-device
    packed grids; the queries their answers."""
    pts = _cloud(60, 12)
    single = _maps(DistanceVoxelMap, pts)
    sharded = shard_map_value(single, MESH)
    prob = _maps(ProbVoxelMap, _cloud(40, 13))
    assert same(sharded.insert_point_cloud(torch.tensor(pts)), single)
    for p in (prob, shard_map_value(prob, MESH)):
        assert same(sharded.merge_occupied(p), single.merge_occupied(prob))
    single, sharded = single.merge_occupied(prob), sharded.merge_occupied(prob)
    for name in ("parallel_banding", "jump_flood", "exact_separable"):
        assert same(getattr(sharded, name)(), getattr(single, name)()), name
    assert same(sharded.jump_flood(2), single.jump_flood(2))
    coords = np.floor(pts / SIDE).astype(np.int32)[:25]
    assert same(sharded.exact_distances(coords), single.exact_distances(coords))
    edt1, edts = single.parallel_banding(), sharded.parallel_banding()
    for name in ("squared_distances", "extract_distances", "init_floodfill", "obstacle_mask"):
        assert same(getattr(edts, name)(), getattr(edt1, name)()), name
    assert same(edts.extract_distances(3), edt1.extract_distances(3))
    for xyz in ((0, 0, 0), (5, 30, 17), (31, 31, 63), (7, 2, 40)):
        assert same(edts.get_squared_obstacle_distance(*xyz), edt1.get_squared_obstacle_distance(*xyz))
        assert same(edts.get_obstacle_distance(*xyz), edt1.get_obstacle_distance(*xyz))
    queries = np.concatenate([_cloud(50, 14), [[-1.0, 0.0, 0.0], [0.5, 0.5, 9.0]]]).astype(np.float32)
    assert same(edts.min_distance_to(queries), edt1.min_distance_to(queries))
    assert same(edts.min_distance_to(queries[-2:]), edt1.min_distance_to(queries[-2:]))
    jfa1 = single.jump_flood(2)
    assert same(edts.differences(jfa1), edt1.differences(jfa1)) and same(edts.differences(edts), edt1.differences(edt1))
    for name in ("fill_pba_uninit", "clear_map"):
        assert same(getattr(edts, name)(), getattr(edt1, name)())
    for meaning in (1, 4):  # eBVM_OCCUPIED resets, any other logs and leaves the map
        assert same(edts.clear_voxel_meaning(meaning), edt1.clear_voxel_meaning(meaning))


def test_jump_flood_multires_route_on_slabs(monkeypatch):
    """The CPU route of jump_flood at min(dims) >= 128 with every dim a
    multiple of 4: the multires JFA with the single-device rules, on a
    scene where its 64-round repair cap binds (two sites in one coarse
    block: the farther one's cell is repaired a voxel a round) and its step
    8 reaches past the 4-deep slabs."""
    from gpu_voxels_tpu_torch.ops import edt, edt_envelope
    from gpu_voxels_tpu_torch.parallel import sharded_edt

    dims = (128, 4, 32)
    single = DistanceVoxelMap.create(dims, 1.0, device="cpu").insert_point_cloud(
        np.asarray([[1.5, 0.5, 0.5], [3.5, 0.5, 0.5]], np.float32))
    want, rounds = edt.jump_flood_multires_with_stats(single.data, dims)
    exact = edt_envelope.parallel_banding(single.data, dims)
    assert rounds == 64 and not torch.equal(edt.squared_distance_grid(want, dims), edt.squared_distance_grid(exact, dims))
    got = sharded_edt.jump_flood_slabs(list(torch.chunk(single.data, 8)), dims, MESH.z_devices(), multires=True)
    assert torch.equal(torch.cat(got), want)
    routes = []
    monkeypatch.setattr(sharded_edt, "jump_flood_slabs", lambda slabs, *a, **k: routes.append(k) or list(slabs))
    big = shard_map_value(DistanceVoxelMap.create((128, 128, 128), 1.0, device="cpu"), MESH)
    big.jump_flood()
    big.jump_flood(2)
    assert routes == [{"multires": True}, {}]


@pytest.mark.parametrize("cls", [ProbVoxelMap, BitVectorVoxelMap, CountingVoxelMap, DistanceVoxelMap])
def test_queries_and_files_slab_forms(cls, tmp_path, monkeypatch):
    """The whole-grid results (joined on the mesh's first device), clone,
    memory_usage, print_voxel_map_data (the same string) and the files: the
    single map's bytes written slab by slab (gather() never called), read
    back sharded over the same mesh."""
    single = _maps(cls, _cloud(300, 16), _cloud(50, 17, 0.1, 0.2))
    sharded = shard_map_value(single, MESH)
    for name in ("occupancy", "occupied_mask", "as_3d"):
        if hasattr(cls, name):
            assert same(getattr(sharded, name)(), getattr(single, name)()), name
    if cls is ProbVoxelMap:
        assert same(sharded.occupied_mask(0.9), single.occupied_mask(0.9))
    cloned = sharded.clone()
    assert same(cloned, single) and all(c.data is not s.data for c, s in zip(cloned.slabs, sharded.slabs))
    assert sharded.memory_usage() == single.memory_usage() and sharded.dimensions == single.dimensions
    assert sharded.metric_dimensions == single.metric_dimensions
    assert sharded.print_voxel_map_data(5) == single.print_voxel_map_data(5)
    single.write_to_disk(tmp_path / "single.bin")
    monkeypatch.setattr(ShardedDenseMap, "gather", lambda *a: pytest.fail("a file is written slab by slab"))
    reads = []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a: reads.append(t.numel()) or real_cpu(t, *a))
    assert sharded.write_to_disk(tmp_path / "sharded.bin")
    assert reads == [s.data.numel() for s in sharded.slabs]  # one read a slab
    assert (tmp_path / "sharded.bin").read_bytes() == (tmp_path / "single.bin").read_bytes()
    monkeypatch.undo()
    back = sharded.read_from_disk(tmp_path / "single.bin")
    assert isinstance(back, ShardedDenseMap) and back.mesh is MESH
    assert same(back, single.read_from_disk(tmp_path / "single.bin"))


def test_every_dense_method_has_a_slab_form():
    """Reflection: every public instance method of the four dense classes is
    an attribute of ShardedDenseMap, and none raises NotImplementedError
    (the static constructors excluded)."""
    for cls in (ProbVoxelMap, BitVectorVoxelMap, CountingVoxelMap, DistanceVoxelMap):
        names = [n for n, v in inspect.getmembers(cls) if not n.startswith("_") and callable(v)
                 and not isinstance(inspect.getattr_static(cls, n), staticmethod)]
        assert len(names) >= 9, cls
        sharded = shard_map_value(cls.create(DIMS, SIDE, device="cpu"), MESH)
        for name in names:
            assert hasattr(ShardedDenseMap, name), (cls.__name__, name)
            assert callable(getattr(sharded, name)), (cls.__name__, name)
        src = inspect.getsource(ShardedDenseMap)
        assert "NotImplementedError" not in src


def _jmesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return jmake_grid_mesh(8)


def test_slab_forms_match_the_reference_sharded_value():
    """Three slab forms against the reference's shard_map_value on its
    8-device mesh: insert_depth_image at carve_pool 1 (edge-safe pose),
    collide_with_marking at an offset that crosses a slab, and
    DistanceVoxelMap.parallel_banding."""
    jmesh = _jmesh()
    data = np.random.default_rng(18).integers(-128, 128, DIMS[0] * DIMS[1] * DIMS[2]).astype(np.int8)
    frame = _frame(2)
    j = jshard_map_value(JProb(jnp.asarray(data), DIMS, SIDE), jmesh).insert_depth_image(frame, _sensor(JSensor))
    t = shard_map_value(ProbVoxelMap(torch.tensor(data), DIMS, SIDE), MESH).insert_depth_image(frame, _sensor())
    np.testing.assert_array_equal(t.gather().data.numpy(), np.asarray(j.data))

    a, b = _cloud(3000, 19), _cloud(3000, 20)
    ja = jshard_map_value(JProb.create(DIMS, SIDE).insert_point_cloud(jnp.asarray(a)), jmesh)
    jb = jshard_map_value(JProb.create(DIMS, SIDE).insert_point_cloud(jnp.asarray(b)), jmesh)
    j_cnt, j_marked = ja.collide_with_marking(jb, 0.5, (3, 1, -17))
    sa = shard_map_value(_maps(ProbVoxelMap, a), MESH)
    t_cnt, t_marked = sa.collide_with_marking(shard_map_value(_maps(ProbVoxelMap, b), MESH), 0.5, (3, 1, -17))
    assert int(t_cnt) == int(j_cnt) > 0
    np.testing.assert_array_equal(t_marked.gather().data.numpy(), np.asarray(j_marked.data))

    pts = _cloud(40, 21)
    jd = jshard_map_value(JDist.create(DIMS, SIDE).insert_point_cloud(jnp.asarray(pts)), jmesh).parallel_banding()
    td = shard_map_value(_maps(DistanceVoxelMap, pts), MESH).parallel_banding()
    np.testing.assert_array_equal(td.gather().data.numpy(), np.asarray(jd.data).view(np.int32))
