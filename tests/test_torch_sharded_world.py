"""Port conformance: ShardedPagedWorld (parallel/paged_world.py), the
z-slab multi-device paged octree, against the single-device
PagedHierarchicalMap on an 8-slab CPU mesh (`devices=["cpu"] * 8`).

Every result (probe statuses, occupancies, every collide direction, tile
counts, files) must EQUAL the single-device map's: the slabs are a layout,
not a semantic fork. The port's single-device paged map is held against
the reference's in test_torch_paged.py; here the reference's single-device
map takes the same numpy inputs as well in the costlier scenes (the world
against it directly, the slab-crossing rays, the files, the fuzz's final
state). (The reference's own ShardedPagedWorld is not built here: its
compiles on the virtual mesh take minutes.) `assert_distributed` pins that
each slab's pool lies on its own device; one case gives the slabs two
different devices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps import paged as JP
from gpu_voxels_tpu.utils import io as jio
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning
from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld


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


DIMS = (64, 64, 512)  # 8 slabs of 64: one page of depth per slab
CPU8 = ["cpu"] * 8


def single(dims=DIMS, side=1.0, probabilistic=False):
    return PagedHierarchicalMap(dims, side, probabilistic, device="cpu")


def world(dims=DIMS, side=1.0, probabilistic=False):
    return ShardedPagedWorld(dims, side, probabilistic, devices=CPU8)


def _scene(seed=0, n=400):
    """Points spread across every slab (cluster + uniform spray)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0, 0], [64, 64, 512], size=(n, 3)).astype(np.float32)
    cluster = rng.normal([32, 32, 250], 6.0, size=(64, 3)).astype(np.float32)
    return np.concatenate([pts, cluster], axis=0)


def _queries(seed=1, q=2048):
    rng = np.random.default_rng(seed)
    return rng.integers([0, 0, 0], [64, 64, 512], size=(q, 3)).astype(np.int32)


def same_probes(w, s, q, occupancy=False):
    assert torch.equal(w.probe_status(q), s.probe_status(q))
    if occupancy:
        assert torch.equal(w.probe_occupancy(q), s.probe_occupancy(q))


def same_as_reference(w, j, q, occupancy=False):
    """The world's probes and tile count equal the reference's
    single-device map's on the same numpy inputs."""
    np.testing.assert_array_equal(w.probe_status(q).numpy(), np.asarray(j.probe_status(jnp.asarray(q))))
    if occupancy:
        np.testing.assert_array_equal(w.probe_occupancy(q).numpy(), np.asarray(j.probe_occupancy(jnp.asarray(q))))
    assert w.n_tiles() == j.n_tiles()


def test_deterministic_world_matches_single_device():
    pts, free = _scene(), _scene(seed=7, n=100)
    s, w = single(), world()
    for m in (s, w):
        m.insert_point_cloud(pts)
        m.insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE, static_map=False)
    w.assert_distributed()
    assert w.check_tree()
    assert w.n_tiles() == s.n_tiles()  # tiles partition exactly: slab boundaries are page boundaries
    assert sum(1 for m in w.shards if m.n_tiles()) >= 2
    q = _queries()
    same_probes(w, s, q)
    for a, b in zip(w.probe(q), s.probe(q)):
        assert torch.equal(a, b)
    assert int(w.collide_with_coords(q)) == int(s.collide_with_coords(q))
    assert tuple(map(int, w.collide_with_counting_unknown_coords(q))) == tuple(
        map(int, s.collide_with_counting_unknown_coords(q)))
    assert {tuple(r) for r in w.extract_occupied_coords()} == {tuple(r) for r in s.extract_occupied_coords()}
    assert w.memory_usage() > 0


def test_world_matches_reference_single_device():
    """The world against the reference's single-device paged map on the same
    numpy inputs: probe statuses, tile count and the probe counts."""
    pts, free = _scene(seed=3, n=200), _scene(seed=5, n=60)
    j = JP.PagedHierarchicalMap(DIMS, 1.0)
    j.insert_point_cloud(jnp.asarray(pts))
    j.insert_point_cloud(jnp.asarray(free), BitVoxelMeaning.eBVM_FREE, static_map=False)
    w = world().insert_point_cloud(pts)
    w.insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE, static_map=False)
    q = _queries(seed=9, q=1024)
    np.testing.assert_array_equal(w.probe_status(q).numpy(), np.asarray(j.probe_status(jnp.asarray(q))))
    assert w.n_tiles() == j.n_tiles()
    cj, uj = j.collide_with_counting_unknown_coords(jnp.asarray(q))
    assert tuple(map(int, w.collide_with_counting_unknown_coords(q))) == (int(cj), int(uj))


def test_free_space_rays_cross_slabs():
    """A sensor in slab 0 looking down +z: rays traverse many slabs and every
    slab's cells carve exactly like the single-device walk."""
    origin = (32.5, 32.5, 4.5)
    rng = np.random.default_rng(3)
    hits = rng.uniform([8, 8, 300], [56, 56, 500], size=(95, 3)).astype(np.float32)
    hits = np.concatenate([hits, [[32.5, 32.5, 490.5]]]).astype(np.float32)
    s, w, j = single(), world(), JP.PagedHierarchicalMap(DIMS, 1.0)
    for m in (s, w, j):
        m.insert_point_cloud_with_free_space(hits, origin, max_steps=512)
    assert w.n_tiles() == s.n_tiles()
    same_probes(w, s, _queries(seed=5))
    same_as_reference(w, j, _queries(seed=5))
    assert w.probe(np.array([[32, 32, 200], [32, 32, 340]], np.int32))[2].all()  # mid-slab cells read FREE


def test_probabilistic_world_occupancy():
    origin = (32.5, 32.5, 4.5)
    hits = _scene(seed=11, n=64)
    hits[:, 2] = np.clip(hits[:, 2], 64, 511)  # endpoints beyond slab 0
    s, w = single(probabilistic=True), world(probabilistic=True)
    for m in (s, w):
        m.insert_point_cloud_with_free_space(hits, origin, max_steps=512)
    same_probes(w, s, _queries(seed=13), occupancy=True)


def test_collide_directions_match_single_device():
    from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
    from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap

    pts = _scene(seed=17)
    s, w = single().insert_point_cloud(pts), world().insert_point_cloud(pts)
    other_pts = _scene(seed=19, n=300)
    lst = VoxelList.create(DIMS, 1.0, "bit", 4096, "linear", device="cpu").insert_point_cloud(other_pts)
    dense = ProbVoxelMap.create(DIMS, 1.0, device="cpu").insert_point_cloud(other_pts)
    for off in ((0, 0, 0), (2, -1, 67)):
        assert int(w.collide_with(lst, offset=off)) == int(s.collide_with(lst, offset=off))
        assert int(w.collide_with(dense, offset=off)) == int(s.collide_with(dense, offset=off))
        assert tuple(map(int, w.collide_with_counting_unknown(lst, offset=off))) == tuple(
            map(int, s.collide_with_counting_unknown(lst, offset=off)))
    assert int(w.collide_with(lst)) > 0
    other_paged = single().insert_point_cloud(other_pts)
    assert int(w.collide_with(other_paged)) == int(s.collide_with(other_paged)) > 0
    other_world = world().insert_point_cloud(other_pts)  # a sharded world as the other octree
    assert int(w.collide_with(other_world)) == int(s.collide_with(other_paged))
    with pytest.raises(ValueError):
        w.collide_with(other_paged, offset=(1, 0, 0))


def test_min_level_probes_and_guard():
    pts = _scene(seed=23)
    s, w = single().insert_point_cloud(pts), world().insert_point_cloud(pts)
    q = _queries(seed=29, q=512)
    for lvl in (1, 3, 6):  # 2^6 = 64 divides the slab depth
        assert torch.equal(w.probe_status(q, min_level=lvl), s.probe_status(q, min_level=lvl))
        assert int(w.collide_with_coords(q, min_level=lvl)) == int(s.collide_with_coords(q, min_level=lvl))
    with pytest.raises(ValueError):
        w.probe_status(q, min_level=7)  # a 128-cube would cross 64-slabs


def test_depth_image_matches_single_device():
    from gpu_voxels_tpu_torch.sensors import Sensor

    cam = Sensor(position=np.array([32.5, 32.5, 8.5], np.float32), data_width=16, data_height=16, fx=16.0,
                 fy=16.0, cx=8.0, cy=8.0)
    depth = np.full((16, 16), 300.0, np.float32)  # rays span ~5 slabs
    depth[0, 0] = 0.0  # an invalid pixel
    s, w = single(probabilistic=True), world(probabilistic=True)
    for m in (s, w):
        m.insert_depth_image(depth, cam, max_steps=512)
    same_probes(w, s, _queries(seed=31), occupancy=True)
    assert w.n_tiles() == s.n_tiles()


def test_slab_placement_on_two_distinct_devices():
    """The placement with slabs on two different devices ('cpu' and 'meta',
    a device without data; a moving run needs two cards): the mesh maps its
    shards round-robin, every world pool, sharded value slab and per-slab
    input lies on its own device and the distribution checks pass; a slab
    on another device than its own fails them."""
    from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
    from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh, shard_map_value

    want = [torch.device(("cpu", "meta")[k % 2]) for k in range(8)]
    mesh = make_grid_mesh(8, devices=["cpu", "meta"])
    assert mesh.z_devices() == want
    w = ShardedPagedWorld(DIMS, 1.0, devices=want)
    assert [m.pool.device for m in w.shards] == want
    assert [w._points(_scene(n=8), k).device for k in range(8)] == want
    w.assert_distributed()
    w.shards[1] = w.shards[0]  # slab 1's pool on slab 0's device
    with pytest.raises(AssertionError):
        w.assert_distributed()
    plain = ProbVoxelMap.create((8, 8, 64), 1.0, device="cpu")
    v = shard_map_value(plain, mesh)
    assert_sharded(v, mesh)
    with pytest.raises(AssertionError):
        assert_sharded(v, make_grid_mesh(8, devices=["meta", "cpu"]))  # every slab on the other device
    with pytest.raises(AssertionError):
        assert_sharded(plain, mesh)


def test_world_validation_errors():
    with pytest.raises(ValueError):
        ShardedPagedWorld((64, 64, 500), devices=CPU8)  # 500 % 8 != 0
    with pytest.raises(ValueError):
        ShardedPagedWorld((64, 64, 256), devices=CPU8)  # 32-deep slabs < a page


def test_to_from_paged_map_and_disk_round_trip(tmp_path):
    """Gather and split, and writeToDisk: the world writes the single-device
    format (tile slots slab-major), byte-equal to the file of the
    single-device map split over the same slabs, and both read paths
    reproduce every probe. The reference's single-device map of the same
    scene writes the port's single-device map's bytes and reads the
    world's file back to its own probes."""
    from gpu_voxels_tpu_torch.utils import io as map_io

    pts = _scene(seed=37)
    s, w, j = single(), world(), JP.PagedHierarchicalMap(DIMS, 1.0)
    for m in (s, w, j):
        m.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=512)
    q = _queries(seed=41)
    want = s.probe_status(q)
    same_as_reference(w, j, q)

    gathered = w.to_paged_map()
    assert gathered.n_tiles() == s.n_tiles() and gathered.check_tree()
    assert torch.equal(gathered.probe_status(q), want)

    split = ShardedPagedWorld.from_paged_map(s, CPU8)
    split.assert_distributed()
    assert split.n_tiles() == s.n_tiles() and split.check_tree()
    assert torch.equal(split.probe_status(q), want)

    p_world, p_split = tmp_path / "w.bin", tmp_path / "s.bin"
    assert w.write_to_disk(p_world) and split.write_to_disk(p_split)
    assert p_world.read_bytes() == p_split.read_bytes()
    as_single = map_io.read_map(p_world, device="cpu")
    assert isinstance(as_single, PagedHierarchicalMap)
    assert as_single.n_tiles() == s.n_tiles() and as_single.check_tree()
    assert torch.equal(as_single.probe_status(q), want)
    back = w.read_from_disk(p_world)
    back.assert_distributed()
    assert torch.equal(back.probe_status(q), want) and back.n_tiles() == s.n_tiles()
    map_io.write_map(back, tmp_path / "again.bin")
    assert (tmp_path / "again.bin").read_bytes() == p_world.read_bytes()

    map_io.write_map(s, tmp_path / "single.bin")
    jio.write_paged_map(j, tmp_path / "ref.bin")
    assert (tmp_path / "single.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    np.testing.assert_array_equal(np.asarray(jio.read_hierarchical_map(p_world).probe_status(jnp.asarray(q))),
                                  np.asarray(j.probe_status(jnp.asarray(q))))


def test_probabilistic_conversions(tmp_path):
    hits = _scene(seed=43, n=80)
    s = single(probabilistic=True)
    s.insert_point_cloud_with_free_space(hits, (32.5, 32.5, 2.5), max_steps=512)
    w = ShardedPagedWorld.from_paged_map(s, CPU8)
    q = _queries(seed=47)
    assert torch.equal(w.probe_occupancy(q), s.probe_occupancy(q))
    p = tmp_path / "p.bin"
    assert w.write_to_disk(p)
    back = w.read_from_disk(p)
    assert torch.equal(back.probe_occupancy(q), s.probe_occupancy(q))
    with pytest.raises(ValueError):
        world().read_from_disk(p)  # map type mismatch


def test_facade_mesh_routes_paged_tier_to_world(tmp_path):
    """add_map(..., mesh=) on an octree type at paged scale builds a
    ShardedPagedWorld over the mesh's devices; the facade's save / load
    keep it (save writes the single-device format, load stays sharded);
    small dims keep the dense pyramid as a slab-sharded value."""
    from gpu_voxels_tpu_torch.api import GpuVoxels, MapType
    from gpu_voxels_tpu_torch.parallel import GridMesh
    from gpu_voxels_tpu_torch.parallel.shard_value import ShardedPyramid

    mesh = GridMesh(np.asarray(CPU8, dtype=object))
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(64, 64, 2048, 1.0, device="cpu")
    m = gvl.add_map(MapType.MT_BITVECTOR_OCTREE, "world", mesh=mesh)
    assert isinstance(m, ShardedPagedWorld)
    m.assert_distributed()
    pts = (np.random.default_rng(53).uniform(0, 1, (200, 3)) * np.asarray([64, 64, 2048])).astype(np.float32)
    m.insert_point_cloud(pts)
    q = np.floor(pts[:50]).astype(np.int32)
    assert int(m.collide_with_coords(q)) == 50  # every inserted cell hits
    assert gvl.visualize_map("world")
    p = tmp_path / "f.bin"
    assert gvl.save_map("world", p)
    m.clear_map()
    assert m.n_tiles() == 0
    assert gvl.load_map("world", p)
    m2 = gvl.get_map("world")
    assert isinstance(m2, ShardedPagedWorld)
    m2.assert_distributed()
    assert int(m2.collide_with_coords(q)) == 50
    assert ShardedPagedWorld.insertPointCloud is ShardedPagedWorld.insert_point_cloud  # the camelCase aliases

    GpuVoxels._instance = None
    gvl2 = GpuVoxels.get_instance()
    gvl2.initialize(64, 64, 512, 1.0, device="cpu")
    small = gvl2.add_map(MapType.MT_BITVECTOR_OCTREE, "small", mesh=mesh)
    assert isinstance(small, ShardedPyramid)
    GpuVoxels._instance = None


def test_multilevel_extraction_on_world():
    from gpu_voxels_tpu_torch.constants import BitVoxelMeaning as BVM
    from gpu_voxels_tpu_torch.vis.extract import extract_multilevel_cubes

    pts = _scene(seed=59)
    s = single()
    s.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=512)
    w = ShardedPagedWorld.from_paged_map(s, CPU8)
    cs, ss, ts = extract_multilevel_cubes(s)
    cw, sw, tw = extract_multilevel_cubes(w)
    want = {(tuple(c), int(a), int(t)) for c, a, t in zip(cs, ss, ts)}
    got = {(tuple(c), int(a), int(t)) for c, a, t in zip(cw, sw, tw)}
    # UNKNOWN cubes differ by construction (the single map emits coarse
    # UNKNOWN cubes over the whole grid, the world per-slab ones); occupied
    # and free cubes never cross slab boundaries, so those sets match
    unk = int(BVM.eBVM_UNKNOWN)
    assert {x for x in want if x[2] != unk} == {x for x in got if x[2] != unk}
    assert any(x[2] != unk for x in got)


def test_build_meta_robot_and_clear_meaning():
    """The GvlNTree adapter surface on the world: build (with the free box
    carve), insertMetaPointCloud (first meaning), insertRobotConfiguration
    (self-collision check) and clearBitVoxelMeaning, each equal to the
    single-device map."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud

    rng = np.random.default_rng(61)
    # a compact cluster across the slab-3/4 boundary, so the free box crosses slabs
    pts = rng.uniform([20, 20, 240], [40, 40, 280], size=(64, 3)).astype(np.float32)
    s = single().build(pts, free_bounding_box=True)
    w = world().build(pts, free_bounding_box=True)
    q = _queries(seed=67)
    same_probes(w, s, q)
    assert w.n_tiles() == s.n_tiles()
    w.clear_voxel_meaning(BitVoxelMeaning.eBVM_FREE)  # a logged no-op
    assert w.n_tiles() == s.n_tiles()
    w.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED)
    assert w.n_tiles() == 0

    link0 = rng.uniform([4, 4, 4], [12, 12, 12], size=(32, 3)).astype(np.float32)
    link1 = rng.uniform([30, 30, 400], [40, 40, 440], size=(32, 3)).astype(np.float32)
    mpc = MetaPointCloud.from_clouds([link0, link1], names=("l0", "l1"), device="cpu")
    s2 = single()
    _, ok_s = s2.insert_robot_configuration(mpc, with_self_collision_test=True)
    w2 = world()
    _, ok_w = w2.insert_robot_configuration(mpc, with_self_collision_test=True)
    assert ok_s == ok_w is True
    same_probes(w2, s2, q)
    clash = MetaPointCloud.from_clouds([link0, link0 + 0.001], device="cpu")
    assert world().insert_robot_configuration(clash, with_self_collision_test=True)[1] is False


@pytest.mark.parametrize("seed", [101, 202])
@pytest.mark.parametrize("probabilistic", [False, True])
def test_world_stateful_fuzz_vs_single_device(seed, probabilistic):
    """Random interleavings (occupied / free inserts, cross-slab sensor
    carves, meaning clears) on the world AND the single-device map: probe
    statuses, occupancies, tile counts and collide counts stay EQUAL after
    every op (per-slab allocators, replicated rays, slab ownership). Seed
    202 draws all four ops; there the reference's single-device map takes
    them too, and the final state equals its own."""
    rng = np.random.default_rng(seed)
    s, w = single(probabilistic=probabilistic), world(probabilistic=probabilistic)
    maps = (s, w)
    if seed == 202 and not probabilistic:
        j = JP.PagedHierarchicalMap(DIMS, 1.0)
        maps = (s, w, j)
    q = _queries(seed=seed + 1, q=768)
    for _ in range(7):
        op = rng.integers(0, 4)
        if op == 0:  # occupied insert, static or dynamic
            pts = _scene(seed=rng.integers(1e6), n=rng.integers(16, 200))
            static = bool(rng.integers(0, 2))
            for m in maps:
                m.insert_point_cloud(pts, static_map=static)
        elif op == 1:  # explicit hard-FREE cells
            pts = _scene(seed=rng.integers(1e6), n=rng.integers(16, 120))
            for m in maps:
                m.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE, static_map=False)
        elif op == 2:  # a sensor carve from a random origin (rays cross slabs)
            hits = _scene(seed=rng.integers(1e6), n=rng.integers(16, 96))
            origin = tuple(float(v) for v in rng.uniform([4, 4, 4], [60, 60, 500], size=3))
            for m in maps:
                m.insert_point_cloud_with_free_space(hits, origin, max_steps=256)
        else:  # the occasional full reset through the meaning clear
            for m in maps:
                m.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED)
        assert w.n_tiles() == s.n_tiles()
        same_probes(w, s, q, occupancy=probabilistic)
    assert w.check_tree()
    assert int(w.collide_with_coords(q)) == int(s.collide_with_coords(q))
    assert tuple(map(int, w.collide_with_counting_unknown_coords(q))) == tuple(
        map(int, s.collide_with_counting_unknown_coords(q)))
    if len(maps) == 3:
        same_as_reference(w, j, q)
        cj, uj = j.collide_with_counting_unknown_coords(jnp.asarray(q))
        assert tuple(map(int, w.collide_with_counting_unknown_coords(q))) == (int(cj), int(uj))


def test_fractional_side_length_matches_single_device():
    """At side 0.05 (f32-unrepresentable) the world voxelizes in the global
    frame and shifts in integer voxel units (maps/paged.py voxel_offset), so
    inserts AND carve rays partition exactly, even for points ON voxel
    boundaries and just around them."""
    side = 0.05
    rng = np.random.default_rng(3)
    cells = rng.integers([0, 0, 0], [64, 64, 512], size=(600, 3))
    jitter = rng.choice([0.0, 1e-4, -1e-4, 0.5], size=(600, 3))
    pts = ((cells + jitter) * side).astype(np.float32)
    s, w = single(side=side), world(side=side)
    for m in (s, w):
        m.insert_point_cloud(pts)
    q = _queries(seed=11)
    assert w.n_tiles() == s.n_tiles()
    same_probes(w, s, q)
    hits = ((rng.integers([0, 0, 0], [64, 64, 512], size=(80, 3)) + 0.5) * side).astype(np.float32)
    s2, w2 = single(side=side), world(side=side)
    for m in (s2, w2):
        m.insert_point_cloud_with_free_space(hits, (1.6, 1.6, 12.8), max_steps=600)
    assert w2.n_tiles() == s2.n_tiles()
    same_probes(w2, s2, q)


def test_out_of_range_probe_clamps_like_single_device():
    """Probes past the world's bounds answer with the clamped border cell,
    as the single-device map's clamped gathers do, and every answer decodes
    to a real tri-state."""
    pts = _scene()
    s, w = single(probabilistic=True), world(probabilistic=True)
    for m in (s, w):
        m.insert_point_cloud(pts)
    q = np.array([[32, 32, 511], [32, 32, 512], [32, 32, 600], [32, 32, 0], [5, 5, 1000], [-4, 70, -9]], np.int32)
    same_probes(w, s, q, occupancy=True)
    occ, unk, free = w.probe(q)
    assert (occ | unk | free).all()
