"""Port conformance: slab-sharded map values (parallel/shard_value.py) and
the reference's multi-device dry-run scenes.

Existing single-device maps are split into z-slabs over an 8-slab CPU mesh
(`devices=["cpu"] * 8`) and their public ops must give the reference's
single-device results on the same numpy inputs: counts, meanings, marked
maps, probes, inserts through the sharded value. `assert_sharded` pins
that the slabs really are split (a plain map fails it). The dry-run scenes
of `__graft_entry__.dryrun_multichip` (mesh world 2 x z 4) must give the
counts the reference recorded (MULTICHIP_r05.json: collisions 1000, bit
1000, hier 21, paged 8, list 1000, types 1050, paged_world 32), each equal
to the reference's single-device count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu.geometry import generation
from gpu_voxels_tpu.maps import hierarchical as JH
from gpu_voxels_tpu.maps import paged as JP
from gpu_voxels_tpu.maps import voxellist as JL
from gpu_voxels_tpu.maps import voxelmap as JV
from gpu_voxels_tpu_torch.maps import hierarchical as TH
from gpu_voxels_tpu_torch.maps import paged as TP
from gpu_voxels_tpu_torch.maps import voxellist as TL
from gpu_voxels_tpu_torch.maps import voxelmap as TV
from gpu_voxels_tpu_torch.ops import edt as tedt
from gpu_voxels_tpu_torch.ops import edt_envelope as tenv
from gpu_voxels_tpu_torch.parallel import (ShardedPagedWorld, assert_sharded, build_sharded_bit_cycle,
                                           build_sharded_cycle, build_sharded_hier_probe, build_sharded_list_collide,
                                           build_sharded_paged_probe, make_grid_mesh, reshard_like, shard_map_value)
from gpu_voxels_tpu_torch.parallel.sharded_edt import build_sharded_edt
from gpu_voxels_tpu_torch.parallel.sharded_edt_exact import build_sharded_parallel_banding
from gpu_voxels_tpu_torch.sensors import Sensor as TSensor


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


DIMS = (16, 16, 32)
CPU8 = ["cpu"] * 8


def _mesh(n=8, world=1):
    return make_grid_mesh(n, world=world, devices=["cpu"] * n)


def _cloud(lo, hi):
    rngs = [np.arange(lo, hi) + 0.5] * 3
    g = np.meshgrid(*rngs, indexing="ij")
    return np.stack(g, axis=-1).reshape(-1, 3).astype(np.float32)


def pair(cls_name, dims=DIMS):
    return getattr(JV, cls_name).create(dims), getattr(TV, cls_name).create(dims, device="cpu")


def test_prob_map_sharded_ops_match_single_device():
    mesh = _mesh()
    ja, ta = pair("ProbVoxelMap")
    jb, tb = pair("ProbVoxelMap")
    ja, ta = ja.insert_point_cloud(jnp.asarray(_cloud(2, 12))), ta.insert_point_cloud(torch.tensor(_cloud(2, 12)))
    jb, tb = jb.insert_point_cloud(jnp.asarray(_cloud(6, 14))), tb.insert_point_cloud(torch.tensor(_cloud(6, 14)))
    sa, sb = shard_map_value(ta, mesh), shard_map_value(tb, mesh)
    assert_sharded(sa, mesh)
    assert_sharded(sb, mesh)
    assert int(sa.collide_with(sb, 0.5)) == int(ja.collide_with(jb, 0.5)) == 6**3
    # inserting THROUGH the sharded value stays right and sharded
    sa2 = sa.insert_point_cloud(torch.tensor(_cloud(0, 4)))
    ja2 = ja.insert_point_cloud(jnp.asarray(_cloud(0, 4)))
    assert_sharded(sa2, mesh)
    assert int(sa2.collide_with(sb, 0.5)) == int(ja2.collide_with(jb, 0.5))
    np.testing.assert_array_equal(sa2.gather().data.numpy(), np.asarray(ja2.data))
    # a plain operand is split the same way; merge stays sharded
    assert int(sa2.collide_with(tb, 0.5)) == int(ja2.collide_with(jb, 0.5))
    merged = sa2.merge(sb)
    assert_sharded(merged, mesh)
    np.testing.assert_array_equal(merged.gather().data.numpy(), np.asarray(ja2.merge(jb).data))


def test_bit_map_sharded_types_and_bitcheck_match():
    mesh = _mesh()
    ja, ta = pair("BitVectorVoxelMap")
    jb, tb = pair("BitVectorVoxelMap")
    for (lo, hi, mean) in ((2, 12, 7), (3, 6, 40)):
        ja = ja.insert_point_cloud(jnp.asarray(_cloud(lo, hi)), meaning=mean)
        ta = ta.insert_point_cloud(torch.tensor(_cloud(lo, hi)), meaning=mean)
    for (lo, hi, mean) in ((5, 14, 7), (5, 8, 9)):
        jb = jb.insert_point_cloud(jnp.asarray(_cloud(lo, hi)), meaning=mean)
        tb = tb.insert_point_cloud(torch.tensor(_cloud(lo, hi)), meaning=mean)
    sa, sb = shard_map_value(ta, mesh), shard_map_value(tb, mesh)
    assert_sharded(sa, mesh)
    cnt_s, meanings_s, marked_s = sa.collide_with_types(sb)
    cnt_1, meanings_1, marked_1 = ja.collide_with_types(jb)
    assert int(cnt_s) == int(cnt_1) > 0
    np.testing.assert_array_equal(meanings_s.numpy().view(np.uint32), np.asarray(meanings_1))
    assert_sharded(marked_s, mesh)  # the marked map stays sharded
    np.testing.assert_array_equal(marked_s.gather().data.numpy().view(np.uint32), np.asarray(marked_1.data))
    np.testing.assert_array_equal(marked_s.gather().occ.numpy(), np.asarray(marked_1.occ))
    assert int(sa.collide_with_bitcheck(sb, margin=2)) == int(ja.collide_with_bitcheck(jb, margin=2))
    assert int(sa.collide_with(sb)) == int(ja.collide_with(jb))
    cleared = sa.clear_bit(7)
    assert_sharded(cleared, mesh)
    np.testing.assert_array_equal(cleared.gather().data.numpy().view(np.uint32), np.asarray(ja.clear_bit(7).data))


def test_counting_map_sharded():
    mesh = _mesh()
    pts = np.repeat(_cloud(1, 9), 3, axis=0)
    jm, tm = pair("CountingVoxelMap")
    jm, tm = jm.insert_point_cloud(jnp.asarray(pts)), tm.insert_point_cloud(torch.tensor(pts))
    sm = shard_map_value(tm, mesh)
    assert_sharded(sm, mesh)
    np.testing.assert_array_equal(sm.gather().data.numpy(), np.asarray(jm.data))
    # the counting map's insert through the sharded value
    more = _cloud(4, 12)
    np.testing.assert_array_equal(sm.insert_point_cloud(torch.tensor(more)).gather().data.numpy(),
                                  np.asarray(jm.insert_point_cloud(jnp.asarray(more)).data))


@pytest.mark.parametrize("cls_name", ["HierarchicalBitMap", "HierarchicalProbMap"])
def test_hierarchical_sharded_probe_matches(cls_name):
    mesh = _mesh()
    jm = getattr(JH, cls_name).create(DIMS).insert_point_cloud(jnp.asarray(_cloud(4, 12)))
    tm = getattr(TH, cls_name).create(DIMS, device="cpu").insert_point_cloud(torch.tensor(_cloud(4, 12)))
    sm = shard_map_value(tm, mesh)
    assert_sharded(sm, mesh)
    assert isinstance(sm.pyramid[0], list) and not isinstance(sm.pyramid[-1], list)  # coarse tail whole
    qs = np.random.default_rng(0).integers(0, 16, (256, 3)).astype(np.int32)
    qs = np.concatenate([qs, [[-3, 2, 40], [17, -1, 5]]]).astype(np.int32)  # the out-of-range rule
    for got, want in zip(sm.probe(torch.tensor(qs)), jm.probe(jnp.asarray(qs))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lst_pts = _cloud(6, 14)
    jl = JL.VoxelList.create(DIMS, 1.0, "bit", 1024).insert_point_cloud(jnp.asarray(lst_pts))
    tl = TL.VoxelList.create(DIMS, 1.0, "bit", 1024, device="cpu").insert_point_cloud(torch.tensor(lst_pts))
    assert int(sm.collide_with(tl, offset=(1, 0, 2))) == int(jm.collide_with(jl, offset=(1, 0, 2)))
    # an insert through the sharded pyramid: level 0 per slab, the levels above rebuilt across the slabs
    more = _cloud(9, 15)
    inserted = sm.insert_point_cloud(torch.tensor(more))
    assert_sharded(inserted, mesh)
    for got, want in zip(inserted.gather().pyramid, jm.insert_point_cloud(jnp.asarray(more)).pyramid):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cleared = sm.clear_map()
    assert_sharded(cleared, mesh)
    for got, want in zip(cleared.gather().pyramid, tm.clear_map().pyramid):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_assert_sharded_catches_replication():
    mesh = _mesh()
    m = TV.ProbVoxelMap.create(DIMS, device="cpu")  # plain single-device value
    with pytest.raises(AssertionError):
        assert_sharded(m, mesh)
    with pytest.raises(AssertionError):  # split over 4 slabs, asserted over 8
        assert_sharded(shard_map_value(m, _mesh(4)), mesh)
    # a sharded pyramid's depth insert (item 13b-ii) answers as the
    # single-device call, slab by slab, and stays sharded
    h = TH.HierarchicalProbMap.create(DIMS, device="cpu")
    sensor = TSensor(position=np.asarray([8.0, 8.0, 0.0], np.float32), data_width=8, data_height=6, fx=4.0, fy=4.0,
                     cx=4.1, cy=3.1)
    depth = np.full((6, 8), 20.3, np.float32)
    got, want = shard_map_value(h, mesh).insert_depth_image(depth, sensor), h.insert_depth_image(depth, sensor)
    assert_sharded(got, mesh)
    assert torch.equal(got.gather().occupancy, want.occupancy) and not torch.equal(want.occupancy, h.occupancy)
    assert all(torch.equal(a, b) for a, b in zip(got.gather().pyramid, want.pyramid, strict=True))
    # a dense map's slab form answers as the single-device call
    pts = _cloud(2, 12) + 0.25
    got = shard_map_value(m, mesh).insert_sensor_data(torch.tensor(pts), sensor_origin=(8.1, 7.9, 0.6))
    assert_sharded(got, mesh)
    assert torch.equal(got.gather().data, m.insert_sensor_data(torch.tensor(pts), sensor_origin=(8.1, 7.9, 0.6)).data)


@pytest.mark.parametrize("cls_name", ["HierarchicalBitMap", "HierarchicalProbMap"])
def test_sharded_pyramid_is_an_octree_operand(cls_name):
    """A sharded pyramid given as the other operand is an octree, as the
    reference's sharded value is: a voxel list, a plain pyramid and a paged
    octree collide with it as with the single-device pyramid (the list and
    the paged map by their probes of it, the plain pyramid by the
    hierarchy intersection, which takes no offset)."""
    mesh = _mesh()
    cls = getattr(TH, cls_name)
    single = cls.create(DIMS, device="cpu").insert_point_cloud(torch.tensor(_cloud(3, 11)))
    sharded = shard_map_value(single, mesh)
    plain = cls.create(DIMS, device="cpu").insert_point_cloud(torch.tensor(_cloud(6, 14)))
    lst = TL.VoxelList.create(DIMS, 1.0, "bit", 1024, device="cpu").insert_point_cloud(torch.tensor(_cloud(5, 9)))
    paged = TP.PagedHierarchicalMap((64, 64, 64), 1.0, device="cpu").insert_point_cloud(torch.tensor(_cloud(7, 12)))
    for level in (0, 1):
        assert int(plain.collide_with(sharded, level)) == int(plain.collide_with(single, level)) > 0
        assert int(paged.collide_with(sharded, level)) == int(paged.collide_with(single, level)) > 0
    assert int(lst.collide_with(sharded, offset=(1, 0, 2))) == int(lst.collide_with(single, offset=(1, 0, 2))) > 0
    assert int(lst.collide_with(sharded)) == int(lst.collide_with(single)) == 64
    with pytest.raises(ValueError, match="offset"):
        plain.collide_with(sharded, offset=(1, 0, 0))


def test_dimz_must_divide_mesh():
    mesh = _mesh()
    m = TV.ProbVoxelMap.create((16, 16, 12), device="cpu")  # 12 % 8 != 0
    with pytest.raises(ValueError):
        shard_map_value(m, mesh)


def test_facade_mesh_opt_in():
    """add_map(..., mesh=) keeps the named map sharded through facade
    updates (an insert through update_map re-pins the layout)."""
    from gpu_voxels_tpu_torch.api import GpuVoxels

    mesh = _mesh()
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(16, 16, 32, 1.0, device="cpu")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "shardedA", mesh=mesh)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "plainB")
    gvl.insert_point_cloud_into_map(_cloud(2, 12), "shardedA", BitVoxelMeaning.eBVM_OCCUPIED)
    gvl.insert_point_cloud_into_map(_cloud(6, 14), "plainB", BitVoxelMeaning.eBVM_OCCUPIED)
    assert_sharded(gvl.get_map("shardedA"), mesh)
    assert int(gvl.get_map("shardedA").collide_with(gvl.get_map("plainB"), 0.5)) == 6**3
    gvl.set_map("shardedA", gvl.get_map("shardedA").gather())  # a plain value re-pins too
    assert_sharded(gvl.get_map("shardedA"), mesh)
    gvl.clear_map("shardedA")
    assert_sharded(gvl.get_map("shardedA"), mesh)
    assert int(gvl.get_map("shardedA").collide_with(gvl.get_map("plainB"), 0.5)) == 0
    GpuVoxels._instance = None


OFFSETS = [(0, 0, 5), (0, 0, -3), (1, -2, 9), (3, 1, -17), (0, 0, 31), (5, 0, -31)]


@pytest.mark.parametrize("offset", OFFSETS)
def test_offset_collides_cross_slab_boundaries(offset):
    """A collide offset pairs a[i + off] with b[i] over the whole flat grid:
    a slab reads the rows it needs from its neighbour slabs (4-deep slabs
    here, so every z offset but 0 crosses one) and the count equals the
    reference's single-device one, for prob x prob (K1 on the card), bit x
    bit with and without the occupancy summary (K7), prob x bit and bit x
    prob."""
    mesh = _mesh()
    rng = np.random.default_rng(21)
    pa = (rng.uniform(0, 1, (600, 3)) * np.asarray(DIMS)).astype(np.float32)
    pb = (rng.uniform(0, 1, (600, 3)) * np.asarray(DIMS)).astype(np.float32)
    j, t = {}, {}
    for name in ("ProbVoxelMap", "BitVectorVoxelMap"):
        for key, pts in (("a", pa), ("b", pb)):
            jm, tm = pair(name)
            j[name, key] = jm.insert_point_cloud(jnp.asarray(pts))
            t[name, key] = tm.insert_point_cloud(torch.tensor(pts))
    raw = TV.BitVectorVoxelMap(t["BitVectorVoxelMap", "b"].data, DIMS, 1.0)  # no summary: the plane fold
    for an in ("ProbVoxelMap", "BitVectorVoxelMap"):
        sa = shard_map_value(t[an, "a"], mesh)
        for bn in ("ProbVoxelMap", "BitVectorVoxelMap"):
            want = int(j[an, "a"].collide_with(j[bn, "b"], 0.5, offset))
            assert int(sa.collide_with(t[bn, "b"], 0.5, offset)) == want, (an, bn)
            assert int(sa.collide_with(shard_map_value(t[bn, "b"], mesh), 0.5, offset)) == want, (an, bn)
    want = int(j["BitVectorVoxelMap", "a"].collide_with(j["BitVectorVoxelMap", "b"], 0.5, offset))
    raw_a = shard_map_value(TV.BitVectorVoxelMap(t["BitVectorVoxelMap", "a"].data, DIMS, 1.0), mesh)
    assert int(raw_a.collide_with(raw, 0.5, offset)) == want


def _dryrun_inputs():
    """The dry-run's clouds and its seeded draws, in the dry-run's order."""
    p1 = np.asarray(generation.create_box_of_points((1.1,) * 3, (12.1,) * 3, 1.0), np.float32)
    p2 = np.asarray(generation.create_box_of_points((3.1,) * 3, (14.1,) * 3, 1.0), np.float32)
    rng = np.random.default_rng(0)
    n = 16 * 16 * 32
    edt_mask = np.zeros(n, bool)
    edt_mask[rng.integers(0, n, 60)] = True
    ex_mask = np.zeros(n, bool)
    ex_mask[rng.integers(0, n, 50)] = True
    hier_q = np.stack([rng.integers(0, 16, 128), rng.integers(0, 16, 128), rng.integers(0, 32, 128)],
                      axis=1).astype(np.int32)
    paged_q = np.concatenate([rng.integers(0, 256, (4 * 16 - 8, 3)), (p1[:8] * 8.0).astype(np.int64)]).astype(np.int32)
    wdims = (64, 64, 512)
    wpts = (rng.uniform(0, 1, (256, 3)) * np.asarray(wdims)).astype(np.float32)
    wq = np.concatenate([rng.integers([0, 0, 0], wdims, size=(512 - 32, 3)),
                         np.floor(wpts[:32]).astype(np.int64)]).astype(np.int32)
    return p1, p2, edt_mask, ex_mask, hier_q, paged_q, wpts, wq


def test_dryrun_multichip_scenes():
    """__graft_entry__.dryrun_multichip's scenes on a world 2 x z 4 mesh:
    each port count equals the reference's single-device count and the
    count MULTICHIP_r05.json records; the EDTs equal the single-device
    ones."""
    p1, p2, edt_mask, ex_mask, hier_q, paged_q, wpts, wq = _dryrun_inputs()
    dims = (16, 16, 32)
    mesh, zmesh = _mesh(8, world=2), _mesh(4)
    tp1, tp2 = torch.tensor(p1), torch.tensor(p2)

    counts = build_sharded_cycle(mesh, dims, 1.0, 0.1)(torch.stack([tp1, tp1]), torch.stack([tp2, tp2]))
    m1 = JV.ProbVoxelMap.create(dims).insert_point_cloud(jnp.asarray(p1))
    m2 = JV.ProbVoxelMap.create(dims).insert_point_cloud(jnp.asarray(p2))
    assert counts.tolist() == [int(m1.collide_with(m2, 0.1))] * 2 == [1000, 1000]

    packed = tedt.init_from_obstacle_mask(torch.tensor(edt_mask), dims)
    jfa = torch.cat(build_sharded_edt(zmesh, dims, coarse_factor=4, fine_steps=(4, 2, 1, 1))(packed))
    np.testing.assert_array_equal(tedt.squared_distance_grid(jfa, dims).numpy(),
                                  tedt.squared_distance_grid(tedt.jump_flood_multires(packed, dims), dims).numpy())
    ex = tedt.init_from_obstacle_mask(torch.tensor(ex_mask), dims)
    np.testing.assert_array_equal(torch.cat(build_sharded_parallel_banding(zmesh, dims, bound_c=8)(ex)).numpy(),
                                  tenv.parallel_banding(ex, dims).numpy())

    bit = int(build_sharded_bit_cycle(zmesh, dims, 1.0)(tp1, tp2))
    b1 = JV.BitVectorVoxelMap.create(dims).insert_point_cloud(jnp.asarray(p1))
    b2 = JV.BitVectorVoxelMap.create(dims).insert_point_cloud(jnp.asarray(p2))
    assert bit == int(b1.collide_with(b2)) == 1000

    th = TH.HierarchicalBitMap.create(dims, device="cpu").insert_point_cloud(tp1)
    hier = int(build_sharded_hier_probe(zmesh, th.levels, th.padded_dims)(th.pyramid[0], tuple(th.pyramid[1:]),
                                                                          torch.tensor(hier_q)))
    jh = JH.HierarchicalBitMap.create(dims).insert_point_cloud(jnp.asarray(p1))
    assert hier == int(np.asarray(jh.probe(jnp.asarray(hier_q))[0]).sum()) == 21

    tpm = TP.PagedHierarchicalMap((256, 256, 256), 1.0, device="cpu").insert_point_cloud(tp1 * 8.0)
    occ, unk = build_sharded_paged_probe(zmesh)(tpm.snapshot(), torch.tensor(paged_q))
    jpm = JP.PagedHierarchicalMap((256, 256, 256), 1.0)
    jpm.insert_point_cloud(jnp.asarray(p1) * 8.0)
    e_occ, e_unk = jpm.collide_with_counting_unknown_coords(jnp.asarray(paged_q))
    assert (int(occ), int(unk)) == (int(e_occ), int(e_unk)) and int(occ) == 8

    la = TL.VoxelList.create(dims, 1.0, capacity=2048, device="cpu").insert_point_cloud(tp1, grow=False)
    lb = TL.VoxelList.create(dims, 1.0, capacity=2048, device="cpu").insert_point_cloud(tp2, grow=False)
    jla = JL.VoxelList.create(dims, 1.0, capacity=2048).insert_point_cloud(jnp.asarray(p1), grow=False)
    jlb = JL.VoxelList.create(dims, 1.0, capacity=2048).insert_point_cloud(jnp.asarray(p2), grow=False)
    assert int(build_sharded_list_collide(zmesh)(la, lb)) == int(jla.collide_with(jlb)) == 1000

    ba = TV.BitVectorVoxelMap.create(dims, device="cpu").insert_point_cloud(tp1, meaning=7)
    bb = TV.BitVectorVoxelMap.create(dims, device="cpu").insert_point_cloud(tp2, meaning=7)
    bb = bb.insert_point_cloud(tp1[:50], meaning=9)
    sa, sb = shard_map_value(ba, zmesh), shard_map_value(bb, zmesh)
    t_cnt, t_meanings, t_marked = sa.collide_with_types(sb, sv_window=2)
    jba = JV.BitVectorVoxelMap.create(dims).insert_point_cloud(jnp.asarray(p1), meaning=7)
    jbb = JV.BitVectorVoxelMap.create(dims).insert_point_cloud(jnp.asarray(p2), meaning=7)
    jbb = jbb.insert_point_cloud(jnp.asarray(p1[:50]), meaning=9)
    e_cnt, e_meanings, e_marked = jba.collide_with_types(jbb, sv_window=2)
    assert int(t_cnt) == int(e_cnt) == 1050
    np.testing.assert_array_equal(t_meanings.numpy().view(np.uint32), np.asarray(e_meanings))
    np.testing.assert_array_equal(t_marked.gather().data.numpy().view(np.uint32), np.asarray(e_marked.data))
    assert_sharded(t_marked, zmesh)
    tm1 = TV.ProbVoxelMap.create(dims, device="cpu").insert_point_cloud(tp1)
    tm2 = TV.ProbVoxelMap.create(dims, device="cpu").insert_point_cloud(tp2)
    sp = reshard_like(tm1, zmesh)
    assert_sharded(sp, zmesh)
    assert int(sp.insert_point_cloud(tp2).collide_with(tm2, 0.1)) == int(
        m1.insert_point_cloud(jnp.asarray(p2)).collide_with(m2, 0.1))

    wdims = (64, 64, 512)
    single = TP.PagedHierarchicalMap(wdims, 1.0, device="cpu")
    single.insert_point_cloud_with_free_space(torch.tensor(wpts), (32.5, 32.5, 2.5), max_steps=64)
    world = ShardedPagedWorld(wdims, 1.0, devices=CPU8)
    world.insert_point_cloud_with_free_space(torch.tensor(wpts), (32.5, 32.5, 2.5), max_steps=64)
    world.assert_distributed()
    assert world.check_tree() and world.n_tiles() == single.n_tiles()
    assert torch.equal(world.probe_status(torch.tensor(wq)), single.probe_status(torch.tensor(wq)))
    assert int(world.collide_with_coords(wq)) == int(single.collide_with_coords(wq)) == 32
