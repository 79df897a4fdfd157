"""Port conformance: the paged sparse octree tier (maps/paged.py).

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch on the CPU, and the whole paged state must be equal
after every step: the tile pool (and the probabilistic tier's log-odds
pool), the blocks and pages of every slot, the sorted page directory, the
block summaries, the page pyramid, the host directories, `n_tiles` and
`memory_usage`. Slot order is observable (files, extraction), so equal
slots across allocations in several frames and capacity doublings is part
of the contract. Probes, collides and occupancies must be equal too. Every
DDA ray sample of a fixture keeps 1e-3 voxel from a cell boundary (F11).
The reference compiles one program per shape and static argument (each
pool capacity is a shape), so fixtures stay small and share dims.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import sensors as jsens
from gpu_voxels_tpu.constants import (MAX_PROBABILITY, MIN_PROBABILITY, SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED,
                                      UNKNOWN_PROBABILITY, BitVoxelMeaning)
from gpu_voxels_tpu.maps import hierarchical as JH
from gpu_voxels_tpu.maps import paged as JP
from gpu_voxels_tpu.maps import voxellist as JL
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch import sensors as tsens
from gpu_voxels_tpu_torch.maps import hierarchical as TH
from gpu_voxels_tpu_torch.maps import paged as TP
from gpu_voxels_tpu_torch.maps import voxellist as TL
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb


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


DIMS = (128, 128, 128)  # 2^3 pages, 16^3 blocks


def pair(prob=False, dims=DIMS, side=1.0):
    return JP.PagedHierarchicalMap(dims, side, probabilistic=prob), TP.PagedHierarchicalMap(
        dims, side, probabilistic=prob, device="cpu")


def equal(got, want, err_msg=""):
    """np.testing.assert_array_equal, whose element-wise report (several
    passes over the arrays) runs only where np.array_equal finds them
    unequal: the 32768^3 map's finest pyramid level has 2^27 cells."""
    want = np.asarray(want)
    if not (np.shape(got) == want.shape and np.array_equal(got, want)):
        np.testing.assert_array_equal(got, want, err_msg=err_msg)


def same(t, j):
    """The port's paged map holds the reference map's whole state."""
    assert (t.dims, t.side_length, t.levels, t.fine_levels, int(t.map_type)) == (
        j.dims, j.side_length, j.levels, j.fine_levels, int(j.map_type))
    state = interop.to_numpy(t)
    for name in interop.PAGED_ARRAYS:
        want = getattr(j, name)
        if want is None:
            assert state[name] is None, name
        else:
            equal(state[name], want, err_msg=name)
    for got, want in zip(state["pyramid"], j.pyramid, strict=True):
        equal(got, want)
    assert (state["n_pages"], state["n_slots"], t.n_tiles()) == (j._n_pages, j._n_slots, j.n_tiles())
    assert state["page_of"] == j._page_of and state["slot_of"] == j._slot_of
    assert t.memory_usage() == j.memory_usage()


def clusters(seed, n, centres=4, spread=6.0, lo=8.0, hi=112.0):
    """n points around a few centres: many points, few tiles."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(lo, hi, (centres, 3))
    return (c[rng.integers(0, centres, n)] + rng.uniform(0, spread, (n, 3))).astype(np.float32)


def _probe_all_levels(t, j, coords):
    for min_level in range(t.fine_levels + 1):
        want = np.asarray(j.probe_status(jnp.asarray(coords), min_level))
        np.testing.assert_array_equal(t.probe_status(coords, min_level).numpy(), want, err_msg=str(min_level))
        for got, flag in zip(t.probe(coords, min_level), JH.decode_status_flags(want)):
            np.testing.assert_array_equal(got.numpy(), flag)


def test_allocation_fetches_o_new_tiles_not_o_points(monkeypatch):
    """_host_fetch is the allocator's one device -> host read: a fresh map
    reads the new-tile count, then the [n_new, 3] block list; a steady-state
    insert one scalar; a growing insert the scalar, the count and the
    O(new tiles) list, never O(points) (tests/test_paged.py:34, without the
    reference's power-of-two buckets, which exist only for its compiles)."""
    fetches = []
    real = TP._host_fetch

    def counting(t):
        out = real(t)
        fetches.append(int(np.asarray(out).size))
        return out

    monkeypatch.setattr(TP, "_host_fetch", counting)
    m = TP.PagedHierarchicalMap(DIMS, 1.0, device="cpu")
    pts = clusters(3, 50_000, centres=6, spread=4.0)
    m.insert_point_cloud(pts)
    nt = m.n_tiles()
    assert nt < 200 and fetches == [1, 3 * nt], fetches
    fetches.clear()
    m.insert_point_cloud(pts[:1000])
    assert fetches == [1], fetches
    fetches.clear()
    grow = np.concatenate([pts[:30_000], pts[:100] * 0.5])
    m.insert_point_cloud(grow)
    new_tiles = m.n_tiles() - nt
    assert new_tiles > 0 and fetches == [1, 1, 3 * new_tiles], fetches
    occ, _, _ = m.probe(np.floor(pts[:500]).astype(np.int32))
    assert bool(occ.all())


def _sample_margin(origin, pts, max_steps):
    """Least distance (voxels) of a ray's DDA samples and endpoint from a
    cell boundary (side 1), in float64 from the reference's formula."""
    start = np.asarray(origin, np.float64)
    out = np.inf
    for e in np.asarray(pts, np.float64):
        delta = e - start
        steps = int(np.ceil(np.abs(delta).max()))
        k = np.arange(min(steps, max_steps))[:, None]
        pos = np.concatenate([start + delta / max(steps, 1) * k, e[None]])
        out = min(out, float(np.abs(pos - np.round(pos)).min()))
    return out


def safe_rays(seed, origin, n, max_steps, lo=4.0, hi=124.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(lo, hi, (4 * n, 3)).astype(np.float32)
    pts = pts[[_sample_margin(origin, p[None], max_steps) >= 2e-3 for p in pts]][:n]
    assert len(pts) == n and _sample_margin(origin, pts, max_steps) >= 1e-3
    return pts


ORIGIN = (64.37, 63.61, 62.83)


@pytest.fixture(scope="module", params=[False, True], ids=["det", "prob"])
def world(request):
    """One map per tier in both packages, driven through point inserts in
    three frames that each allocate tiles and pages past capacity doublings
    (1 -> 2 -> 4 -> ... slots), a dynamic-tag insert (det), and a
    free-space frame of a non-power-of-two ray count (the reference pads
    with -1e9 points whose rays must stay dead) with rays longer than
    max_steps; the whole state equal after every step."""
    prob = request.param
    j, t = pair(prob)
    same(t, j)
    frames = [(clusters(1, 40, centres=1), BitVoxelMeaning.eBVM_OCCUPIED),
              (clusters(2, 40, centres=2), BitVoxelMeaning.eBVM_FREE),
              (clusters(3, 40, centres=3), BitVoxelMeaning.eBVM_SWEPT_VOLUME_START if prob
               else BitVoxelMeaning.eBVM_OCCUPIED)]
    for pts, meaning in frames:
        j.insert_point_cloud(pts, meaning)
        t.insert_point_cloud(pts, meaning)
        same(t, j)
    if not prob:
        j.insert_point_cloud(frames[0][0], static_map=False)
        t.insert_point_cloud(frames[0][0], static_map=False)
        same(t, j)
    rays = safe_rays(61, ORIGIN, 13, 48)
    j.insert_point_cloud_with_free_space(rays, ORIGIN, max_steps=48)
    t.insert_point_cloud_with_free_space(rays, ORIGIN, max_steps=48)
    same(t, j)
    return {"j": j, "t": t, "frames": frames, "rays": rays, "prob": prob}


def test_inserts_allocate_like_the_reference(world):
    """Slots, pages, directory and capacities as the reference allocates
    them (the fixture compares every step); the capacities grew."""
    j, t = world["j"], world["t"]
    same(t, j)
    assert t.n_tiles() > 8 and t._n_pages > 2 and t.pool.shape[0] > t.n_tiles() // 2


def test_probes_at_every_level(world):
    """Probes at min_level 0 to levels + 6, out-of-range coords clamped."""
    rng = np.random.default_rng(4)
    coords = np.concatenate([np.floor(world["frames"][2][0]).astype(np.int32),
                             rng.integers(-20, 150, (200, 3)).astype(np.int32)])
    _probe_all_levels(world["t"], world["j"], coords)
    if world["prob"]:
        np.testing.assert_array_equal(world["t"].probe_occupancy(coords).numpy(),
                                      np.asarray(world["j"].probe_occupancy(coords)))


def test_extraction_and_check_tree(world):
    """The occupied set in slot order, and check_tree (a copy with summaries
    that disagree with the pool fails it)."""
    j, t = world["j"], world["t"]
    np.testing.assert_array_equal(t.extract_occupied_coords(), j.extract_occupied_coords())
    np.testing.assert_array_equal(t.extract_occupied_coords(max_out=5), j.extract_occupied_coords(max_out=5))
    assert t.check_tree() and j.check_tree()
    broken = interop.paged_map_from_numpy(interop.to_numpy(t), device="cpu")
    broken.block_summaries = broken.block_summaries ^ 1
    assert not broken.check_tree()


def test_rays_leave_no_phantom_carve(world):
    """The rays carved cells, and the diagonal toward the reference's
    padding corner stays unknown."""
    t = world["t"]
    diag = np.repeat(np.arange(2, 50, dtype=np.int32)[:, None], 3, axis=1)
    assert bool(t.probe(diag)[1].all())
    assert int(TH.decode_status_flags(t.pool[:t.n_tiles()])[2].sum()) > 100


def test_free_ray_cells_match_reference():
    """The ray walk alone: visited cells and live masks, incl. a far point
    past max_steps, a ray to a -1e9 point (dead) and a shifted frame."""
    pts = np.concatenate([safe_rays(3, ORIGIN, 6, 40), [[-1e9, -1e9, -1e9]]]).astype(np.float32)
    for voff in (None, (0, 0, 64)):
        jc, jl = JP._free_ray_cells(jnp.asarray(pts), jnp.asarray(ORIGIN, jnp.float32), 1.0, DIMS, 40,
                                    None if voff is None else np.asarray(voff, np.int32))
        tc, tl = TP._free_ray_cells(torch.tensor(pts), torch.tensor(ORIGIN, dtype=torch.float32), 1.0, DIMS, 40, voff)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(np.where(tl.numpy()[..., None], tc.numpy(), 0),
                                      np.where(np.asarray(jl)[..., None], np.asarray(jc), 0))
        assert not tl[:, -1].any() and tl.any()


@pytest.mark.parametrize("prob", [False, True], ids=["det", "prob"])
def test_insert_depth_image_matches_reference(prob):
    """The octree sensor pipeline: back-projection, world transform and the
    ray-carved insert from the sensor's position; invalid pixels cast no
    ray. Every measured point keeps 1e-3 voxel from a cell boundary."""
    kw = dict(position=np.array([60.37, 61.61, 40.23], np.float32),
              orientation_rpy=np.array([0.05, -0.03, 0.02], np.float32),
              data_width=16, data_height=12, fx=14.0, fy=14.0, cx=8.0, cy=6.0)
    jsensor, tsensor = jsens.Sensor(**kw), tsens.Sensor(**kw)
    rng = np.random.default_rng(5)
    depth = rng.uniform(15.0, 30.0, (12, 16)).astype(np.float32)
    depth[0, 0] = 0.0
    world = tsensor.process_depth_image(depth, device="cpu").numpy()
    ok = np.isfinite(world).all(1)
    near = np.array([_sample_margin(kw["position"], p[None], 128) < 2e-3 if f else False
                     for p, f in zip(world, ok)])
    depth.reshape(-1)[near] = 0.0
    world = tsensor.process_depth_image(depth, device="cpu").numpy()
    assert _sample_margin(kw["position"], world[np.isfinite(world).all(1)], 128) >= 1e-3
    j, t = pair(prob)
    for _ in range(2):
        j.insert_depth_image(depth, jsensor)
        t.insert_depth_image(depth, tsensor)
        same(t, j)
    assert t.n_tiles() > 0 and int(TH.decode_status_flags(t.pool[:t.n_tiles()])[0].sum()) > 0


def ref_of(t):
    """The reference's map over a copy of the port map's arrays, as
    tests/test_torch_vis.py builds it: the same content without the
    reference's inserts, whose conformance the `world` fixture (paged) and
    the hierarchical, list and dense files hold; the collide programs are
    under test here."""
    if isinstance(t, TP.PagedHierarchicalMap):
        j = JP.PagedHierarchicalMap(t.dims, t.side_length, probabilistic=t.probabilistic)
        state = interop.to_numpy(t)
        for name in interop.PAGED_ARRAYS:
            setattr(j, name, None if state[name] is None else jnp.asarray(state[name]))
        j.pyramid = tuple(jnp.asarray(a) for a in state["pyramid"])
        j._n_pages, j._n_slots, j._page_of, j._slot_of = (state[k] for k in ("n_pages", "n_slots", "page_of", "slot_of"))
        same(t, j)
        return j
    if isinstance(t, TL.VoxelList):
        ids, ids_hi, payload, count = interop.to_numpy(t)
        return JL.VoxelList(jnp.asarray(ids), jnp.asarray(ids_hi), jnp.asarray(payload), jnp.asarray(count, jnp.int32),
                            t.dims, t.side_length, t.kind, t.id_mode, t.map_type)
    if isinstance(t, TH.HierarchicalBitMap):
        _, pyramid = interop.to_numpy(t)
        return JH.HierarchicalBitMap(tuple(jnp.asarray(a) for a in pyramid), t.dims, t.side_length, t.levels)
    if isinstance(t, TBit):
        planes, occ = interop.to_numpy(t)
        return JBit(jnp.asarray(planes), t.dims, t.side_length, occ=jnp.asarray(occ))
    return JProb(jnp.asarray(interop.to_numpy(t)), t.dims, t.side_length)


@pytest.fixture(scope="module")
def scene():
    """A paged env (det), a second paged map, a dense hierarchy, a bit list
    and dense maps over one point set, built by the port and carried to the
    reference (ref_of)."""
    near = clusters(10, 60, centres=2, lo=4.0, hi=50.0)  # inside the 64^3 dense maps
    env = np.concatenate([clusters(7, 60, centres=3, spread=10.0), near])
    other = np.concatenate([env[:30], near[:30], clusters(8, 60, centres=2)])
    te = TP.PagedHierarchicalMap(DIMS, 1.0, device="cpu")
    te.insert_point_cloud(env)
    to = TP.PagedHierarchicalMap(DIMS, 1.0, device="cpu")
    to.insert_point_cloud(other)
    th = TH.HierarchicalBitMap.create(DIMS, device="cpu").insert_point_cloud(other)
    tl = TL.bit_vector_voxel_list(DIMS, device="cpu").insert_point_cloud(other, 50)
    dense = (64, 64, 64)
    tp = TProb.create(dense, device="cpu").insert_point_cloud(other)
    tb = TBit.create(dense, device="cpu").insert_point_cloud(other, 0)  # eBVM_FREE only: !isZero counts it
    return {key: (ref_of(t), t) for key, t in (("env", te), ("paged", to), ("hier", th), ("list", tl), ("prob", tp),
                                                  ("bit", tb))}


def test_collide_programs_match_reference(scene):
    """Every collide program: x list (offset forwarded, leaving the map
    never hits), x coords, x paged (no offset), x dense hierarchy in both
    directions, x dense maps at level 0 (the sparse gather, with an offset)
    and at a coarse level (the probe per map voxel), counting unknown, the
    resolution levels, and list -> paged dispatch."""
    je, te = scene["env"]
    jl, tl = scene["list"]
    for off in ((2, -1, 3), (200, 0, 0)):
        assert int(te.collide_with(tl, offset=off)) == int(je.collide_with(jl, offset=off))
    assert int(tl.collide_with(te)) == int(jl.collide_with(je))
    assert int(te.collide_with(tl)) > 0
    got, want = te.collide_with_counting_unknown(tl, min_level=4), je.collide_with_counting_unknown(jl, min_level=4)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert int(te.collide_with_resolution(tl, resolution_level=7)) == int(je.collide_with_resolution(jl, resolution_level=7))
    with pytest.raises(ValueError):
        te.collide_with_resolution(tl, resolution_level=te.fine_levels + 1)
    coords = np.floor(clusters(7, 60, centres=3, spread=10.0)).astype(np.int32)
    got = te.collide_with_counting_unknown_coords(coords, min_level=2, offset=(1, 0, 0))
    want = je.collide_with_counting_unknown_coords(coords, min_level=2, offset=(1, 0, 0))
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert int(te.collide_with_coords(coords, 2, (1, 0, 0))) == int(got[0])
    for key in ("paged", "hier"):
        jo, to = scene[key]
        assert int(te.collide_with(to)) == int(je.collide_with(jo)) > 0
        assert int(to.collide_with(te)) == int(te.collide_with(to))  # the count is symmetric
        with pytest.raises(ValueError, match="offset"):
            te.collide_with(to, offset=(1, 0, 0))
    jo, to = scene["paged"]
    assert int(te.collide_with(to, min_level=3)) == int(je.collide_with(jo, min_level=3))
    for key in ("prob", "bit"):
        jm, tm = scene[key]
        assert int(te.collide_with(tm, offset=(1, -2, 0))) == int(je.collide_with(jm, offset=(1, -2, 0))) > 0
    jm, tm = scene["prob"]
    got, want = te.collide_with_counting_unknown(tm, min_level=2), je.collide_with_counting_unknown(jm, min_level=2)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert int(te.collide_with(tm, min_level=2)) == int(got[0])  # the same probe per map voxel
    jm, tm = scene["bit"]
    assert int(te.collide_with(tm, min_level=2)) == int(je.collide_with(jm, min_level=2))
    with pytest.raises(TypeError):
        te.collide_with(object())


def test_morton_list_and_scale_32768():
    """Reference scale (15 levels, 32768^3 virtual voxels): exact probes at
    every level band and a morton list whose coords pass 1,024, collided with
    an offset; memory stays sparse (tests/test_paged.py:114, :151)."""
    dims = (32768,) * 3
    j, t = pair(dims=dims)
    pts = np.array([[31000.5, 17.5, 22222.5], [5.5, 30000.5, 12345.5], [31000.5, 17.5, 22223.5]], np.float32)
    j.insert_point_cloud(pts)
    t.insert_point_cloud(pts)
    same(t, j)
    assert t.fine_levels >= 15 and t.memory_usage() < 300 * 1024 * 1024
    q = np.array([[31000, 17, 22222], [31000, 16, 22222], [31007, 23, 22216], [31039, 60, 22270], [1, 1, 1]], np.int32)
    for lvl in (0, 1, 3, 6, 9, t.fine_levels):
        np.testing.assert_array_equal(t.probe_status(q, lvl).numpy(), np.asarray(j.probe_status(jnp.asarray(q), lvl)))
    jl = JL.bit_vector_morton_voxel_list(dims).insert_point_cloud(pts - np.float32(1.0), 50)
    tl = TL.bit_vector_morton_voxel_list(dims, device="cpu").insert_point_cloud(pts - np.float32(1.0), 50)
    for off in ((0, 0, 0), (1, 1, 1)):
        assert int(t.collide_with(tl, offset=off)) == int(j.collide_with(jl, offset=off))
    assert int(t.collide_with(tl, offset=(1, 1, 1))) == 3


def test_small_side_length_and_far_points():
    """A 0.01 m side length with points far outside the map: no phantom
    voxel (tests/test_paged.py:497), and the build with a free bounding box
    checked before the map is cleared."""
    j, t = pair(dims=(2048, 2048, 2048), side=0.01)
    pts = np.array([[5.115, 5.115, 5.115], [5.125, 5.115, 5.115], [5.135, 5.115, 5.115], [-1e9, 5.0, 5.0]], np.float32)
    j.insert_point_cloud(pts)
    t.insert_point_cloud(pts)
    same(t, j)
    assert len(t.extract_occupied_coords()) == 3
    j.build(pts[:3], free_bounding_box=True)
    t.build(pts[:3], free_bounding_box=True)
    same(t, j)
    with pytest.raises(ValueError, match="free bounding box"):
        t.build(np.array([[0.0, 0.0, 0.0], [20.0, 20.0, 20.0]], np.float32), free_bounding_box=True)
    assert t.n_tiles() == j.n_tiles() > 0  # the rejected box left the map as it was


def test_adapter_contract_methods():
    """insertMetaPointCloud takes the first meaning, insertRobotConfiguration
    reports self-collisions, clearBitVoxelMeaning only eBVM_OCCUPIED, and
    the maintenance calls (tests/test_paged.py:633)."""
    from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta

    link = np.array([[10.5, 10.5, 10.5]], np.float32)
    j, t = pair()
    for clouds, clash in (([link, link + 3.0], False), ([link, link], True)):
        _, jok = j.insert_robot_configuration(JMeta.from_clouds(clouds), with_self_collision_test=True)
        _, tok = t.insert_robot_configuration(TMeta.from_clouds(clouds, device="cpu"), with_self_collision_test=True)
        assert tok == jok == (not clash)
        same(t, j)
    j.insert_meta_point_cloud(JMeta.from_clouds([link + 9.0]), meanings=[0, 1])
    t.insert_meta_point_cloud(TMeta.from_clouds([link + 9.0], device="cpu"), meanings=[0, 1])
    same(t, j)
    assert t.clear_voxel_meaning(5) is t and t.n_tiles() > 0
    assert not t.needs_rebuild() and t.rebuild() is t and t.clear_collision_flags() is t
    t.clear_voxel_meaning(1)
    j.clear_voxel_meaning(1)
    same(t, j)


def _lin(c, dim):
    return (int(c[2]) * dim + int(c[1])) * dim + int(c[0])


@pytest.mark.parametrize("prob", [False, True], ids=["det", "prob"])
def test_paged_fuzz_differential(prob):
    """tests/test_paged_fuzz.py as a differential fuzz with few steps: random
    occupied / free point inserts and sensor free-space inserts, after each
    step the whole state equal to the reference's, and the probes, the
    coords collide and the log-odds equal to a host cell model."""
    dim = 128
    rng = np.random.default_rng(2 if not prob else 7)
    j, t = pair(prob, dims=(dim,) * 3)
    origin = np.array([64.5, 64.5, 64.5], np.float32)
    probes = rng.integers(0, dim, (128, 3)).astype(np.int32)
    model = {}
    for step in range(3):
        op = ("occ", "free", "sensor")[step]
        if op in ("occ", "free"):
            pts = rng.uniform(0.0, dim, (64, 3)).astype(np.float32)
            meaning = BitVoxelMeaning.eBVM_OCCUPIED if op == "occ" else BitVoxelMeaning.eBVM_FREE
            j.insert_point_cloud(pts, meaning)
            t.insert_point_cloud(pts, meaning)
            v = (MAX_PROBABILITY if op == "occ" else MIN_PROBABILITY) if prob else op
            for c in np.floor(pts).astype(np.int64):
                model[_lin(c, dim)] = v
        else:
            pts = safe_rays(step, origin, 16, 64, lo=8.0, hi=dim - 8.0)
            j.insert_point_cloud_with_free_space(pts, origin, max_steps=64)
            t.insert_point_cloud_with_free_space(pts, origin, max_steps=64)
            cells, live = TP._free_ray_cells(torch.tensor(pts), torch.tensor(origin), 1.0, (dim,) * 3, 64)
            cells = cells.reshape(-1, 3)[live.reshape(-1)].numpy()
            delta = {}
            for c in cells:
                delta[_lin(c, dim)] = delta.get(_lin(c, dim), 0) + SENSOR_MODEL_FREE
            hits = np.floor(pts).astype(np.int64)
            for c in hits:
                delta[_lin(c, dim)] = delta.get(_lin(c, dim), 0) + SENSOR_MODEL_OCCUPIED
            for k, d in delta.items():
                if prob:
                    model[k] = max(min(model.get(k, UNKNOWN_PROBABILITY) + d, MAX_PROBABILITY), MIN_PROBABILITY)
                elif k not in {_lin(c, dim) for c in hits}:
                    model[k] = "free"
            for c in hits:
                if not prob:
                    model[_lin(c, dim)] = "occ"
        same(t, j)
        occ, unk, free = (x.numpy() for x in t.probe(probes))
        for i, c in enumerate(probes):
            v = model.get(_lin(c, dim))
            if prob:
                v = UNKNOWN_PROBABILITY if v is None else v
                assert bool(occ[i]) == (v != UNKNOWN_PROBABILITY and v >= 10) and bool(unk[i]) == (v == UNKNOWN_PROBABILITY)
            else:
                assert ("occ" if occ[i] else "free" if free[i] else None) == v
        if prob:
            want = [model.get(_lin(c, dim), UNKNOWN_PROBABILITY) for c in probes]
            assert t.probe_occupancy(probes).tolist() == want
        else:
            assert int(t.collide_with_coords(probes)) == sum(model.get(_lin(c, dim)) == "occ" for c in probes)
        assert t.check_tree()


def test_snapshot_is_frozen_and_interop_round_trips():
    """A snapshot keeps the state it was taken from (updates make new
    tensors); interop carries the whole state both ways."""
    j, t = pair(prob=True)
    pts = clusters(9, 60, centres=2)
    j.insert_point_cloud(pts)
    t.insert_point_cloud(pts)
    snap = t.snapshot()
    before = snap.probe_status(np.floor(pts).astype(np.int32)).clone()
    t.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE)
    assert torch.equal(snap.probe_status(np.floor(pts).astype(np.int32)), before)
    j.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE)
    back = interop.paged_map_from_numpy(interop.to_numpy(t), device="cpu")
    same(back, j)
    back.insert_point_cloud(pts + 30.0)
    j.insert_point_cloud(pts + 30.0)
    same(back, j)
