"""Port conformance: the dense hierarchical tier (maps/hierarchical.py).

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch on the CPU; status pyramids, occupancy grids, probe
statuses and collision counts must be equal. Depth fusion is held against
the reference map's own (jitted) method and, for the prob tier, against the
reference's frame update run op by op (`raycast.insert_depth_image`) on the
padded grid, as tests/test_torch_raycast.py does: the fixture keeps every
measured point at least 1e-3 voxel from a cell boundary. The reference compiles one program per shape and
static argument, so the fixtures reuse point counts and dims.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import sensors as jsens
from gpu_voxels_tpu.constants import MAX_PROBABILITY, MIN_PROBABILITY, UNKNOWN_PROBABILITY, BitVoxelMeaning
from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
from gpu_voxels_tpu.maps import hierarchical as J
from gpu_voxels_tpu.maps import voxellist as JL
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import raycast as jrc
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch import sensors as tsens
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
from gpu_voxels_tpu_torch.maps import hierarchical as T
from gpu_voxels_tpu_torch.maps import voxellist as TL
from gpu_voxels_tpu_torch.maps.paged import fold_or
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops.insert import map_to_voxels


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


CUBE = (32, 32, 32)
RAGGED = (40, 36, 33)  # pads to 64 x 64 x 64 at 5 levels: voxels past dims exist
SIDE = 0.1
KINDS = {"bit": (J.HierarchicalBitMap, T.HierarchicalBitMap), "prob": (J.HierarchicalProbMap, T.HierarchicalProbMap)}


def pair(kind, dims=CUBE, side=SIDE):
    jcls, tcls = KINDS[kind]
    return jcls.create(dims, side), tcls.create(dims, side, device="cpu")


def same(t, j):
    """The port's map holds the reference map's state exactly."""
    assert (t.dims, t.side_length, t.levels, int(t.map_type)) == (j.dims, j.side_length, j.levels, int(j.map_type))
    occ, pyramid = interop.to_numpy(t)
    assert len(pyramid) == len(j.pyramid)
    for got, want in zip(pyramid, j.pyramid):
        np.testing.assert_array_equal(got, np.asarray(want))
    if isinstance(j, J.HierarchicalProbMap):
        np.testing.assert_array_equal(occ, np.asarray(j.occupancy))
    assert t.memory_usage() == j.memory_usage()


def points(seed, dims, n=96, side=SIDE, spill=0.0):
    rng = np.random.default_rng(seed)
    ext = np.array(dims, np.float64) * side
    return rng.uniform(-spill * ext, (1 + spill) * ext, (n, 3)).astype(np.float32)


def probe_coords(seed, padded, n=400):
    """Coordinates inside the padded grid and around it (the reference's
    gathers count a negative index from the end once, then clamp)."""
    rng = np.random.default_rng(seed)
    hi = np.array(padded) + 3
    return rng.integers(-3 - np.array(padded), hi, (n, 3)).astype(np.int32)


def test_fold_or_matches_numpy_bitwise_or():
    """H13: torch has no bitwise-OR reduction; the fold by halves equals
    np.bitwise_or.reduce on random bytes (a sum or a max would not)."""
    rng = np.random.default_rng(0)
    for width in (512, 8, 1):
        rows = rng.integers(0, 256, (300, width), dtype=np.uint8)
        rows[:40] &= rng.integers(0, 256, (40, 1), dtype=np.uint8)  # rows with few bits
        rows[40:50] = 0
        got = fold_or(torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(got, np.bitwise_or.reduce(rows, axis=1))
    rows = np.array([[1, 1, 2, 0], [4, 4, 4, 4]], np.uint8)
    assert fold_or(torch.from_numpy(rows)).tolist() == [3, 4]  # a sum gives 4 and 16, a max 2 and 4


def test_status_helpers_match_reference():
    s = np.arange(256, dtype=np.uint8)
    for got, want in zip(T.decode_status_flags(torch.from_numpy(s)), J.decode_status_flags(s)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T._is_uniform(torch.from_numpy(s)).numpy(), np.asarray(J._is_uniform(jnp.asarray(s))))
    occ = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(T._status_from_occupancy(torch.from_numpy(occ)).numpy(),
                                  np.asarray(J._status_from_occupancy(jnp.asarray(occ))))
    for dims in (CUBE, RAGGED, (2048, 64, 64), (3, 9, 700), (1, 1, 1)):
        assert T._num_levels(dims) == J._num_levels(dims)
        assert T._pad_dims(dims, 5) == J._pad_dims(dims, 5)
    assert (T.NS_FREE, T.NS_UNKNOWN, T.NS_OCCUPIED, T.NS_STATIC_MAP, T.NS_DYNAMIC_MAP) == (
        J.NS_FREE, J.NS_UNKNOWN, J.NS_OCCUPIED, J.NS_STATIC_MAP, J.NS_DYNAMIC_MAP)


def _probes_equal(t, j, seed):
    c = probe_coords(seed, t.padded_dims)
    for min_level in range(t.levels + 1):
        want = np.asarray(j.probe_status(jnp.asarray(c), min_level))
        np.testing.assert_array_equal(t.probe_status(c, min_level).numpy(), want, err_msg=str(min_level))
        for got, flag in zip(t.probe(c, min_level), J.decode_status_flags(want)):
            np.testing.assert_array_equal(got.numpy(), flag)


@pytest.mark.parametrize("dims", [CUBE, RAGGED], ids=["32^3", "40x36x33"])
@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_inserts_pyramid_and_probes(kind, dims):
    j, t = pair(kind, dims)
    same(t, j)
    pts = points(1, dims, spill=0.1)  # some past dims (inside the padding or outside)
    steps = [(pts, BitVoxelMeaning.eBVM_OCCUPIED), (points(2, dims, spill=0.1), BitVoxelMeaning.eBVM_FREE),
             (points(3, dims), BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)][:3 if dims == CUBE else 2]
    for cloud, meaning in steps:
        j, t = j.insert_point_cloud(cloud, meaning), t.insert_point_cloud(cloud, meaning)
        same(t, j)
    if kind == "bit":
        j = j.insert_point_cloud(steps[1][0], BitVoxelMeaning.eBVM_OCCUPIED, static_map=False)
        t = t.insert_point_cloud(steps[1][0], BitVoxelMeaning.eBVM_OCCUPIED, static_map=False)
        same(t, j)
        assert bool((t.status.to(torch.int32) & T.NS_DYNAMIC_MAP).any())
    _probes_equal(t, j, 2)
    np.testing.assert_array_equal(t.extract_occupied_coords(), j.extract_occupied_coords())
    assert t.check_tree() and j.check_tree()
    if dims != CUBE:
        return
    # build with and without the free bounding box (a box of the cloud's
    # first voxels); propagate; clear
    box = np.concatenate([pts[:5]] * 19 + [pts[:1]]) * 0.3
    for flag in (True, False):
        same(t.build(box, free_bounding_box=flag), j.build(box, free_bounding_box=flag))
    same(t.propagate(), j.propagate())
    same(t.clear_map(), j.clear_map())
    broken = T.HierarchicalBitMap(t.pyramid[:1] + (torch.zeros_like(t.pyramid[1]),) + t.pyramid[2:], t.dims,
                                  t.side_length, t.levels)
    assert not broken.check_tree()


def _sample_margin(origin, pts, side, max_steps):
    """Least distance (voxels) of every DDA sample and endpoint from a cell
    boundary, in float64 from the reference's formula."""
    recip = float(np.float32(1.0 / side))
    start = np.asarray(origin, np.float64) * recip
    out = np.inf
    for e in np.asarray(pts, np.float64) * recip:
        delta = e - start
        steps = int(np.ceil(np.abs(delta).max()))
        k = np.arange(min(steps, max_steps))[:, None]
        pos = np.concatenate([start + delta / max(steps, 1) * k, e[None]])
        out = min(out, float(np.abs(pos - np.round(pos)).min()))
    return out


def _safe_rays(seed, origin, dims, n=64, max_steps=64):
    rng = np.random.default_rng(seed)
    ext = np.array(dims) * SIDE
    pts = rng.uniform(0.05 * ext, 0.95 * ext, (3 * n, 3)).astype(np.float32)
    keep = [i for i in range(len(pts)) if _sample_margin(origin, pts[i:i + 1], SIDE, max_steps) >= 2e-3]
    pts = pts[keep[:n]]
    assert len(pts) == n and _sample_margin(origin, pts, SIDE, max_steps) >= 1e-3
    return pts


@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_free_space_insert_matches_reference(kind):
    """insert_point_cloud_with_free_space: the DDA carve on the padded grid
    (every ray sample >= 1e-3 voxel from a cell boundary: F11)."""
    origin = (1.613, 1.587, 0.231)
    pts = _safe_rays(4, origin, RAGGED)
    j, t = pair(kind, RAGGED)
    for _ in range(2):
        j = j.insert_point_cloud_with_free_space(pts, origin, max_steps=64)
        t = t.insert_point_cloud_with_free_space(pts, origin, max_steps=64)
        same(t, j)
    occ, _, free = T.decode_status_flags(t.pyramid[0])
    assert int(free.sum()) > 100 and int(occ.sum()) > 0


INTR = (52.0, 52.0, 32.0, 24.0)


def _fusion_frames(tsensor):
    """Three 64x48 frames of a wall and a box, pixels whose world point comes
    within 2e-3 voxel of a cell boundary marked invalid."""
    rng = np.random.default_rng(11)
    frames = []
    for k in range(3):
        depth = np.full((48, 64), 2.4 + 0.05 * k, np.float32)
        depth[10:30, 20:44] = 1.3
        depth[40:46, 2:9] = 0.0
        depth += rng.normal(0, 0.01, depth.shape).astype(np.float32)
        fx, fy, cx, cy = INTR
        u, v = np.arange(64)[None, :], np.arange(48)[:, None]
        z = depth.astype(np.float64)
        cam = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], -1).reshape(-1, 3)
        pose = tsensor.pose().astype(np.float64)
        f = (cam @ pose[:3, :3].T + pose[:3, 3]) / SIDE
        depth[(np.abs(f - np.round(f)) < 2e-3).any(axis=1).reshape(48, 64)] = 0.0
        world = tsensor.process_depth_image(depth, device="cpu").numpy().astype(np.float64)
        world = world[np.isfinite(world).all(1)] / SIDE
        assert len(world) > 2000 and np.abs(world - np.round(world)).min() >= 1e-3
        frames.append(depth)
    return frames


def _sensors():
    kw = dict(position=np.asarray([1.6, 1.55, 0.05], np.float32),
              orientation_rpy=np.asarray([0.05, -0.03, 0.02], np.float32),
              data_width=64, data_height=48, fx=INTR[0], fy=INTR[1], cx=INTR[2], cy=INTR[3])
    return jsens.Sensor(**kw), tsens.Sensor(**kw)


@pytest.mark.parametrize("pool", [1, 8])
@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_depth_fusion_matches_reference(kind, pool):
    """insert_depth_image at carve_pool 1 (K3's spec on the CPU) and 8 (K6's):
    equal to the reference map's own (jitted) method and, for the prob tier,
    to the reference's frame update run op by op on the padded grid."""
    jsensor, tsensor = _sensors()
    j, t = pair(kind, RAGGED)
    jm = j
    for depth in _fusion_frames(tsensor):
        t = t.insert_depth_image(depth, tsensor, carve_pool=pool)
        jm = jm.insert_depth_image(depth, jsensor, carve_pool=pool)
        same(t, jm)
        if kind == "prob":
            flat = jrc.insert_depth_image(j.occupancy.reshape(-1), jnp.asarray(depth), jnp.asarray(jsensor.pose()),
                                          *INTR, SIDE, j.padded_dims, carve_pool=pool)
            j = j._rebuilt(flat.reshape(j.occupancy.shape))
            same(t, j)
    occ, _, free = t.probe(t.extract_occupied_coords())
    assert bool(occ.all()) and int(occ.sum()) > 100
    assert int(T.decode_status_flags(t.pyramid[0])[2].sum()) > 1000


def _lists(pts, dims=CUBE, meaning=50):
    jl = JL.bit_vector_voxel_list(dims, SIDE).insert_point_cloud(pts, meaning)
    tl = TL.bit_vector_voxel_list(dims, SIDE, device="cpu").insert_point_cloud(pts, meaning)
    return jl, tl


@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_collides_every_direction(kind):
    """octree x list (offset forwarded, coords leaving the map never hit),
    x prob map (occ >= 50), x bit map (!isZero: an eBVM_FREE-only voxel
    counts), x octree (levels 0 and 3; an offset is rejected), counting
    unknown, the resolution levels, and list -> octree dispatch."""
    pts = points(5, CUBE)
    j, t = pair(kind, CUBE)
    j, t = j.insert_point_cloud(pts), t.insert_point_cloud(pts)
    jl, tl = _lists(np.concatenate([pts[:40], points(6, CUBE, n=40)]))
    for off in ((0, 0, 0), (3, -2, 1), (40, 0, 0)):
        assert int(t.collide_with(tl, offset=off)) == int(j.collide_with(jl, offset=off))
        assert int(tl.collide_with(t, offset=off)) == int(jl.collide_with(j, offset=off))
    got = t.collide_with_counting_unknown(tl, min_level=1, offset=(3, -2, 1))
    want = j.collide_with_counting_unknown(jl, min_level=1, offset=(3, -2, 1))
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1])) and int(got[1]) > 0
    assert int(t.collide_with(tl)) > 0
    for lvl in (0, 2, t.levels):
        assert int(t.collide_with_resolution(tl, resolution_level=lvl)) == int(
            j.collide_with_resolution(jl, resolution_level=lvl))
    with pytest.raises(ValueError):
        t.collide_with_resolution(tl, resolution_level=t.levels + 1)
    weak = pts[:30]
    jp = JProb.create(CUBE, SIDE).insert_point_cloud(weak).insert_point_cloud(weak[:10], BitVoxelMeaning.eBVM_FREE)
    tp = TProb.create(CUBE, SIDE, device="cpu").insert_point_cloud(weak).insert_point_cloud(weak[:10], 0)
    jb = JBit.create(CUBE, SIDE).insert_point_cloud(weak, 0)  # only eBVM_FREE: !isZero still holds
    tb = TBit.create(CUBE, SIDE, device="cpu").insert_point_cloud(weak, 0)
    for jm, tm in ((jp, tp), (jb, tb)):
        for off in ((0, 0, 0), (1, 0, -2)):
            assert int(t.collide_with(tm, offset=off)) == int(j.collide_with(jm, offset=off))
        assert int(t.collide_with(tm, min_level=2)) == int(j.collide_with(jm, min_level=2))
    assert int(t.collide_with(tb)) > 0 and int(t.collide_with(tp)) > 0
    j2, t2 = pair(kind, CUBE)
    other = points(7, CUBE)
    j2, t2 = j2.insert_point_cloud(other), t2.insert_point_cloud(other)
    for lvl in (0, 3):
        assert int(t.collide_with(t2, min_level=lvl)) == int(j.collide_with(j2, min_level=lvl))
    with pytest.raises(ValueError, match="offset"):
        t.collide_with(t2, offset=(1, 0, 0))


def test_morton_list_past_1024():
    """Morton lists carry 60-bit ids: the probe decodes the high word, and a
    coordinate mod 1024 does not alias (tests/test_hierarchical.py:199)."""
    dims = (2048, 8, 8)
    p = np.array([[976.5, 3.5, 4.5]], np.float32)
    t = T.HierarchicalProbMap.create(dims, device="cpu").insert_point_cloud(p)
    j = J.HierarchicalProbMap.create(dims).insert_point_cloud(p)
    for x, want in ((2000.5, 0), (976.5, 1)):
        q = np.array([[x, 3.5, 4.5]], np.float32)
        lst = TL.VoxelList.create(dims, 1.0, "bit", 8, "morton", device="cpu").insert_point_cloud(q)
        jlst = JL.VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton").insert_point_cloud(q)
        assert int(t.collide_with(lst)) == int(j.collide_with(jlst)) == want


@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_adapter_contract_methods(kind):
    """insertMetaPointCloud takes the first meaning, clearBitVoxelMeaning only
    eBVM_OCCUPIED, insertRobotConfiguration reports self-collisions, and the
    maintenance calls (tests/test_hierarchical.py:272-317)."""
    link = np.array([[0.255, 0.255, 0.255]], np.float32)
    j, t = pair(kind, (16, 16, 16))
    for clouds in ([link, link + 0.2], [link, link]):
        jm, tm = JMeta.from_clouds(clouds), TMeta.from_clouds(clouds, device="cpu")
        jn, jok = j.insert_robot_configuration(jm, with_self_collision_test=True)
        tn, tok = t.insert_robot_configuration(tm, with_self_collision_test=True)
        same(tn, jn)
        assert bool(tok) == bool(jok) == (clouds[1] is not clouds[0])
        same(t.insert_meta_point_cloud(tm, meanings=[5, 1]), j.insert_meta_point_cloud(jm, meanings=[5, 1]))
    filled = t.insert_point_cloud(link)
    assert filled.clear_voxel_meaning(5) is filled
    same(filled.clear_voxel_meaning(1), j.clear_voxel_meaning(1))
    assert not t.needs_rebuild() and t.rebuild() is t and t.clear_collision_flags() is t


@pytest.mark.parametrize("seed", [3, 12])
def test_hier_fuzz_differential(seed):
    """tests/test_hier_fuzz.py as a differential fuzz with few steps: random
    occupied / free / unknown-meaning inserts into a HierarchicalProbMap,
    after each step the pyramid, the probes and the counting-unknown collide
    against a fixed list equal the reference's and a host cell model."""
    dim = 32
    rng = np.random.default_rng(seed)
    j, t = pair("prob", (dim,) * 3)
    values = {BitVoxelMeaning.eBVM_OCCUPIED: MAX_PROBABILITY, BitVoxelMeaning.eBVM_FREE: MIN_PROBABILITY,
              BitVoxelMeaning.eBVM_SWEPT_VOLUME_START: UNKNOWN_PROBABILITY}
    probes = rng.integers(0, dim, (128, 3)).astype(np.int32)
    jq = JL.bit_vector_voxel_list((dim,) * 3).insert_point_cloud(probes.astype(np.float32) + 0.5, 50)
    tq = TL.bit_vector_voxel_list((dim,) * 3, device="cpu").insert_point_cloud(probes.astype(np.float32) + 0.5, 50)
    model = {}
    for step in range(5):
        meaning = list(values)[rng.integers(0, 3)]
        pts = rng.uniform(0.0, dim * SIDE, (96, 3)).astype(np.float32)
        j, t = j.insert_point_cloud(pts, meaning), t.insert_point_cloud(pts, meaning)
        for c in map_to_voxels(torch.from_numpy(pts), SIDE).tolist():  # the cell of each point
            model[tuple(c)] = values[meaning]
        same(t, j)
        occ, unk, free = (x.numpy() for x in t.probe(probes))
        for i, c in enumerate(probes):
            v = model.get(tuple(c), UNKNOWN_PROBABILITY)
            assert bool(occ[i]) == (v != UNKNOWN_PROBABILITY and v >= 10) and bool(unk[i]) == (v == UNKNOWN_PROBABILITY)
        got, want = t.collide_with_counting_unknown(tq), j.collide_with_counting_unknown(jq)
        assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
        assert t.check_tree()


def test_interop_round_trip():
    j, t = pair("prob", RAGGED)
    t = t.insert_point_cloud(points(8, RAGGED))
    occ, pyramid = interop.to_numpy(t)
    back = interop.hierarchical_map_from_numpy(pyramid, t.dims, t.side_length, t.levels, occupancy=occ, device="cpu")
    jback = J.HierarchicalProbMap(jnp.asarray(occ), tuple(jnp.asarray(p) for p in pyramid), t.dims, t.side_length,
                                  t.levels)
    same(back, jback)
    bits = interop.hierarchical_map_from_numpy(pyramid, t.dims, t.side_length, t.levels, device="cpu")
    assert isinstance(bits, T.HierarchicalBitMap) and bits.check_tree()
    with pytest.raises(ValueError):
        interop.hierarchical_map_from_numpy(pyramid[:-1], t.dims, t.side_length, t.levels, device="cpu")
