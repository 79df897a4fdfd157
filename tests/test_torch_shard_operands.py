"""Port conformance: slab-sharded map values as operands of every tier.

In the reference `shard_map_value` returns the same map value laid over the
mesh, so every function that takes a map also takes it sharded. In the port a
sharded dense map (parallel/shard_value.ShardedDenseMap) or pyramid
(ShardedPyramid) is a value of its own; this file holds each tier that takes
a map operand to the single-device call when the operand is sharded over an
8-slab CPU mesh (`make_grid_mesh(8, devices=["cpu"])`), on the 16 x 16 x 32
grid of tests/test_torch_sharded.py:

  * F26: a plain or sharded HierarchicalBitMap / HierarchicalProbMap probing
    a sharded prob / bit map (collide_with, collide_with_resolution,
    collide_with_counting_unknown);
  * F27: a plain ProbVoxelMap / BitVectorVoxelMap against a sharded dense map
    (collide_with, collide_with_resolution, collide_with_marking,
    collide_with_types, collide_with_bitcheck, merge), and the reverse order;
  * F28: every voxel list against a sharded prob / bit map (collide_with,
    collide_with_resolution with cubes the slab boundaries cut,
    collide_with_dense, collide_with_type_mask);
  * F29: PagedHierarchicalMap and ShardedPagedWorld against a sharded dense
    map;
  * F30: vis/extract's occupied_coords / extract_cubes of a sharded dense map
    or pyramid; F31: extract_multilevel_cubes of a sharded pyramid; F32: the
    caller's threshold on a sharded HierarchicalProbMap's extraction; and
    VisProvider drawing a sharded map, slab by slab.

Counts also equal the set oracle |A n B| of the two floor-voxelized clouds.
The pairs the reference refuses with TypeError (dense x list, dense x octree)
raise the same message whether the operand is plain or sharded. No repaired
call may gather a sharded operand whole: `ShardedDenseMap.gather` and
`ShardedPyramid.gather` raise throughout this file. One case per fault family
is also held against the reference's own sharded value on its 8-device
virtual CPU mesh.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps.hierarchical import HierarchicalBitMap as JBitH
from gpu_voxels_tpu.maps.paged import PagedHierarchicalMap as JPaged
from gpu_voxels_tpu.maps.voxellist import VoxelList as JVoxelList
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.parallel import make_grid_mesh as jmake_grid_mesh
from gpu_voxels_tpu.parallel import shard_map_value as jshard_map_value
from gpu_voxels_tpu.vis import extract as jextract
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld, make_grid_mesh, shard_map_value
from gpu_voxels_tpu_torch.parallel import shard_value
from gpu_voxels_tpu_torch.parallel.shard_value import ShardedDenseMap, ShardedPyramid
from gpu_voxels_tpu_torch.vis import extract
from gpu_voxels_tpu_torch.vis.provider import VisProvider


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


def _whole_gather(self, device=None):
    raise AssertionError(f"a sharded {self._base_cls.__name__} was gathered whole")


@pytest.fixture(autouse=True)
def no_whole_gather(monkeypatch):
    """Every repaired call reads a sharded operand slab by slab."""
    monkeypatch.setattr(ShardedDenseMap, "gather", _whole_gather)
    monkeypatch.setattr(ShardedPyramid, "gather", _whole_gather)


DIMS = (16, 16, 32)  # 8 slabs of 4 rows
MESH = make_grid_mesh(8, devices=["cpu"])
PAGED_DIMS = (64, 64, 128)  # the world: 2 slabs of one page row each
LISTS = {"bitlist": ("bit", "linear"), "mortonlist": ("bit", "morton"), "problist": ("prob", "linear"),
         "countlist": ("count", "linear")}
SV_A, SV_B = 10, 12  # swept-volume meanings two steps apart


def _clouds():
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, np.asarray(DIMS) - 0.5, (300, 3)).astype(np.float32)
    b = rng.uniform(0.5, np.asarray(DIMS) - 0.5, (300, 3)).astype(np.float32)
    b[:60] = a[:60]  # a shared part across every slab
    return a, b


PTS_A, PTS_B = _clouds()


def _voxels(pts) -> set:
    return {tuple(v) for v in np.floor(pts).astype(np.int64)}


ORACLE = len(_voxels(PTS_A) & _voxels(PTS_B))


def _make(kind: str, pts, meaning=None):
    kw = {} if meaning is None else {"meaning": meaning}
    if kind in LISTS:
        k, mode = LISTS[kind]
        return VoxelList.create(DIMS, 1.0, kind=k, capacity=1024, id_mode=mode, device="cpu").insert_point_cloud(
            torch.tensor(pts), **kw)
    cls = {"prob": ProbVoxelMap, "bit": BitVectorVoxelMap, "counting": CountingVoxelMap,
           "distance": DistanceVoxelMap, "hierbit": HierarchicalBitMap, "hierprob": HierarchicalProbMap}[kind]
    return cls.create(DIMS, 1.0, device="cpu").insert_point_cloud(torch.tensor(pts), **kw)


@pytest.fixture(scope="module")
def maps():
    """The A and B maps of every tier, and the swept-volume bit maps."""
    kinds = ("prob", "bit", "counting", "distance", "hierbit", "hierprob") + tuple(LISTS)
    out = {(side, k): _make(k, pts) for side, pts in (("A", PTS_A), ("B", PTS_B)) for k in kinds}
    out["A", "sv"] = _make("bit", PTS_A, SV_A)
    out["B", "sv"] = _make("bit", PTS_B, SV_B)
    return out


def _shard(m):
    return shard_map_value(m, MESH)


def _value(x):
    """A result as host values: counts and tensors as arrays, maps as their
    tensor fields (a sharded map's slabs joined), tuples item by item."""
    if isinstance(x, tuple):
        return tuple(_value(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, ShardedDenseMap):
        x = shard_value._joined(x, torch.device("cpu"))
    if isinstance(x, (ProbVoxelMap, BitVectorVoxelMap)):
        return (type(x).__name__, x.dims, x.data.numpy(), None if getattr(x, "occ", None) is None else x.occ.numpy())
    return x


def same(got, want) -> bool:
    """A result against the single-device one, exactly (dtypes too)."""
    return _same(_value(got), _value(want))


def _same(g, w) -> bool:
    if isinstance(w, tuple):
        return isinstance(g, tuple) and len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w))
    if isinstance(w, np.ndarray):
        return isinstance(g, np.ndarray) and g.dtype == w.dtype and np.array_equal(g, w)
    return g == w


def _count(r) -> int:
    return int(r[0] if isinstance(r, tuple) else r)


# -- F26: a pyramid probing a sharded dense map ----------------------------------------
@pytest.mark.parametrize("call", ["collide_with", "collide_with_resolution", "collide_with_counting_unknown"])
@pytest.mark.parametrize("other", ["prob", "bit"])
@pytest.mark.parametrize("sharded_self", [False, True], ids=["plain", "sharded"])
@pytest.mark.parametrize("tier", ["hierbit", "hierprob"])
def test_f26_pyramid_probes_a_sharded_dense_map(maps, tier, sharded_self, other, call):
    a, b = maps["A", tier], maps["B", other]
    got = getattr(_shard(a) if sharded_self else a, call)(_shard(b))
    want = getattr(a, call)(b)
    assert same(got, want)
    assert _count(got) == ORACLE


@pytest.mark.parametrize("other", ["prob", "bit"])
@pytest.mark.parametrize("tier", ["hierbit", "hierprob"])
def test_f26_offset_and_coarse_levels(maps, tier, other):
    """An offset that moves the probes across slabs, and a probe stopped at
    levels 1 and 2 (cubes of 2 and 4 rows)."""
    a, b = maps["A", tier], maps["B", other]
    sa, sb = _shard(a), _shard(b)
    for kw in ({"offset": (1, -2, 5)}, {"min_level": 1, "offset": (0, 0, -3)}, {"min_level": 2}):
        assert same(a.collide_with(sb, **kw), a.collide_with(b, **kw)), kw
        assert same(sa.collide_with_counting_unknown(sb, **kw), a.collide_with_counting_unknown(b, **kw)), kw
    assert same(sa.collide_with_resolution(sb, resolution_level=3), a.collide_with_resolution(b, resolution_level=3))


# -- F27: a plain dense map against a sharded one ----------------------------------------
F27 = [
    ("prob", "prob", "collide_with", {}),
    ("prob", "bit", "collide_with", {}),
    ("bit", "bit", "collide_with", {}),
    ("bit", "prob", "collide_with", {}),
    ("prob", "prob", "collide_with", {"offset": (3, 1, -9)}),
    ("bit", "prob", "collide_with", {"offset": (-2, 0, 6)}),
    ("prob", "prob", "collides_with", {}),
    ("prob", "prob", "collide_with_resolution", {"resolution_level": 3}),
    ("prob", "bit", "collide_with_resolution", {"resolution_level": 1, "offset": (0, 1, 5)}),
    ("bit", "bit", "collide_with_resolution", {"resolution_level": 3}),
    ("bit", "prob", "collide_with_resolution", {}),
    ("prob", "prob", "collide_with_marking", {"offset": (3, 1, -9)}),
    ("sv", "sv", "collide_with_types", {"sv_window": 2}),
    ("sv", "prob", "collide_with_types", {}),
    ("sv", "sv", "collide_with_bitcheck", {"margin": 2}),
    ("sv", "sv", "collide_with_bitcheck", {"margin": 1}),
    ("prob", "prob", "merge", {}),
    ("bit", "sv", "merge", {}),
    ("sv", "bit", "merge", {"new_meaning": 20}),
]


@pytest.mark.parametrize("order", ["plain x sharded", "sharded x plain"])
@pytest.mark.parametrize("mine,theirs,call,kw", F27, ids=[f"{a}-{b}-{c}-{i}" for i, (a, b, c, _) in enumerate(F27)])
def test_f27_dense_map_against_a_sharded_one(maps, mine, theirs, call, kw, order):
    """Counts on self's device, a marked or merged map in self's layout: plain
    for a plain self, sharded for a sharded one."""
    a, b = maps["A", mine], maps["B", theirs]
    want = getattr(a, call)(b, **kw)
    if order == "plain x sharded":
        got = getattr(a, call)(_shard(b), **kw)
        for part in got if isinstance(got, tuple) else (got,):
            assert not isinstance(part, ShardedDenseMap)
    else:
        got = getattr(_shard(a), call)(b, **kw)
    assert same(got, want)
    if call in ("collide_with", "collide_with_resolution") and kw == {}:
        assert _count(got) == ORACLE


def test_f27_distance_map_takes_sharded_operands(maps):
    """A plain DistanceVoxelMap merges a sharded prob map's occupied voxels
    and counts its differences to a sharded distance map, as to plain ones."""
    d = DistanceVoxelMap.create(DIMS, 1.0, device="cpu")
    merged = d.merge_occupied(_shard(maps["B", "prob"]))
    want = d.merge_occupied(maps["B", "prob"])
    assert type(merged) is DistanceVoxelMap and torch.equal(merged.data, want.data)
    a = maps["A", "distance"]
    assert same(a.differences(_shard(want)), a.differences(want))
    assert int(a.differences(_shard(want))) > 0


# -- F28: voxel lists against a sharded dense map ----------------------------------------
@pytest.mark.parametrize("call", ["collide_with", "collide_with_resolution", "collide_with_dense"])
@pytest.mark.parametrize("dense", ["prob", "bit"])
@pytest.mark.parametrize("lst", list(LISTS))
def test_f28_voxel_list_against_a_sharded_dense_map(maps, lst, dense, call):
    a, b = maps["A", lst], maps["B", dense]
    got = getattr(a, call)(_shard(b))
    assert same(got, getattr(a, call)(b))
    assert _count(got) == ORACLE


@pytest.mark.parametrize("dense", ["prob", "bit"])
@pytest.mark.parametrize("lst", list(LISTS))
def test_f28_offsets_and_cubes_that_slabs_cut(maps, lst, dense):
    """Offsets that move entries across slabs and out of the map, and
    2^level cubes of 2, 8 and 16 rows over 4-row slabs (a cube a slab
    boundary cuts is ORed from the slabs' partial cubes)."""
    a, b = maps["A", lst], maps["B", dense]
    sb = _shard(b)
    for off in ((1, -2, 5), (0, 0, -30), (2, 3, 29)):
        assert same(a.collide_with(sb, offset=off), a.collide_with(b, offset=off)), off
    for level in (1, 3, 4):
        for off in ((0, 0, 0), (1, 0, -3)):
            assert same(a.collide_with_resolution(sb, 1.0, level, off), a.collide_with_resolution(b, 1.0, level, off))


@pytest.mark.parametrize("dense", ["prob", "sv"])
def test_f28_type_mask_against_a_sharded_dense_map(maps, dense):
    a, b = maps["A", "bitlist"], maps["B", dense]
    types = np.zeros(8, np.uint32)
    types[0] = 1 << 2  # eBVM_OCCUPIED
    assert same(a.collide_with_type_mask(_shard(b), types), a.collide_with_type_mask(b, types))


# -- F29: the paged tiers against a sharded dense map ------------------------------------
@pytest.fixture(scope="module")
def paged():
    """The A cloud, and a few voxels outside the dense map's dims, in a
    paged map and in a ShardedPagedWorld over two CPU slabs."""
    far = np.random.default_rng(5).uniform([0, 0, 40], [60, 60, 120], (40, 3)).astype(np.float32)
    pts = np.concatenate([PTS_A, far])
    single = PagedHierarchicalMap(PAGED_DIMS, 1.0, device="cpu")
    single.insert_point_cloud(pts)
    world = ShardedPagedWorld(PAGED_DIMS, 1.0, devices=["cpu"] * 2)
    world.insert_point_cloud(pts)
    return {"paged": single, "world": world}


F29 = [("collide_with", {}), ("collide_with", {"min_level": 1}), ("collide_with", {"offset": (1, -2, 5)}),
       ("collide_with_counting_unknown", {})]
F29_CASES = ([("paged",) + c for c in F29 + [("collide_with_resolution", {"resolution_level": 2})]]
             + [("world",) + c for c in F29])  # the world has no collide_with_resolution, as the reference's


@pytest.mark.parametrize("dense", ["prob", "bit"])
@pytest.mark.parametrize("tier,call,kw", F29_CASES, ids=[f"{t}-{c}-{i}" for i, (t, c, _) in enumerate(F29_CASES)])
def test_f29_paged_tiers_against_a_sharded_dense_map(maps, paged, tier, dense, call, kw):
    b = maps["B", dense]
    got = getattr(paged[tier], call)(_shard(b), **kw)
    assert same(got, getattr(paged["paged"], call)(b, **kw))
    if kw == {}:
        assert _count(got) == ORACLE


# -- F30 / F31: extraction of sharded maps -------------------------------------------------
@pytest.mark.parametrize("max_cubes", [None, 50], ids=["all", "first-50"])
@pytest.mark.parametrize("kind", ["prob", "bit", "counting", "distance", "hierbit", "hierprob"])
def test_f30_extract_cubes_of_a_sharded_map(maps, kind, max_cubes):
    """Slabs compacted in z order give the single map's cubes in its order,
    so max_cubes keeps the same first cubes; a bit map's meanings are read
    per slab."""
    m = maps["A", kind]
    s = _shard(m)
    got = extract.occupied_coords(s, max_cubes=max_cubes)
    want = extract.occupied_coords(m, max_cubes=max_cubes)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if max_cubes is None:
        assert {tuple(v) for v in got} == _voxels(PTS_A)
    for g, w in zip(extract.extract_cubes(s, max_cubes=max_cubes), extract.extract_cubes(m, max_cubes=max_cubes)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["hierbit", "hierprob"])
def test_f31_multilevel_cubes_of_a_sharded_pyramid(maps, kind):
    m = maps["A", kind]
    for kw in ({}, {"min_level": 1, "free": False}, {"max_cubes": 40}):
        got = extract.extract_multilevel_cubes(_shard(m), **kw)
        want = extract.extract_multilevel_cubes(m, **kw)
        assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(got, want)), kw


@pytest.mark.parametrize("threshold", [0.1, 0.2, 0.5])
def test_f32_sharded_prob_pyramid_extraction_takes_the_threshold(threshold):
    """occupied_coords of a sharded HierarchicalProbMap applies the caller's
    threshold to the occupancy slabs, as the single map does (it read the
    status pyramid's fixed THRESHOLD_OCCUPANCY before); a DDA insert leaves
    log-odds between the thresholds."""
    m = HierarchicalProbMap.create(DIMS, 1.0, device="cpu").insert_point_cloud_with_free_space(
        torch.tensor(PTS_A), (8.0, 8.0, 20.0))
    want = extract.occupied_coords(m, threshold)
    assert len(want) > 0
    assert np.array_equal(extract.occupied_coords(_shard(m), threshold), want)
    for g, w in zip(extract.extract_cubes(_shard(m), threshold), extract.extract_cubes(m, threshold)):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["prob", "bit", "distance", "hierbit", "hierprob"])
def test_provider_draws_a_sharded_map_slab_by_slab(maps, kind, tmp_path):
    """VisProvider's snapshot of a sharded map (its cubes, and a distance
    map's slices along every axis) equals the single map's, without the
    whole-map gather it made before."""
    m = maps["A", kind]
    got = VisProvider("m", tmp_path).snapshot(_shard(m))
    want = VisProvider("m", tmp_path).snapshot(m)
    for key in ("cubes", "distance"):
        g, w = got[key], want[key]
        assert (g is None) == (w is None), key
        for a, b in zip(g or (), w or ()):
            assert np.array_equal(a, b), key
    if kind == "distance":
        for axis, index in (("x", 3), ("y", 15), ("z", 0), ("z", 31), ("z", 13)):
            for a, b in zip(extract.extract_distance_slice(_shard(m), axis, index),
                            extract.extract_distance_slice(m, axis, index)):
                assert a.dtype == b.dtype and np.array_equal(a, b), (axis, index)


def test_sv_meanings_of_a_sharded_bit_map(maps):
    """extract_cubes' meaning read-back per slab on a map whose voxels hold
    two meanings."""
    m = maps["A", "sv"].merge(maps["B", "sv"])
    got = extract.extract_cubes(_shard(m))
    want = extract.extract_cubes(m)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert set(np.unique(want[1])) == {SV_A, SV_B}


# -- the refusals the reference makes ------------------------------------------------------
@pytest.mark.parametrize("other", list(LISTS) + ["hierbit", "hierprob", "paged"])
@pytest.mark.parametrize("mine", ["prob", "bit"])
def test_type_errors_kept_with_one_message(maps, paged, mine, other):
    """Dense x list and dense x octree raise TypeError
    (tests/test_collision_matrix.py:40-44), naming the same classes whether
    either side is plain or sharded."""
    a = maps["A", mine]
    b = paged["paged"] if other == "paged" else maps["B", other]
    forms = [(a, b), (_shard(a), b)]
    if other in ("hierbit", "hierprob"):
        forms += [(a, _shard(b)), (_shard(a), _shard(b))]
    messages = set()
    for x, y in forms:
        for call in ("collide_with", "collide_with_resolution"):
            with pytest.raises(TypeError) as err:
                getattr(x, call)(y)
            messages.add((call, str(err.value)))
    assert len(messages) == 2, messages


def test_gather_is_patched_to_raise(maps):
    with pytest.raises(AssertionError, match="gathered whole"):
        _shard(maps["A", "prob"]).gather()
    with pytest.raises(AssertionError, match="gathered whole"):
        _shard(maps["A", "hierbit"]).gather()


# -- the reference's own sharded value -----------------------------------------------------
@pytest.fixture(scope="module")
def reference():
    """The reference's maps of the same clouds, the B side laid over its
    8-device virtual CPU mesh."""
    jmesh = jmake_grid_mesh(8)
    a, b = jnp.asarray(PTS_A), jnp.asarray(PTS_B)
    return {
        "jmesh": jmesh,
        "prob_a": JProb.create(DIMS, 1.0).insert_point_cloud(a),
        "sharded_prob_b": jshard_map_value(JProb.create(DIMS, 1.0).insert_point_cloud(b), jmesh),
        "sharded_bit_a": jshard_map_value(JBit.create(DIMS, 1.0).insert_point_cloud(a, SV_A), jmesh),
        "sharded_bit_b": jshard_map_value(JBit.create(DIMS, 1.0).insert_point_cloud(b), jmesh),
    }


@pytest.mark.parametrize("family", ["F26", "F27", "F28", "F29", "F30"])
def test_reference_sharded_value_agrees(maps, paged, reference, family):
    """One call per fault family against the reference's sharded value."""
    r = reference
    if family == "F26":
        want = int(JBitH.create(DIMS, 1.0).insert_point_cloud(jnp.asarray(PTS_A)).collide_with(r["sharded_prob_b"]))
        assert int(maps["A", "hierbit"].collide_with(_shard(maps["B", "prob"]))) == want == ORACLE
    elif family == "F27":
        j_cnt, j_marked = r["prob_a"].collide_with_marking(r["sharded_prob_b"], 1.0, (3, 1, -9))
        t_cnt, t_marked = maps["A", "prob"].collide_with_marking(_shard(maps["B", "prob"]), 1.0, (3, 1, -9))
        assert int(t_cnt) == int(j_cnt) > 0
        np.testing.assert_array_equal(t_marked.data.numpy(), np.asarray(j_marked.data))
    elif family == "F28":
        lst = JVoxelList.create(DIMS, 1.0, kind="bit", capacity=1024).insert_point_cloud(jnp.asarray(PTS_A))
        want = int(lst.collide_with_resolution(r["sharded_bit_b"], 1.0, 3))
        assert int(maps["A", "bitlist"].collide_with_resolution(_shard(maps["B", "bit"]), 1.0, 3)) == want > 0
    elif family == "F29":
        far = np.random.default_rng(5).uniform([0, 0, 40], [60, 60, 120], (40, 3)).astype(np.float32)
        jp = JPaged(PAGED_DIMS, 1.0)
        jp.insert_point_cloud(np.concatenate([PTS_A, far]))
        want = int(jp.collide_with(r["sharded_prob_b"]))
        assert int(paged["world"].collide_with(_shard(maps["B", "prob"]))) == want == ORACLE
    else:
        want = jextract.extract_cubes(r["sharded_bit_a"], max_cubes=50)
        got = extract.extract_cubes(_shard(maps["A", "sv"]), max_cubes=50)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
