"""Port conformance of the voxel lists (maps/voxellist.py, morton.py) and
the facade's list map types.

The same seeded numpy inputs go through gpu_voxels_tpu (JAX, the reference)
and gpu_voxels_tpu_torch on the CPU; every case of tests/test_voxellist.py
has a counterpart here. Lists are compared field for field through
`interop.to_numpy` (the reference's ids, ids_hi, payload and count over the
whole capacity), and counts, meanings and per-meaning counts exactly. The
reference compiles one program per shape and static argument, so the
fixtures reuse shapes and meanings where they can.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import bitops as jbit
from gpu_voxels_tpu.api import GpuVoxels as JGvl
from gpu_voxels_tpu.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu.geometry import generation
from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
from gpu_voxels_tpu.maps import voxellist as J
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
from gpu_voxels_tpu_torch.maps import voxellist as T
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


DIMS = (32, 32, 32)
BIG = (4096, 4096, 4096)
FACTORIES = {
    "bit": (J.bit_vector_voxel_list, T.bit_vector_voxel_list),
    "morton": (J.bit_vector_morton_voxel_list, T.bit_vector_morton_voxel_list),
    "prob": (J.prob_voxel_list, T.prob_voxel_list),
    "count": (J.counting_voxel_list, T.counting_voxel_list),
}


def pair(kind, dims=DIMS, capacity=0):
    """An empty reference list and an empty port list (on the CPU)."""
    jf, tf = FACTORIES[kind]
    return jf(dims, capacity=capacity), tf(dims, capacity=capacity, device="cpu")


def same(t, j):
    """Port list == reference list, field for field over the capacity."""
    lo, hi, payload, count = interop.to_numpy(t)
    assert count == int(j.count)
    np.testing.assert_array_equal(lo, np.asarray(j.ids))
    np.testing.assert_array_equal(hi, np.asarray(j.ids_hi))
    np.testing.assert_array_equal(payload, np.asarray(j.payload))
    assert (t.dims, t.side_length, t.kind, t.id_mode, int(t.map_type)) == (
        j.dims, j.side_length, j.kind, j.id_mode, int(j.map_type))
    assert t.keys.is_contiguous() and t.payload.is_contiguous()  # as K4 takes them


def both(lists, fn):
    """fn applied to the reference list and to the port list."""
    j, t = lists
    return fn(j), fn(t)


def jitted(fn):
    """A reference method that is not compiled as one program (merge,
    subtract, ...) runs op by op and compiles each op; one jit is faster."""
    return jax.jit(fn)


def insert(lists, pts, meaning=BitVoxelMeaning.eBVM_OCCUPIED, **kw):
    j, t = both(lists, lambda m: m.insert_point_cloud(pts, meaning, **kw))
    same(t, j)
    return j, t


def _u32(t):
    return t.numpy().view(np.uint32)


def box(lo, hi):
    return generation.create_box_of_points((lo,) * 3, (hi,) * 3, 1.0)


# -- inserts and dedup ------------------------------------------------------
def test_insert_dedup_and_sort():
    pts = np.array([[3.5, 1.5, 2.5], [3.5, 1.5, 2.5], [1.2, 1.2, 1.2], [5.9, 0.1, 0.1]], np.float32)
    j, t = insert(pair("bit"), pts, 50)
    assert int(t.count) == 3 and (np.diff(interop.to_numpy(t)[0][:3].astype(np.int64)) > 0).all()


def test_insert_merges_meanings_by_or():
    pts = np.array([[3.5, 1.5, 2.5]], np.float32)
    lists = insert(insert(pair("bit"), pts, 50), pts, 99)
    vox = lists[1].payload[:, 0]
    assert int(lists[1].count) == 1 and bool(T.bitops.get_bit(vox, 50)) and bool(T.bitops.get_bit(vox, 99))


def _seq_saturating_fold(values):
    """The reference's reversed inclusive_scan Merge: seeded at the run's
    last entry, a [-127, 127] clamp at every step backward."""
    acc = int(values[-1])
    for v in values[-2::-1]:
        acc = max(min(acc + int(v), 127), -127)
    return acc


@pytest.mark.parametrize("case", ["prob-occupied", "prob-saturation", "prob-lone-unknown", "count-wraps"])
def test_single_voxel_dedup_semantics(case):
    """One voxel's payload after inserts: a prob insert sets 127; an occupied
    voxel hit by two FREE points folds [127, -127, -127] sequentially to 0
    (sum-then-clamp gives -127); a lone UNKNOWN (-128) run is never reduced;
    200 counter hits wrap to -56 like the reference's int8 add."""
    pt = np.array([[2.5, 2.5, 2.5]], np.float32)
    if case == "count-wraps":
        lists, want = insert(pair("count"), np.repeat(pt, 200, axis=0)), -56
    elif case == "prob-lone-unknown":
        lists, want = insert(pair("prob"), pt, BitVoxelMeaning.eBVM_SWEPT_VOLUME_START), -128
    else:
        lists, want = insert(pair("prob"), pt, BitVoxelMeaning.eBVM_OCCUPIED), 127
        if case == "prob-saturation":
            lists = insert(lists, np.repeat(pt, 2, axis=0), BitVoxelMeaning.eBVM_FREE)
            want = _seq_saturating_fold([127, -127, -127])
    assert int(lists[1].count) == 1 and int(lists[1].payload[0]) == want


def test_counting_list_noise_filter():
    pts = np.concatenate([np.repeat(np.array([[2.5, 2.5, 2.5]], np.float32), 5, axis=0),
                          np.array([[9.5, 9.5, 9.5]], np.float32)])
    lists = insert(pair("count"), pts)
    j, t = jitted(lambda m: m.remove_underpopulated(3))(lists[0]), lists[1].remove_underpopulated(3)
    same(t, j)
    assert int(t.count) == 1 and t.coords_from_ids(t.keys[:1]).tolist() == [[2, 2, 2]]


def test_prob_dedup_random_vs_sequential_oracle():
    """_make_unique on 257 entries over 23 ids (an odd length: no
    power-of-two structure), against the reference and a sequential fold."""
    rng = np.random.default_rng(7)
    n, n_ids = 257, 23
    ids = rng.integers(0, n_ids, size=n).astype(np.uint32)
    vals = rng.integers(-128, 128, size=n).astype(np.int8)
    jl, tl = pair("prob")
    u_hi, u_lo, u_payload, count = jax.jit(jl._make_unique)(jnp.zeros((n,), jnp.uint32), jnp.asarray(ids),
                                                              jnp.asarray(vals))
    keys, payload, t_count = tl._make_unique(torch.tensor(ids.astype(np.int64)), torch.tensor(vals))
    assert int(t_count) == int(count)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(u_lo).astype(np.int64))
    np.testing.assert_array_equal(payload.numpy(), np.asarray(u_payload))
    want = {int(u): _seq_saturating_fold(vals[ids == u]) for u in np.unique(ids)}
    assert {int(k): int(v) for k, v in zip(keys[: int(t_count)], payload)} == want


def _runs(rng, n_runs, max_len):
    lengths = rng.integers(1, max_len + 1, n_runs)
    starts = np.zeros(lengths.sum(), bool)
    starts[np.concatenate([[0], np.cumsum(lengths)[:-1]])] = True
    return lengths, torch.tensor(starts)


def test_segmented_folds_match_sequential_oracles():
    """The three folds of make_unique on runs of 1..40 entries, against
    numpy loops: the prob fold on values near the clamps (every run crosses
    one), the counter sum past the int8 wrap, the OR of random words."""
    rng = np.random.default_rng(11)
    lengths, starts = _runs(rng, 300, 40)
    n = int(lengths.sum())
    is_last = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool)])
    ends = np.cumsum(lengths) - 1
    bounds = np.concatenate([[0], np.cumsum(lengths)])
    vals = rng.choice(np.array([-128, -127, -100, -60, 60, 100, 127], np.int8), n)
    prob = T.sequential_saturating_fold(starts, is_last, torch.tensor(vals)).numpy()
    counts = rng.integers(-128, 128, n).astype(np.int8)
    wrapped = T.segmented_wrapping_sum(starts, torch.tensor(counts)).numpy()
    words = rng.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
    ored = _u32(T.segmented_or(starts, torch.tensor(words.view(np.int32))))
    for r, end in enumerate(ends):
        run = slice(bounds[r], bounds[r + 1])
        assert int(prob[end]) == _seq_saturating_fold(vals[run]), r
        assert int(wrapped[end]) == (int(counts[run].astype(np.int64).sum()) + 128) % 256 - 128, r
        np.testing.assert_array_equal(ored[:, end], np.bitwise_or.reduce(words[:, run], axis=1))
    crossed = sum(abs(int(vals[bounds[r]:bounds[r + 1]].astype(np.int64).sum())) > 127 for r in range(len(ends)))
    assert crossed > 50  # the fixture really crosses the clamp


def test_compaction_destinations_are_unique():
    """H7: the compaction scatters each kept entry to its rank among the kept
    ones, so the kept destinations are distinct and no scatter has to pick a
    winner; everything else goes to the dropped slot C."""
    rng = np.random.default_rng(3)
    for c in (1, 2, 17, 300):
        keep = torch.tensor(rng.random(c) < 0.6)
        dest = T.compaction_destinations(keep).numpy()
        kept = dest[keep.numpy()]
        assert (np.diff(kept) == 1).all() and (kept[:1] == 0).all() and len(set(kept)) == len(kept)
        assert (dest[~keep.numpy()] == c).all()


def test_wrapped_id_equal_to_empty_is_dropped_and_empty_sorts_last():
    """A point at x = -1 wraps to linear id 0xFFFFFFFF, the EMPTY id: the
    reference treats that entry as empty and drops it, and so does the port.
    A morton list's padding sorts after every code (hi, lo near 2^30)."""
    pts = np.array([[-0.5, 0.5, 0.5], [1.5, 0.5, 0.5], [31.5, 31.5, 31.5], [40.5, 0.5, 0.5]], np.float32)
    j, t = insert(pair("bit", capacity=8), pts, 50, grow=False)
    assert int(t.count) == 3 and t.keys[:4].tolist() == [1, 40, 32767, T.EMPTY_ID]
    corner = np.array([[(1 << 20) - 0.5] * 3, [0.5, 0.5, 0.5]], np.float32)
    j, t = insert(pair("morton", dims=BIG, capacity=4), corner, 50, grow=False)
    assert int(t.count) == 2 and int(t.keys[1]) == (1 << 60) - 1 and int(t.keys[2]) == T.EMPTY_MORTON


def test_insert_with_per_point_meanings_matches_sequential():
    """The fused per-point-meaning insert equals the reference's fused
    insert, and the port's per-meaning loop, OR-merges included."""
    rng = np.random.default_rng(4)
    pts = (rng.uniform(0, 8, (64, 3)).astype(np.float32) // 1) + 0.5  # many duplicates
    meanings = rng.integers(10, 140, 64).astype(np.int32)
    j, t = both(pair("bit"), lambda m: m.insert_point_cloud_with_meanings(pts, meanings))
    same(t, j)
    oracle = pair("bit")[1]
    for m in np.unique(meanings):
        oracle = oracle.insert_point_cloud(pts[meanings == m], int(m))
    n = int(t.count)
    assert n == int(oracle.count)
    assert torch.equal(t.keys[:n], oracle.keys[:n]) and torch.equal(t.payload[:, :n], oracle.payload[:, :n])
    with pytest.raises(TypeError):
        pair("count")[1].insert_point_cloud_with_meanings(pts, meanings)
    # meta clouds with a meaning per sub-cloud: one fused pass for bits
    clouds = [pts[:3], pts[3:6]]
    jl, tl = pair("bit")
    same(tl.insert_meta_point_cloud(TMeta.from_clouds(clouds, device="cpu"), [60, 61]),
         jl.insert_meta_point_cloud(JMeta.from_clouds(clouds), [60, 61]))


def test_insert_fixed_capacity_steady_state():
    lists = pair("bit", capacity=4)
    a = insert(lists, np.array([[1.5, 0.5, 0.5], [2.5, 0.5, 0.5]], np.float32), grow=False)
    b = insert(a, np.array([[2.5, 0.5, 0.5], [3.5, 0.5, 0.5]], np.float32), grow=False)
    assert b[1].capacity == 4 and int(b[1].count) == 3
    c = insert(b, np.array([[5.5, 0.5, 0.5], [6.5, 0.5, 0.5], [7.5, 0.5, 0.5], [0.5, 0.5, 0.5]], np.float32),
               grow=False)
    assert int(c[1].count) == 4 and c[1].keys.tolist() == [0, 1, 2, 3]
    pt = np.array([[1.5, 0.5, 0.5]], np.float32)
    d = insert(insert(pair("bit", capacity=2), pt, 50, grow=False), pt, 60, grow=False)
    assert int(d[1].count) == 1


# -- collides --------------------------------------------------------------------
def test_collide_lists():
    a = insert(pair("bit"), box(1.1, 5.1), 50)
    b = insert(pair("bit"), box(3.1, 7.1), 60)
    assert _vs(a, b, lambda x, y: x.collide_with(y)) == 27
    (jc, jm), (tc, tm) = a[0].collide_with_types(b[0]), a[1].collide_with_types(b[1])
    assert int(tc) == int(jc) == 27
    np.testing.assert_array_equal(_u32(tm), np.asarray(jm))
    assert bool(T.bitops.get_bit(tm, 50)) and bool(T.bitops.get_bit(tm, 60)) and not bool(T.bitops.get_bit(tm, 70))


def _vs(a, b, fn):
    """fn(a, b) on both sides; the number, equal."""
    got, want = fn(a[1], b[1]), fn(a[0], b[0])
    assert int(got) == int(want)
    return int(got)


@pytest.mark.parametrize("margin, sv_offset, want", [(2, 0, 1), (1, 0, 0), (0, 0, 0), (25, 0, 1), (2, 3, None),
                                                     (31, 0, 1)])
def test_collide_with_bitcheck_window(margin, sv_offset, want):
    """Meanings 50 and 52 in one voxel: a window of 2 matches, 1 does not.
    Margins past 24 and sv_offsets take the full-domain form; there the
    reference's byte-level oracle of BitVector.h (numpy, one voxel pair at a
    time) stands in for its compiled check, whose program is slow to build."""
    pts = np.array([[2.5, 2.5, 2.5], [3.5, 2.5, 2.5]], np.float32)
    a = insert(pair("bit"), pts, 50)
    b = insert(pair("bit"), pts[:1], 52)
    got = int(a[1].collide_with_bitcheck(b[1], margin=margin, sv_offset=sv_offset))
    if sv_offset == 0 and margin <= 24:
        assert got == int(a[0].collide_with_bitcheck(b[0], margin=margin, sv_offset=sv_offset))
    else:
        mask, theirs = a[0].find_matching(b[0])
        mine, theirs = np.asarray(a[0].payload), np.asarray(theirs)
        oracle = 0
        for i in np.flatnonzero(np.asarray(mask)):
            pair_bytes = [np.ascontiguousarray(x[:, i]).view(np.uint8) for x in (mine, theirs)]
            hit, _ = jbit.bit_margin_collision_check_np(*pair_bytes, np.zeros(32, np.uint8), margin, sv_offset)
            oracle += bool(hit)
        assert got == oracle
    assert want is None or got == want


def test_collide_counting_per_meaning():
    pts = np.array([[2.5, 2.5, 2.5], [3.5, 3.5, 3.5]], np.float32)
    a = insert(pair("bit"), pts, 50)
    b = insert(insert(pair("bit"), pts, 50), pts[:1], 60)
    got, want = a[1].collide_counting_per_meaning(b[1]), a[0].collide_counting_per_meaning(b[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[50]) == 2 and int(got[60]) == 0 and int(got.sum()) == 2


def _dense(pts, half):
    """Reference and port prob maps of the first half of pts, bit maps of
    all of them (with and without the occupancy summary)."""
    jp = JProb.create(DIMS).insert_point_cloud(pts[:half])
    jb = JBit.create(DIMS).insert_point_cloud(pts, 60)
    tp = TProb.create(DIMS, device="cpu").insert_point_cloud(pts[:half])
    tb = TBit.create(DIMS, device="cpu").insert_point_cloud(pts, 60)
    return (jp, tp), (jb, tb), (JBit(jb.data, jb.dims, jb.side_length, occ=None), TBit(tb.data, tb.dims, tb.side_length))


def test_collide_with_dense_maps():
    """List x dense: a prob map, a bit map with its occupancy summary and
    one without (F10), through collide_with_dense and collide_with_type_mask,
    at an offset too."""
    pts = box(1.1, 4.1)
    lst = insert(pair("bit"), pts, 50)
    prob, bit, raw = _dense(pts, len(pts) // 2)
    assert _vs(lst, prob, lambda x, m: x.collide_with_dense(m, 0.5)) == len(
        set(map(tuple, np.floor(pts[: len(pts) // 2]).astype(int))))
    for m in (bit, raw):
        assert _vs(lst, m, lambda x, d: x.collide_with_dense(d)) == int(lst[1].count)
    assert 0 < _vs(lst, raw, lambda x, d: x.collide_with_dense(d, offset=(1, 0, -1))) < int(lst[1].count)
    types = np.zeros(8, np.uint32)
    types[50 >> 5] |= np.uint32(1 << (50 & 31))
    for m in (prob, bit):  # the raw-plane fold is shared with collide_with_dense
        assert _vs(lst, m, lambda x, d: x.collide_with_type_mask(d, types, 0.5)) > 0
    assert 0 < _vs(lst, bit, lambda x, d: x.collide_with_type_mask(d, types, 0.5, offset=(2, 1, 0))) < int(
        lst[1].count)
    assert _vs(lst, bit, lambda x, d: x.collide_with_type_mask(d, np.zeros(8, np.uint32))) == 0


def test_cross_id_mode_collide_and_guards():
    lin = insert(pair("bit"), box(1.1, 5.1), 50)
    mor = insert(pair("morton"), box(3.1, 7.1), 50)
    assert _vs(lin, mor, lambda x, y: x.collide_with(y)) == 27
    assert _vs(mor, lin, lambda x, y: x.collide_with(y)) == 27
    assert _vs(lin, mor, lambda x, y: x.collide_with(y, offset=(2, 0, 0))) == 45
    dense = (JBit.create(DIMS).insert_point_cloud(box(3.1, 7.1), 60),
             TBit.create(DIMS, device="cpu").insert_point_cloud(box(3.1, 7.1), 60))
    assert _vs(lin, dense, lambda x, y: x.collide_with(y)) == 27
    assert _vs(mor, dense, lambda x, y: x.collide_with(y)) == 125
    for op in ("merge", "subtract", "equals", "find_matching", "collide_with_types"):
        with pytest.raises(TypeError):
            getattr(lin[1], op)(mor[1])
    # coordinates outside the target domain do not alias: morton (36, 0, 0)
    # would wrap onto linear id 36 == (4, 1, 0) of a 32-wide grid, and a
    # negative coordinate after an offset would scramble the morton spread
    lin1 = insert(pair("bit"), np.array([[4.5, 1.5, 0.5]], np.float32), 50)
    mor_out = insert(pair("morton"), np.array([[36.5, 0.5, 0.5]], np.float32), 50)
    assert _vs(mor_out, lin1, lambda x, y: x.collide_with(y)) == 0
    mor1 = insert(pair("morton"), np.array([[0.5, 0.5, 0.5]], np.float32), 50)
    assert _vs(lin1, mor1, lambda x, y: x.collide_with(y, offset=(-8, -8, -8))) == 0


def test_list_octree_collide_raises():
    """Named when list x octree raised; since the octree tiers are ported it
    forwards to the octree's probe at the list's coords + offset, and a map
    of no known kind raises TypeError."""
    from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap

    lst = insert(pair("bit"), np.array([[4.5, 1.5, 0.5], [5.5, 1.5, 0.5]], np.float32))[1]
    octree = HierarchicalBitMap.create(lst.dims, lst.side_length, device="cpu").insert_point_cloud(
        np.array([[5.5, 1.5, 0.5]], np.float32) * lst.side_length)
    assert int(lst.collide_with(octree)) == int(octree.collide_with(lst)) == 1
    assert int(lst.collide_with(octree, offset=(1, 0, 0))) == 1 and int(lst.collide_with(octree, offset=(2, 0, 0))) == 0
    with pytest.raises(TypeError):
        lst.collide_with(object())


def test_collide_with_resolution_lists():
    a = insert(pair("bit"), np.array([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5]], np.float32))
    b = insert(pair("bit"), np.array([[1.5, 1.5, 1.5], [8.5, 8.5, 8.5]], np.float32))
    c = insert(pair("bit"), np.array([[1.5, 0.5, 0.5], [9.5, 9.5, 9.5]], np.float32))
    jm = JProb.create(DIMS).insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    tm = TProb.create(DIMS, device="cpu").insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    for lvl, want in ((0, 0), (1, 1)):
        assert _vs(a, b, lambda x, y: x.collide_with_resolution(y, resolution_level=lvl)) == want
        assert _vs(a, (jm, tm), lambda x, y: x.collide_with_resolution(y, resolution_level=lvl)) == want
    assert _vs(a, b, lambda x, y: x.collide_with_resolution(y, resolution_level=1, offset=(-1, -1, 0))) == 1
    assert _vs(a, c, lambda x, y: x.collide_with_resolution(y)) == int(a[1].collide_with(c[1]))
    am = insert(pair("morton", dims=BIG), np.array([[2000.5, 1500.5, 1030.5]], np.float32))
    bm = insert(pair("morton", dims=BIG), np.array([[2001.5, 1501.5, 1031.5]], np.float32))
    assert _vs(am, bm, lambda x, y: x.collide_with_resolution(y, resolution_level=0)) == 0
    assert _vs(am, bm, lambda x, y: x.collide_with_resolution(y, resolution_level=1)) == 1


# -- set operations and maintenance ------------------------------------------------
def test_subtract_and_merge_and_equals():
    a = insert(pair("bit"), box(1.1, 5.1), 50)
    b = insert(pair("bit"), box(3.1, 7.1), 50)
    j, t = jitted(lambda x, y: x.subtract(y))(a[0], b[0]), a[1].subtract(b[1])
    same(t, j)
    assert int(t.count) == int(a[1].count) - 27 and int(t.collide_with(b[1])) == 0
    j, t = jitted(lambda x, y: x.merge(y))(a[0], b[0]), a[1].merge(b[1])
    same(t, j)
    assert int(t.count) == int(a[1].count) + int(b[1].count) - 27
    assert bool(a[1].equals(a[1])) and not bool(a[1].with_capacity(t.capacity).equals(t))
    assert not bool(jitted(lambda x, y: x.with_capacity(y.capacity).equals(y))(a[0], j))


def test_merge_with_offset_and_new_meaning():
    a = insert(pair("bit"), np.array([[1.5, 1.5, 1.5]], np.float32), 50)
    b = insert(pair("bit"), np.array([[1.5, 1.5, 1.5], [4.5, 4.5, 4.5]], np.float32), 60)
    ref_merge = jax.jit(lambda x, y, offset, new_meaning: x.merge(y, offset, new_meaning), static_argnums=(2, 3))
    for kw in (dict(offset=(2, 0, -1)), dict(offset=(-2, 0, 0), new_meaning=70)):
        same(a[1].merge(b[1], **kw), ref_merge(a[0], b[0], kw["offset"], kw.get("new_meaning")))
    # the metric overload: floor(metric / side_length) voxels per axis
    same(a[1].merge(b[1], metric_offset=(2.3, 0.0, -0.5)), ref_merge(a[0], b[0], (2, 0, -1), None))
    coords = {tuple(c) for c in a[1].merge(b[1], offset=(2, 0, -1)).entry_coords()[:3].tolist()}
    assert coords == {(1, 1, 1), (3, 1, 0), (6, 4, 3)}
    # log-odds merge with the sequential saturating fold
    p = insert(pair("prob"), box(1.1, 3.1))
    q = insert(pair("prob"), box(2.1, 4.1), BitVoxelMeaning.eBVM_FREE)
    same(p[1].merge(q[1], offset=(1, 0, 0)), jitted(lambda x, y: x.merge(y, offset=(1, 0, 0)))(p[0], q[0]))
    with pytest.raises(TypeError):
        p[1].merge(q[1], new_meaning=5)


def test_shift_left_swept_volume_ids_on_list():
    j, t = insert(pair("bit"), np.array([[2.5, 2.5, 2.5]], np.float32), 54)
    same(t.shift_left_swept_volume_ids(4), j.shift_left_swept_volume_ids(4))
    assert bool(T.bitops.get_bit(t.shift_left_swept_volume_ids(4).payload[:, 0], 50))


def test_clear_and_capacity():
    j, t = insert(pair("bit"), box(1.1, 3.1), 50)
    for fn in (lambda m: m.clear_map(), lambda m: m.with_capacity(100), lambda m: m.with_capacity(5),
               lambda m: m.shrink_to_fit()):
        same(fn(t), fn(j))
    assert int(t.with_capacity(5).count) == 5 and t.shrink_to_fit().capacity == 27
    assert t.screendump(8) == j.screendump(8)


def test_resize_and_clear_voxel_meaning():
    pts = np.array([[1.5, 1.5, 1.5], [2.5, 2.5, 2.5]], np.float32)
    lists = insert(insert(pair("bit", dims=(8, 8, 8)), pts, 9), pts[:1], 10)
    fn = lambda m: m.resize(64).resize(2).clear_voxel_meaning(9)  # noqa: E731
    j, t = jitted(fn)(lists[0]), fn(lists[1])
    same(t, j)
    assert int(t.count) == 1 and t.entry_coords()[:1].tolist() == [[1, 1, 1]]


def test_memory_usage_contract():
    j, t = pair("bit", capacity=64)
    assert t.memory_usage() == j.memory_usage() == 64 * (4 + 4 + 32)
    assert TBit.create((8, 8, 8), device="cpu").memory_usage() == 512 * 33
    assert TProb.create((8, 8, 8), device="cpu").memory_usage() == 512


def test_list_robot_configuration_and_rebuild_contract():
    link = np.array([[1.5, 1.5, 1.5]], np.float32)
    for kind, dims, base in (("bit", (8, 8, 8), link), ("morton", BIG, link + 2999.0)):
        for clouds, ok in (([base, base + 2.0], True), ([base, base], False)):
            jl, tl = pair(kind, dims=dims)
            jn, jok = jitted(lambda m, meta: m.insert_robot_configuration(meta, True))(jl, JMeta.from_clouds(clouds))
            tn, tok = tl.insert_robot_configuration(TMeta.from_clouds(clouds, device="cpu"), True)
            same(tn, jn)
            assert bool(tok) == bool(jok) == ok
    t = pair("bit")[1]
    assert not t.needs_rebuild() and t.rebuild() is t


# -- morton lists (past coordinate 1,024 and past 2^32 voxels: tests/test_torch_io.py)
def test_morton_list_roundtrip_and_collide():
    pts = box(1.1, 3.1)
    a = insert(pair("morton"), pts, 50)
    assert {tuple(c) for c in a[1].entry_coords()[:27].tolist()} == {
        (x, y, z) for x in (1, 2, 3) for y in (1, 2, 3) for z in (1, 2, 3)}
    b = insert(pair("morton"), pts[:5], 60)
    assert _vs(a, b, lambda x, y: x.collide_with(y)) == 5
    jp, tp = JProb.create(DIMS).insert_point_cloud(pts), TProb.create(DIMS, device="cpu").insert_point_cloud(pts)
    assert _vs(a, (jp, tp), lambda x, m: x.collide_with_dense(m, 0.5)) == 27


# -- the facade -----------------------------------------------------------------
LIST_TYPES = [MapType.MT_BITVECTOR_VOXELLIST, MapType.MT_BITVECTOR_MORTON_VOXELLIST, MapType.MT_PROBAB_VOXELLIST,
              MapType.MT_PROBAB_MORTON_VOXELLIST, MapType.MT_COUNTING_VOXELLIST]


def test_facade_builds_and_fills_every_list_type():
    """add_map builds each list type; the facade's point, box and robot
    inserts, update_map and clear_map work on it. The bit list is held
    against the reference facade, every type against the same calls on a
    list made directly."""
    from gpu_voxels_tpu_torch.robot.dh import DHParameters as TDH
    from gpu_voxels_tpu.robot.dh import DHParameters as JDH

    link = [[0.6, 0.3, 0.2], [0.9, 0.3, 0.2]]
    j, t = JGvl(), TGvl()
    j.initialize(16, 16, 16, 0.5)
    t.initialize(16, 16, 16, 0.5, device="cpu")
    j.add_robot_dh("arm", ["l1"], [JDH(0.1, 0.0, 0.5, 0.0)], JMeta.from_clouds([link], names=("l1",)))
    t.add_robot_dh("arm", ["l1"], [TDH(0.1, 0.0, 0.5, 0.0)], TMeta.from_clouds([link], names=("l1",), device="cpu"))
    pts = np.array([[1.3, 2.1, 0.7], [1.3, 2.1, 0.7], [6.6, 0.2, 4.4]], np.float32)
    boxed = generation.create_box_of_points((0.2, 0.2, 0.2), (1.1, 1.1, 1.1), 0.5)
    for mt in LIST_TYPES:
        name = mt.name
        gvls = (j, t) if mt == MapType.MT_BITVECTOR_VOXELLIST else (t,)
        for g in gvls:
            g.add_map(mt, name)
            g.insert_point_cloud_into_map(pts, name, BitVoxelMeaning.eBVM_OCCUPIED)
            g.insert_box_into_map((0.2, 0.2, 0.2), (1.1, 1.1, 1.1), name, BitVoxelMeaning.eBVM_OCCUPIED, 1)
            g.insert_robot_into_map("arm", name, BitVoxelMeaning.eBVM_OCCUPIED)
        lst = t.get_map(name)
        assert isinstance(lst, T.VoxelList) and lst.map_type == mt and lst.device.type == "cpu"
        arm = t.get_robot("arm").get_transformed_clouds().points
        direct = T.VoxelList.create((16,) * 3, 0.5, lst.kind, 0, lst.id_mode, device="cpu")
        for cloud in (pts, boxed, arm):
            direct = direct.insert_point_cloud(cloud)
        assert torch.equal(lst.keys, direct.keys) and torch.equal(lst.payload, direct.payload)
        assert int(lst.count) == int(direct.count) > 3
        if mt == MapType.MT_BITVECTOR_VOXELLIST:
            same(lst, j.get_map(name))
        t.update_map(name, lambda m: m.remove_underpopulated(2) if m.kind == "count" else m)
        t.clear_map(name)
        assert int(t.get_map(name).count) == 0
    octree = t.add_map(MapType.MT_BITVECTOR_OCTREE, "octree")  # since items 10b and 11
    assert type(octree).__name__ == "HierarchicalBitMap" and octree.device.type == "cpu"
