"""Port conformance: the bit x bit plane-fold count (kernel K7's spec), bit
maps without an occupancy summary (`occ=None`) and `collide_with_resolution`.

The same numpy planes and points go through gpu_voxels_tpu (JAX, the
reference) and gpu_voxels_tpu_torch; counts, planes and summaries must be
equal. The reference's Pallas `count_bit_bit` runs in interpret mode, as
tests/test_collide_pallas.py runs it. K7 itself is checked on a card by
tests/test_torch_cuda.py; on CPU tensors its wrapper takes the plain version.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import bitops as jbit
from gpu_voxels_tpu.constants import BitVoxelMeaning, float_to_probability
from gpu_voxels_tpu.geometry import generation as jgen
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import collide as jcol
from gpu_voxels_tpu.ops import collide_pallas as jcp
from gpu_voxels_tpu.robot import swept_volume as jsv
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import collide as tcol
from gpu_voxels_tpu_torch.ops import collide_cuda
from gpu_voxels_tpu_torch.robot import swept_volume as tsv
from gpu_voxels_tpu_torch.utils import kernels


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


OFFSETS = [(0, 0, 0), (1, -2, 3), (-1, 0, -1)]


def _t(w: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(w).view(np.int32))


def _planes(seed: int, n: int, kind: str) -> np.ndarray:
    """uint32[8, n]: `dense` words (bit 31 included) zeroed per voxel with
    p = 0.7; `low` the two lowest bits of every word at random
    (tests/test_collide_pallas.py:27), where bit 0 of plane 0 alone must
    not count; `top` only bit 31 of plane 7 in some voxels."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
    if kind == "dense":
        return w * (rng.random(n) < 0.3).astype(np.uint32)
    if kind == "low":
        return w & rng.integers(0, 4, (8, n), dtype=np.uint64).astype(np.uint32)
    out = np.zeros((8, n), np.uint32)
    out[7, rng.random(n) < 0.4] = np.uint32(1 << 31)
    out[0, rng.random(n) < 0.4] |= np.uint32(1)  # eBVM_FREE only: not occupied
    return out


@pytest.mark.parametrize("kind", ["dense", "low", "top"])
@pytest.mark.parametrize("dims", [(16, 16, 16), (32, 32, 32), (17, 9, 11)])
def test_count_bit_bit_matches_reference_over_offsets(dims, kind):
    """The plain K7 (and its wrapper on CPU tensors) against the reference's
    XLA form over offsets, incl. one that leaves a single z layer."""
    n = dims[0] * dims[1] * dims[2]
    a, b = _planes(1, n, kind), _planes(2, n, kind)
    counts = []
    for off in OFFSETS + [(0, 0, dims[2] - 1), (0, 0, 1 - dims[2])]:
        ref = int(jcol.count_bit_bit(jnp.asarray(a), jnp.asarray(b), dims, off))
        got = tcol.count_bit_bit(_t(a), _t(b), dims, off)
        assert got.dtype == torch.int64 and int(got) == ref, off
        assert int(collide_cuda.count_bit_bit(_t(a), _t(b), dims, off)) == ref, off
        counts.append(ref)
    assert counts[0] > counts[-1] > 0
    assert collide_cuda.count_bit_bit_plain is tcol.count_bit_bit
    assert kernels.launches["gv_count_bit_bit"] == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("kind", ["dense", "low", "top"])
def test_count_bit_bit_matches_the_pallas_kernel(kind):
    """The TPU kernel K7 replaces, in interpret mode, on a size that is not
    tile aligned (tests/test_collide_pallas.py:24-30): no offset there."""
    n = 20_003
    a, b = _planes(3, n, kind), _planes(4, n, kind)
    ref = int(jcp.count_bit_bit(jnp.asarray(a), jnp.asarray(b)))
    assert int(tcol.count_bit_bit(_t(a), _t(b))) == ref
    # by hand: the fold with plane 0's bit 0 masked, non-zero on both sides
    fold = [np.bitwise_or.reduce(np.concatenate([w[:1] & np.uint32(0xFFFFFFFE), w[1:]]), axis=0) for w in (a, b)]
    assert ref == int(((fold[0] != 0) & (fold[1] != 0)).sum())


def _assert_same_state(tm, jm, where=""):
    planes, occ = interop.to_numpy(tm)
    np.testing.assert_array_equal(planes, np.asarray(jm.data), err_msg=where)
    assert (occ is None) == (jm.occ is None), where
    if occ is not None:
        np.testing.assert_array_equal(occ, np.asarray(jm.occ), err_msg=where)


def test_occupancy_summary_none_fallback():
    """tests/test_voxelmap.py:279 through both packages: hand-constructed
    maps (occ=None) work through the fold and propagate None."""
    dims = (8, 8, 8)
    planes = np.random.default_rng(3).integers(0, 2**32, (8, 512), dtype=np.uint64).astype(np.uint32)
    jraw = JBit(jnp.asarray(planes), dims, 1.0)
    traw = TBit(_t(planes), dims, 1.0)
    assert traw.occ is None and jraw.occ is None
    expect = int(np.asarray(jbit.occupied(jnp.asarray(planes))).sum())
    assert int(traw.collide_with(traw)) == int(jraw.collide_with(jraw)) == expect
    assert traw.clear_bit(3).occ is None
    _assert_same_state(traw.clear_bit(3), jraw.clear_bit(3))
    wrapped = TBit.from_planes(_t(planes), dims, 1.0)
    np.testing.assert_array_equal(wrapped.occ.numpy(), np.asarray(JBit.from_planes(jnp.asarray(planes), dims).occ))
    assert int(wrapped.collide_with(wrapped)) == expect
    assert traw.memory_usage() == jraw.memory_usage() == 8 * 512 * 4
    with pytest.raises(TypeError):
        TBit.from_planes(torch.zeros((8, 512), dtype=torch.int64), dims)


class _TableFK:
    """FK as a table of points per step, the same for both packages."""

    def __init__(self, table, pkg):
        self.table = jnp.asarray(table) if pkg == "jax" else torch.tensor(table)
        self.pkg = pkg

    def transformed_clouds_for(self, cfg):
        step = cfg[..., 0].astype(jnp.int32) if self.pkg == "jax" else cfg[..., 0].long()
        points = self.table[step]

        class _Clouds:
            pass

        out = _Clouds()
        out.points = points
        return out


@pytest.mark.parametrize("with_occ", [True, False], ids=["summary", "raw-planes"])
def test_every_bit_map_method_with_and_without_summary(with_occ):
    """The reference's BitVectorVoxelMap and the port's, built from the same
    planes with or without a summary, go through every method the reference
    supports for occ=None; planes, summaries (or None) and counts stay equal."""
    dims, side = (16, 16, 16), 1.0
    rng = np.random.default_rng(9)
    pts_a, pts_b = (rng.uniform(0, 16, (200, 3)).astype(np.float32) for _ in range(2))
    # keep the points off cell boundaries: both packages voxelize alike
    pts_a, pts_b = (np.floor(p) + 0.25 + 0.5 * (p - np.floor(p)) for p in (pts_a, pts_b))
    seed_planes = np.asarray(JBit.create(dims, side).insert_point_cloud(pts_a, 9).data)

    def both(planes):
        jm = JBit.from_planes(jnp.asarray(planes), dims, side) if with_occ else JBit(jnp.asarray(planes), dims, side)
        tm = interop.bit_map_from_numpy(planes, None if jm.occ is None else np.asarray(jm.occ), dims, side, "cpu")
        return jm, tm

    jm, tm = both(seed_planes)
    assert (tm.occ is None) == (not with_occ)
    jo, to = both(np.asarray(JBit.create(dims, side).insert_point_cloud(pts_b, 7).data))

    class _Meta:  # the three attributes insert_meta_point_cloud reads
        def __init__(self, pkg):
            halves = [pts_b[:60], pts_b[60:150]]
            self.points = jnp.asarray(np.concatenate(halves)) if pkg == "jax" else torch.tensor(np.concatenate(halves))
            self.num_clouds = 2
            self._halves = halves

        def get_cloud(self, i):
            return self._halves[i]

        def cloud_size(self, i):
            return len(self._halves[i])

    table = np.stack([pts_a[:20] * 0.5 + k * 0.3 for k in range(6)]).astype(np.float32)
    table = np.floor(table) + 0.25 + 0.5 * (table - np.floor(table))
    steps = np.arange(6, dtype=np.float32)[:, None]
    ops = [
        ("insert_point_cloud", lambda m, pkg: m.insert_point_cloud(pts_b, 35)),
        ("insert eBVM_FREE", lambda m, pkg: m.insert_point_cloud(pts_b[:50], BitVoxelMeaning.eBVM_FREE)),
        ("insert_meta_point_cloud", lambda m, pkg: m.insert_meta_point_cloud(_Meta(pkg), [40, 0])),
        ("shift_left_swept_volume_ids", lambda m, pkg: m.shift_left_swept_volume_ids(4)),
        ("clear_bit", lambda m, pkg: m.clear_bit(35)),
        ("clear_bits", lambda m, pkg: m.clear_bits([13, 39])),
        ("merge", lambda m, pkg: m.merge(jo if pkg == "jax" else to)),
        ("merge new_meaning", lambda m, pkg: m.merge(jo if pkg == "jax" else to, new_meaning=9)),
        ("merge eBVM_FREE", lambda m, pkg: m.merge(jo if pkg == "jax" else to, new_meaning=BitVoxelMeaning.eBVM_FREE)),
        ("collide_with_types", lambda m, pkg: m.collide_with_types(jo if pkg == "jax" else to)[2]),
        ("insert_swept_volume_batched", lambda m, pkg: (jsv if pkg == "jax" else tsv).insert_swept_volume_batched(
            m, _TableFK(table, pkg), steps)),
        ("insert_swept_volume", lambda m, pkg: (jsv if pkg == "jax" else tsv).insert_swept_volume(
            m, _TableFK(table, pkg), [jnp.asarray(s) if pkg == "jax" else torch.tensor(s) for s in steps])),
    ]
    for name, op in ops:
        jm, tm = op(jm, "jax"), op(tm, "torch")
        _assert_same_state(tm, jm, name)
        np.testing.assert_array_equal(tm.occupied_mask().numpy(), np.asarray(jm.occupied_mask()), err_msg=name)
    _assert_same_state(tm.clear_map(), jm.clear_map(), "clear_map")
    assert tm.memory_usage() == jm.memory_usage()

    # counts: bit x bit (summary or fold) over offsets, bit x prob both ways,
    # the types collide and the bit check
    jp = JProb.create(dims, side).insert_point_cloud(pts_a)
    tp = TProb.create(dims, side, device="cpu").insert_point_cloud(pts_a)
    t = float_to_probability(0.5)
    for off in ((0, 0, 0), (1, -2, 3)):
        ref = int(jm.collide_with(jo, offset=off))
        assert int(tm.collide_with(to, offset=off)) == ref
        assert int(to.collide_with(tm, offset=tuple(-v for v in off))) == ref
        assert ref == int(tcol.count_bit_bit(tm.data, to.data, dims, off))  # summary path == fold path
        ref_pb = int(jp.collide_with(jm, 0.5, off))
        assert int(tp.collide_with(tm, 0.5, off)) == ref_pb == int(tcol.count_prob_bit(tp.data, t, tm.data, dims, off))
        assert int(tm.collide_with(tp, 0.5, off)) == int(jm.collide_with(jp, 0.5, off))
    assert int(tm.collide_with(to)) > 0 and int(tp.collide_with(tm, 0.5)) > 0
    jc, jmean, _ = jm.collide_with_types(jo, sv_window=2)
    tc, tmean, _ = tm.collide_with_types(to, sv_window=2)
    assert int(tc) == int(jc) and np.array_equal(tmean.numpy().view(np.uint32), np.asarray(jmean))
    assert int(tm.collide_with_bitcheck(to, margin=3)) == int(jm.collide_with_bitcheck(jo, margin=3))
    assert bool(tm.collides_with(to)) == bool(jm.collides_with(jo))


def test_mixed_summary_and_raw_maps_collide_through_the_fold():
    """One side with a summary, one without (reference voxelmap.py:559-564):
    the fold answers, and merge recomputes or drops the summary as the
    reference does."""
    dims = (8, 8, 8)
    a, b = _planes(5, 512, "dense"), _planes(6, 512, "dense")
    jraw, jsum = JBit(jnp.asarray(a), dims, 1.0), JBit.from_planes(jnp.asarray(b), dims, 1.0)
    traw, tsum = TBit(_t(a), dims, 1.0), TBit.from_planes(_t(b), dims, 1.0)
    for off in ((0, 0, 0), (2, 1, -1)):
        assert int(traw.collide_with(tsum, offset=off)) == int(jraw.collide_with(jsum, offset=off))
        assert int(tsum.collide_with(traw, offset=off)) == int(jsum.collide_with(jraw, offset=off))
    _assert_same_state(tsum.merge(traw), jsum.merge(jraw), "summary.merge(raw) refolds")
    _assert_same_state(traw.merge(tsum), jraw.merge(jsum), "raw.merge(summary) stays None")
    assert traw.merge(tsum).occ is None and tsum.merge(traw).occ is not None


def test_interop_carries_occ_none_both_ways():
    dims = (6, 5, 4)
    planes = _planes(7, 120, "dense")
    jraw = JBit(jnp.asarray(planes), dims, 0.5)
    tm = interop.bit_map_from_numpy(np.asarray(jraw.data), jraw.occ, dims, 0.5, "cpu")
    assert tm.occ is None and tm.dims == dims and tm.side_length == 0.5
    back_planes, back_occ = interop.to_numpy(tm)
    assert back_occ is None and back_planes.dtype == np.uint32
    jback = JBit(jnp.asarray(back_planes), dims, 0.5, occ=back_occ)
    assert jback.occ is None and int(jback.collide_with(jraw)) == int(tm.collide_with(tm))
    # the explicit spelling of "compute the summary"
    tsum = TBit.from_planes(tm.data, dims, 0.5)
    np.testing.assert_array_equal(tsum.occ.numpy(), np.asarray(jbit.occupied(jraw.data)).astype(np.uint8))
    with pytest.raises(ValueError):
        interop.bit_map_from_numpy(planes, np.zeros(7, np.uint8), dims, 0.5, "cpu")


def _pt(*xyz):
    return np.asarray([xyz], np.float32)


@pytest.mark.parametrize("case", ["levels", "block", "offset", "kinds"])
def test_collide_with_resolution_dense(case):
    """The cases of tests/test_voxelmap.py:198 through both packages."""
    dims = (16, 16, 16)
    ja, jb = JProb.create(dims).insert_point_cloud(_pt(0.5, 0.5, 0.5)), JProb.create(dims).insert_point_cloud(_pt(1.5, 1.5, 1.5))
    ta = TProb.create(dims, device="cpu").insert_point_cloud(_pt(0.5, 0.5, 0.5))
    tb = TProb.create(dims, device="cpu").insert_point_cloud(_pt(1.5, 1.5, 1.5))
    if case == "levels":
        for level, expect in ((0, 0), (1, 1), (4, 1)):
            got = ta.collide_with_resolution(tb, resolution_level=level)
            assert got.dtype == torch.int64
            assert int(got) == int(ja.collide_with_resolution(jb, resolution_level=level)) == expect
    elif case == "block":
        pts = jgen.create_box_of_points((2, 2, 2), (8, 8, 8), 0.9)
        j2, t2 = JProb.create(dims).insert_point_cloud(pts), TProb.create(dims, device="cpu").insert_point_cloud(pts)
        for level in (0, 1, 2):
            assert int(t2.collide_with_resolution(t2, resolution_level=level)) == int(
                j2.collide_with_resolution(j2, resolution_level=level))
        assert int(t2.collide_with_resolution(t2, resolution_level=0)) == int(t2.collide_with(t2))
    elif case == "offset":
        for off in ((-1, -1, -1), (1, 1, 1), (-20, 0, 0), (3, -2, 17)):
            for level in (0, 1):
                assert int(ta.collide_with_resolution(tb, resolution_level=level, offset=off)) == int(
                    ja.collide_with_resolution(jb, resolution_level=level, offset=off)), (off, level)
        assert int(ta.collide_with_resolution(tb, resolution_level=0, offset=(-1, -1, -1))) == 1
        # a grid whose dims are no multiple of the cube: padded with False
        mask = np.random.default_rng(2).random((5, 6, 7)) < 0.3
        for level in (1, 2):
            ref = int(jcol.count_with_resolution(jnp.asarray(mask.ravel()), jnp.asarray(mask.ravel()), level, (7, 6, 5), (1, 0, -1)))
            assert int(tcol.count_with_resolution(torch.tensor(mask.ravel()), torch.tensor(mask.ravel()), level, (7, 6, 5), (1, 0, -1))) == ref
    else:
        jab, jbb = JBit.create(dims).insert_point_cloud(_pt(0.5, 0.5, 0.5)), JBit.create(dims).insert_point_cloud(_pt(1.5, 1.5, 1.5))
        tab = TBit.create(dims, device="cpu").insert_point_cloud(_pt(0.5, 0.5, 0.5))
        tbb = TBit.create(dims, device="cpu").insert_point_cloud(_pt(1.5, 1.5, 1.5))
        raw = TBit(tbb.data, dims, 1.0)  # no summary: the mask is the fold
        for got, ref in (
            (tab.collide_with_resolution(tbb, resolution_level=1), jab.collide_with_resolution(jbb, resolution_level=1)),
            (tab.collide_with_resolution(tb, resolution_level=1), jab.collide_with_resolution(jb, resolution_level=1)),
            (ta.collide_with_resolution(tbb, resolution_level=1), ja.collide_with_resolution(jbb, resolution_level=1)),
            (ta.collide_with_resolution(raw, resolution_level=1), ja.collide_with_resolution(jbb, resolution_level=1)),
        ):
            assert int(got) == int(ref) == 1
        with pytest.raises(TypeError):
            ta.collide_with_resolution(object())
