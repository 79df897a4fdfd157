"""Port conformance: dense collides, and kernels K1/K2 against their spec.

On the CPU the wrappers of ops/collide_cuda take the plain torch versions;
they are held against gpu_voxels_tpu's XLA forms and against its Pallas
kernels run in interpret mode (as tests/test_collide_pallas.py runs them).
Counts and marked maps are integer contracts: exact equality. The kernels
themselves are checked on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.geometry import generation as jgen
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import collide as jcol
from gpu_voxels_tpu.ops import collide_pallas as jpal
from gpu_voxels_tpu_torch.geometry import generation as tgen
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import collide as tcol
from gpu_voxels_tpu_torch.ops import collide_cuda


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


DIMS = (37, 29, 23)
OFFSETS = [(0, 0, 0), (-1, 0, -1), (3, -2, 1), (1, 0, 0)]


def _prob(seed, n):
    return np.random.default_rng(seed).integers(-128, 128, n).astype(np.int8)


def test_k1_plain_matches_xla_and_pallas_interpret():
    n = 300_000  # not tile aligned
    a, b = _prob(0, n), _prob(1, n)
    for t1, t2 in ((100, 100), (-120, 0), (0, 127)):
        got = collide_cuda.count_prob_prob(torch.tensor(a), torch.tensor(b), t1, t2)
        assert got.dtype == torch.int64 and got.ndim == 0
        assert int(got) == int(jcol.count_prob_prob(jnp.asarray(a), jnp.asarray(b), t1, t2))
    assert int(collide_cuda.count_prob_prob(torch.tensor(a), torch.tensor(b), 100, 100)) == int(
        jpal.count_prob_prob(jnp.asarray(a), jnp.asarray(b), 100, 100)
    )


def test_k2_plain_matches_xla_and_pallas_interpret():
    n = 50_000
    a, b = _prob(2, n), _prob(3, n)
    cnt, marked = collide_cuda.count_and_mark_prob(torch.tensor(a), torch.tensor(b), 50, 50)
    ref_c, ref_m = jpal.count_and_mark_prob(jnp.asarray(a), jnp.asarray(b), 50, 50)
    assert int(cnt) == int(ref_c)
    np.testing.assert_array_equal(marked.numpy(), np.asarray(ref_m))


@pytest.mark.parametrize("offset", OFFSETS)
def test_offset_collides_match_xla(offset):
    """Flat-offset semantics of every plain collide, incl. the marked map."""
    n = DIMS[0] * DIMS[1] * DIMS[2]
    a, b = _prob(4, n), _prob(5, n)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.tensor(a), torch.tensor(b)
    assert int(collide_cuda.count_prob_prob(ta, tb, 10, -5, DIMS, offset)) == int(
        jcol.count_prob_prob(ja, jb, 10, -5, DIMS, offset)
    )
    cnt, marked = collide_cuda.count_and_mark_prob(ta, tb, 10, -5, DIMS, offset)
    ref_c, ref_m = jcol.count_and_mark_prob(ja, jb, 10, -5, DIMS, offset)
    assert int(cnt) == int(ref_c)
    np.testing.assert_array_equal(marked.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(ta.numpy(), a)  # functional: input untouched

    r = np.random.default_rng(6)
    pa = (r.integers(0, 2**32, (8, n), dtype=np.uint64) & r.integers(0, 3, (8, n), dtype=np.uint64)).astype(np.uint32)
    pb = (r.integers(0, 2**32, (8, n), dtype=np.uint64) & r.integers(0, 3, (8, n), dtype=np.uint64)).astype(np.uint32)
    pa[:, ::3] = 0
    tpa, tpb = torch.tensor(pa.view(np.int32)), torch.tensor(pb.view(np.int32))
    jpa, jpb = jnp.asarray(pa), jnp.asarray(pb)
    assert int(tcol.count_bit_bit(tpa, tpb, DIMS, offset)) == int(jcol.count_bit_bit(jpa, jpb, DIMS, offset))
    assert int(tcol.count_prob_bit(ta, 0, tpb, DIMS, offset)) == int(jcol.count_prob_bit(ja, 0, jpb, DIMS, offset))
    occ_a = tcol.bitops.occupied(tpa).to(torch.uint8)
    occ_b = tcol.bitops.occupied(tpb).to(torch.uint8)
    assert int(tcol.count_occ_occ(occ_a, occ_b, DIMS, offset)) == int(jcol.count_bit_bit(jpa, jpb, DIMS, offset))
    assert int(tcol.count_prob_occ(ta, 0, occ_b, DIMS, offset)) == int(jcol.count_prob_bit(ja, 0, jpb, DIMS, offset))
    cnt, new_a = tcol.count_and_mark_bit(tpa, tpb, DIMS, offset)
    ref_c, ref_a = jcol.count_and_mark_bit(jpa, jpb, DIMS, offset)
    assert int(cnt) == int(ref_c)
    np.testing.assert_array_equal(new_a.numpy().view(np.uint32), np.asarray(ref_a))


def test_offset_oracle_8_18_18():
    """testing_voxelmap.cu:118-143 (tests/test_voxelmap.py:34-42): two 3x3x3
    boxes overlap in 8 voxels, and in 18 under the offsets."""
    dims = (89, 123, 74)
    p1 = tgen.create_box_of_points((2.1, 2.1, 2.1), (4.1, 4.1, 4.1), 0.5)
    p2 = tgen.create_box_of_points((3.1, 3.1, 3.1), (5.1, 5.1, 5.1), 0.5)
    np.testing.assert_array_equal(p1, jgen.create_box_of_points((2.1, 2.1, 2.1), (4.1, 4.1, 4.1), 0.5))
    m1 = TProb.create(dims, device="cpu").insert_point_cloud(p1)
    m2 = TProb.create(dims, device="cpu").insert_point_cloud(p2)
    assert int(m1.collide_with(m2, 0.1)) == 8
    assert int(m1.collide_with(m2, 0.1, (-1, 0, -1))) == 18
    assert int(m2.collide_with(m1, 0.1, (1, 0, 1))) == 18
    assert bool(m1.collides_with(m2, 0.1)) and not bool(m1.collides_with(TProb.create(dims, device="cpu"), 0.1))
    cnt, marked = m1.collide_with_marking(m2, 0.1, (-1, 0, -1))
    assert int(cnt) == 18 and torch.equal(marked.data, m1.data)  # hits already hold 127
    b1 = TBit.create(dims, device="cpu").insert_point_cloud(p1)
    b2 = TBit.create(dims, device="cpu").insert_point_cloud(p2)
    assert int(b1.collide_with(b2)) == 8
    assert int(b1.collide_with(b2, 1.0, (-1, 0, -1))) == 18
    assert int(b1.collide_with(m2, 0.1, (-1, 0, -1))) == 18  # bit x prob
    assert int(m1.collide_with(b2, 0.1, (-1, 0, -1))) == 18  # prob x bit


@pytest.mark.parametrize("offset", [(0, 0, 0), (2, -1, 1)])
def test_map_collides_match_reference(offset):
    """Every map pairing through the public methods, thresholds included."""
    r = np.random.default_rng(7)
    ext = np.asarray(DIMS, np.float32)
    clouds = [r.uniform(0, 1, (3000, 3)).astype(np.float32) * ext for _ in range(3)]
    j1 = JProb.create(DIMS).insert_point_cloud(clouds[0]).update_occupancy(clouds[2], -200)
    t1 = TProb.create(DIMS, device="cpu").insert_point_cloud(clouds[0]).update_occupancy(clouds[2], -200)
    j2 = JProb.create(DIMS).insert_point_cloud(clouds[1])
    t2 = TProb.create(DIMS, device="cpu").insert_point_cloud(clouds[1])
    jb = JBit.create(DIMS).insert_point_cloud(clouds[1], 7).insert_point_cloud(clouds[2], 0)
    tb = TBit.create(DIMS, device="cpu").insert_point_cloud(clouds[1], 7).insert_point_cloud(clouds[2], 0)
    for thr in (0.1, 0.5, 1.0):
        assert int(t1.collide_with(t2, thr, offset)) == int(j1.collide_with(j2, thr, offset))
        assert int(t1.collide_with(tb, thr, offset)) == int(j1.collide_with(jb, thr, offset))
        assert int(tb.collide_with(t1, thr, offset)) == int(jb.collide_with(j1, thr, offset))
        assert int(tb.collide_with(tb, thr, offset)) == int(jb.collide_with(jb, thr, offset))
        assert bool(t1.collides_with(t2, thr, offset)) == bool(j1.collides_with(j2, thr, offset))
    cnt, marked = t1.collide_with_marking(t2, 0.1, offset)
    ref_c, ref_m = j1.collide_with_marking(j2, 0.1, offset)
    assert int(cnt) == int(ref_c) > 0
    np.testing.assert_array_equal(marked.data.numpy(), np.asarray(ref_m.data))
    merged = t1.merge(t2)
    np.testing.assert_array_equal(merged.data.numpy(), np.asarray(j1.merge(j2).data))
    np.testing.assert_array_equal(t1.occupied_mask(0.3).numpy(), np.asarray(j1.occupied_mask(0.3)))


def test_kernel_wrappers_refuse_what_they_cannot_take():
    a = torch.zeros(10, dtype=torch.int8)
    with pytest.raises(ValueError):  # a CPU map never meets a kernel
        collide_cuda._check(a, a)
    assert collide_cuda.launches == {"count_prob_prob": 0, "count_and_mark_prob": 0, "collide_types_bit_bit": 0,
                                     "count_bit_bit": 0}
