"""Port conformance: voxelization, point insertion and rigid transforms.

The same numpy points go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch; voxel indices and final maps must be equal. Only the
transformed points carry a tolerance (rtol 1e-6): the two frameworks sum a
matrix product in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.constants import BitVoxelMeaning
from gpu_voxels_tpu.geometry import transforms as jtf
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import insert as jins
from gpu_voxels_tpu_torch import bitops as tbit
from gpu_voxels_tpu_torch.geometry import transforms as ttf
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import insert as tins


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


DIMS = (21, 17, 13)


def _cloud(seed, n=4000, side=0.1):
    """Points inside and around the map, plus NaN, inf and far-out rows (H2)."""
    r = np.random.default_rng(seed)
    ext = np.asarray(DIMS, np.float32) * side
    pts = r.uniform(-0.2, 1.2, (n, 3)).astype(np.float32) * ext
    pts[:6] = [
        [np.nan, np.nan, np.nan],
        [np.nan, 0.15, 0.15],
        [np.inf, 0.1, 0.1],
        [-np.inf, 0.1, 0.1],
        [1e20, 0.1, 0.1],
        [-1e20, 0.1, 0.1],
    ]
    return pts


def test_map_to_voxels_and_voxelize_match_reference():
    """Out-of-map and NaN points (H2): a NaN coordinate becomes voxel 0, as
    the reference's saturating cast makes it; far-out points stay out."""
    pts = _cloud(0)
    np.testing.assert_array_equal(
        tins.map_to_voxels(torch.tensor(pts), 0.1).numpy(),
        np.asarray(jins.map_to_voxels(jnp.asarray(pts), 0.1)),
    )
    idx, outside = tins.voxelize(torch.tensor(pts), 0.1, DIMS)
    ridx, routside = jins.voxelize(jnp.asarray(pts), 0.1, DIMS)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    assert bool(outside) == bool(routside) is True
    inside = np.asarray([[0.05, 0.05, 0.05]], np.float32)
    assert not bool(tins.voxelize(torch.tensor(inside), 0.1, DIMS)[1])


@pytest.mark.parametrize("side", [0.1, 0.01, 0.02, 1.0 / 3.0, 0.05])
def test_boundary_points_voxelize_like_reference(side):
    """H3: points on exact multiples of the side length go to the cell the
    reference's f32-reciprocal multiply puts them in."""
    k = np.arange(0, 13, dtype=np.float32)
    on = np.float32(side) * k
    pts = np.stack([on, on[::-1], np.roll(on, 3)], axis=1).astype(np.float32)
    pts = np.concatenate([pts, np.nextafter(pts, np.float32(np.inf)), np.nextafter(pts, np.float32(-np.inf))])
    # the neighbours of 0 are subnormal, which XLA on the CPU flushes to zero
    # and torch does not: a coordinate of 1e-45 m is not a boundary case
    pts[np.abs(pts) < np.finfo(np.float32).tiny] = 0.0
    np.testing.assert_array_equal(
        tins.map_to_voxels(torch.tensor(pts), side).numpy(),
        np.asarray(jins.map_to_voxels(jnp.asarray(pts), side)),
    )
    np.testing.assert_array_equal(
        tins.voxelize(torch.tensor(pts), side, DIMS)[0].numpy(),
        np.asarray(jins.voxelize(jnp.asarray(pts), side, DIMS)[0]),
    )


@pytest.mark.parametrize("meaning", [0, 1, 2, 3, 10])
def test_insert_prob_matches_reference(meaning):
    pts = _cloud(meaning + 1)
    ref = JProb.create(DIMS, 0.1).insert_point_cloud(pts, meaning)
    got = TProb.create(DIMS, 0.1, device="cpu").insert_point_cloud(pts, meaning)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    # an update on top: +72 on every hit voxel, clamped
    ref2 = ref.update_occupancy(pts[:500], 72)
    got2 = got.update_occupancy(pts[:500], 72)
    np.testing.assert_array_equal(got2.data.numpy(), np.asarray(ref2.data))


def test_insert_bit_and_occupancy_summary_match_reference():
    """Bits across planes, incl. eBVM_FREE (bit 0, not occupied) and a plane's
    sign bit; the occ summary stays coherent with the planes."""
    ref = JBit.create(DIMS, 0.1)
    got = TBit.create(DIMS, 0.1, device="cpu")
    for i, meaning in enumerate([0, 1, 31, 32, 63, 200, 2]):
        pts = _cloud(20 + i, n=600)
        ref = ref.insert_point_cloud(pts, meaning)
        got = got.insert_point_cloud(pts, meaning)
        np.testing.assert_array_equal(got.data.numpy().view(np.uint32), np.asarray(ref.data))
        np.testing.assert_array_equal(got.occ.numpy(), np.asarray(ref.occ))
        np.testing.assert_array_equal(got.occ.numpy() != 0, tbit.occupied(got.data).numpy())
    # the bit-0-only voxels are not occupied
    free_only = JBit.create(DIMS, 0.1).insert_point_cloud(_cloud(40), BitVoxelMeaning.eBVM_FREE)
    t_free = TBit.create(DIMS, 0.1, device="cpu").insert_point_cloud(_cloud(40), BitVoxelMeaning.eBVM_FREE)
    assert int(t_free.occ.sum()) == int(np.asarray(free_only.occ).sum()) == 0
    # merge keeps the summary coherent too
    m_ref = ref.merge(free_only, new_meaning=5)
    m_got = got.merge(t_free, new_meaning=5)
    np.testing.assert_array_equal(m_got.data.numpy().view(np.uint32), np.asarray(m_ref.data))
    np.testing.assert_array_equal(m_got.occ.numpy(), np.asarray(m_ref.occ))
    m_ref = ref.merge(free_only)
    m_got = got.merge(t_free)
    np.testing.assert_array_equal(m_got.occ.numpy(), np.asarray(m_ref.occ))


def test_transforms_match_reference():
    """Rigid transforms, with the stated tolerance rtol=1e-6 (summation order)."""
    rng = np.random.default_rng(5)
    rpy = np.asarray([0.3, -0.7, 1.9], np.float32)
    t = np.asarray([0.5, -1.0, 2.0], np.float32)
    np.testing.assert_array_equal(ttf.from_rpy_np(rpy, t), jtf.from_rpy(rpy, t, xp=np))
    m_ref = np.asarray(jtf.from_rpy(jnp.asarray(rpy), jnp.asarray(t)))
    m_got = ttf.from_rpy(torch.tensor(rpy), torch.tensor(t)).numpy()
    np.testing.assert_allclose(m_got, m_ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        ttf.invert(torch.tensor(m_ref)).numpy(), np.asarray(jtf.invert(jnp.asarray(m_ref))), rtol=1e-6, atol=1e-7
    )
    for name, ang in (("rot_x", 0.4), ("rot_y", -1.1), ("rot_z", 2.5)):
        np.testing.assert_allclose(
            getattr(ttf, name)(ang, device="cpu").numpy(), np.asarray(getattr(jtf, name)(jnp.float32(ang))), rtol=1e-6, atol=1e-7
        )
    np.testing.assert_array_equal(ttf.identity("cpu").numpy(), np.asarray(jtf.identity()))
    np.testing.assert_array_equal(ttf.from_translation(t, device="cpu").numpy(), np.asarray(jtf.from_translation(t)))
    pts = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttf.transform_points(torch.tensor(m_ref), torch.tensor(pts)).numpy(),
        np.asarray(jtf.transform_points(jnp.asarray(m_ref), jnp.asarray(pts))),
        rtol=1e-6, atol=1e-6,
    )
    per_point = np.repeat(m_ref[None], 7, axis=0)
    np.testing.assert_allclose(
        ttf.transform_points(torch.tensor(per_point), torch.tensor(pts[:7])).numpy(),
        np.asarray(jtf.transform_points(jnp.asarray(per_point), jnp.asarray(pts[:7]))),
        rtol=1e-6, atol=1e-6,
    )
