"""Port conformance: constants, int8 log-odds arithmetic and the bitops subset.

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch; every result is an integer contract and must be equal.
"""
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import bitops as jbit
from gpu_voxels_tpu import constants as jconst
from gpu_voxels_tpu import probability as jprob
from gpu_voxels_tpu_torch import bitops as tbit
from gpu_voxels_tpu_torch import constants as tconst
from gpu_voxels_tpu_torch import probability as tprob


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


def test_constants_match_reference():
    names = [n for n in dir(jconst) if not n.startswith("_")]
    for name in names:
        ref = getattr(jconst, name)
        if isinstance(ref, (int, float)) and not isinstance(ref, enum.Enum):
            assert getattr(tconst, name) == ref, name
        elif isinstance(ref, type) and issubclass(ref, enum.Enum):
            got = getattr(tconst, name)
            assert {m.name: int(m) for m in got} == {m.name: int(m) for m in ref}, name
    for v in np.linspace(-0.5, 1.5, 81):
        assert tconst.float_to_probability(float(v)) == jconst.float_to_probability(float(v))
    for m in range(256):
        assert tconst.meaning_to_probability(m) == jconst.meaning_to_probability(m)


def test_update_occupancy_saturates_like_reference():
    """H8: int8 + delta widens to int32 and clamps to [-127, 127]."""
    rng = np.random.default_rng(0)
    occ = rng.integers(-128, 128, 5000).astype(np.int8)
    occ[:4] = [-128, 127, -127, 0]
    delta = rng.integers(-400, 400, 5000).astype(np.int32)
    delta[:4] = [-10, 72, -10, 300]
    ref = np.asarray(jprob.update_occupancy(jnp.asarray(occ), jnp.asarray(delta)))
    got = tprob.update_occupancy(torch.tensor(occ), torch.tensor(delta)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int8
    assert list(got[:4]) == [-127, 127, -127, 127]
    # scalar delta and the two predicates
    np.testing.assert_array_equal(
        tprob.update_occupancy(torch.tensor(occ), 72).numpy(),
        np.asarray(jprob.update_occupancy(jnp.asarray(occ), 72)),
    )
    for t in (-128, 0, 100, 127):
        np.testing.assert_array_equal(
            tprob.is_occupied(torch.tensor(occ), t).numpy(),
            np.asarray(jprob.is_occupied(jnp.asarray(occ), t)),
        )
    np.testing.assert_array_equal(
        tprob.is_unknown(torch.tensor(occ)).numpy(), np.asarray(jprob.is_unknown(jnp.asarray(occ)))
    )


def _random_planes(seed, n=3000):
    r = np.random.default_rng(seed)
    dense = r.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
    sparse = dense & r.integers(0, 4, (8, n), dtype=np.uint64).astype(np.uint32)
    sparse[:, : n // 3] = 0  # empty voxels
    sparse[0, : n // 6] = 1  # eBVM_FREE only: not occupied
    return sparse


def _t(planes_u32):
    """The port's int32 view of reference uint32 planes (H1)."""
    return torch.tensor(planes_u32.view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("meaning", [0, 1, 2, 31, 32, 63, 200, 255])
def test_bit_set_clear_get_match_reference(meaning):
    p = _random_planes(meaning)
    np.testing.assert_array_equal(_u32(tbit.set_bit(_t(p), meaning)), np.asarray(jbit.set_bit(jnp.asarray(p), meaning)))
    np.testing.assert_array_equal(_u32(tbit.clear_bit(_t(p), meaning)), np.asarray(jbit.clear_bit(jnp.asarray(p), meaning)))
    np.testing.assert_array_equal(tbit.get_bit(_t(p), meaning).numpy(), np.asarray(jbit.get_bit(jnp.asarray(p), meaning)))
    assert tbit.bit_plane(meaning) == jbit.bit_plane(meaning)
    assert tbit.bit_word(meaning) == jbit.bit_word(meaning)
    assert np.int32(tbit.as_int32(tbit.bit_word(meaning))).view(np.uint32) == jbit.bit_word(meaning)


def test_bit_folds_and_predicates_match_reference():
    a, b = _random_planes(10), _random_planes(11)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    np.testing.assert_array_equal(_u32(tbit.masked_fold(ta)), np.asarray(jbit.masked_fold(ja)))
    fold = tbit.masked_fold(ta)
    np.testing.assert_array_equal(
        tbit.nonzero_u32(fold).numpy(), np.asarray(jbit.nonzero_u32(jbit.masked_fold(ja))).astype(np.int32)
    )
    for name in ("is_zero", "none_but_empty", "occupied"):
        np.testing.assert_array_equal(getattr(tbit, name)(ta).numpy(), np.asarray(getattr(jbit, name)(ja)), name)
    np.testing.assert_array_equal(_u32(tbit.bv_or(ta, tb)), np.asarray(jbit.bv_or(ja, jb)))
    np.testing.assert_array_equal(_u32(tbit.bv_and(ta, tb)), np.asarray(jbit.bv_and(ja, jb)))
    z = tbit.zeros((5,), device="cpu")
    assert z.shape == (8, 5) and z.dtype == torch.int32 and not z.any()
    # the sign bit (bit 31 of a plane) is an ordinary bit in the int32 view
    top = np.zeros((8, 2), np.uint32)
    top[3, 0] = np.uint32(1) << 31
    assert tbit.occupied(_t(top)).tolist() == [True, False]
