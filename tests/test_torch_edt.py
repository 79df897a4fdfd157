"""Port conformance: the distance transforms (ops/edt.py, ops/edt_envelope.py).

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference, on the
CPU) and gpu_voxels_tpu_torch; packed grids, squared distances and payloads
must be equal. On the CPU the reference's `envelope_pass` runs its
`_envelope_xla` full scan, the port its plain envelope (K5's spec), so
equidistant ties resolve alike (H6) and payloads compare exactly. Every EDT
is also held against a brute-force numpy oracle. Reference calls run eagerly
or jitted, whichever is cheaper at these sizes; K5 itself is checked on a
card by tests/test_torch_cuda.py.
"""
import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.ops import edt as jedt
from gpu_voxels_tpu.ops import edt_envelope as jenv
from gpu_voxels_tpu_torch.constants import MAX_OBSTACLE_DISTANCE, PBA_UNINITIALISED_PACKED
from gpu_voxels_tpu_torch.ops import edt as tedt
from gpu_voxels_tpu_torch.ops import edt_envelope as tenv


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


DIMS = (24, 20, 16)
MISS = 1 << 27


def np_exact_sqdist(obstacles, dims):
    """Brute-force squared distance to the nearest obstacle (tests/test_distance.py:14-20)."""
    dx, dy, dz = dims
    zz, yy, xx = np.meshgrid(np.arange(dz), np.arange(dy), np.arange(dx), indexing="ij")
    pos = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    obs = np.asarray(obstacles)
    d = ((pos[:, None, :] - obs[None, :, :]) ** 2).sum(-1)
    return d.min(axis=1).reshape(dz, dy, dx)


def scene(seed, n_obs, dims=DIMS):
    """Unique random obstacle coordinates and their obstacle mask."""
    rng = np.random.default_rng(seed)
    obs = np.unique(np.stack([rng.integers(0, d, n_obs) for d in dims], axis=1), axis=0)
    mask = np.zeros(dims[0] * dims[1] * dims[2], bool)
    mask[obs[:, 2] * dims[0] * dims[1] + obs[:, 1] * dims[0] + obs[:, 0]] = True
    return obs, mask


def packed_pair(mask, dims=DIMS):
    """The packed initial grid from both packages: (reference jnp, port tensor)."""
    jp = jedt.init_from_obstacle_mask(jnp.asarray(mask), dims)
    tp = tedt.init_from_obstacle_mask(torch.tensor(mask), dims)
    np.testing.assert_array_equal(tp.numpy().view(np.uint32), np.asarray(jp))
    return jp, tp


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def sqdist(packed: torch.Tensor, dims=DIMS) -> np.ndarray:
    return tedt.squared_distance_grid(packed, dims).numpy()


def test_pack_unpack_and_squared_distances():
    rng = np.random.default_rng(3)
    x, y, z = (rng.integers(0, 1024, 50) for _ in range(3))
    got = tedt.pack(torch.tensor(x), torch.tensor(y), torch.tensor(z))
    ref = jedt.pack(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    np.testing.assert_array_equal(u32(got), np.asarray(ref))
    for a, b in zip(tedt.unpack(got), jedt.unpack(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _, mask = scene(1, 9)
    _, tp = packed_pair(mask)
    # some voxels name far (and uninitialised) sites
    data = tp.clone()
    data[::7] = tedt.pack(torch.tensor(3), torch.tensor(1022), torch.tensor(5))
    data[::11] = PBA_UNINITIALISED_PACKED
    ref = np.asarray(jedt.squared_distance_grid(jnp.asarray(u32(data)), DIMS))
    np.testing.assert_array_equal(sqdist(data), ref)
    assert (ref == MAX_OBSTACLE_DISTANCE).sum() > 0
    idx = torch.tensor([0, 5, 77, DIMS[0] * DIMS[1] * DIMS[2] - 1])
    np.testing.assert_array_equal(tedt.squared_distance_at(data, idx, DIMS).numpy(), ref.reshape(-1)[idx.numpy()])


def _envelope_fixture(kind, rng):
    """int32 g (MISS = no site) and uint32 payloads on a [dz, dy, dx] grid."""
    shape = (3, 17, 9) if kind == "ragged" else (4, 24, 8)
    g = rng.integers(0, 12, shape).astype(np.int32)  # small values: many equidistant ties
    if kind == "ties":
        g[:] = 0
        g[:, ::3, :] = MISS  # sites on two of every three rows, all at offset 0
    elif kind == "empty":
        g[:] = MISS
    elif kind == "single":
        g[:] = MISS
        g[1, 5, 2] = 0
    else:
        g[rng.random(shape) < 0.6] = MISS
        g[:, :, 3] = MISS  # a column with no site at all
    payload = rng.integers(0, 2**30, shape).astype(np.uint32)
    return g, payload


@pytest.mark.parametrize("axis", [1, 2])
@pytest.mark.parametrize("kind", ["random", "ties", "empty", "single", "ragged"])
def test_envelope_pass_matches_reference(kind, axis):
    """K5's spec against the reference's envelope_pass (its `_envelope_xla`
    route off the TPU): distances and payloads. The reference scans axis 1;
    the X pass is compared on the transposed grid."""
    g, payload = _envelope_fixture(kind, np.random.default_rng(11))
    td, tp = tenv.envelope_pass(torch.tensor(g), torch.tensor(payload.view(np.int32)), axis)
    perm = (0, 1, 2) if axis == 1 else (0, 2, 1)
    jd, jp = jenv.envelope_pass(jnp.asarray(g.transpose(perm)), jnp.asarray(payload.transpose(perm)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd).transpose(perm))
    np.testing.assert_array_equal(u32(tp), np.asarray(jp).transpose(perm))
    if kind == "empty":
        assert (td.numpy() == MISS).all() and (u32(tp) == PBA_UNINITIALISED_PACKED).all()
    # the same function, computed by brute force with ties to the smallest q
    gm = np.moveaxis(g, axis, -1).astype(np.int64)
    n = gm.shape[-1]
    q = np.arange(n)
    cand = np.where(gm[..., None, :] >= MISS, 2**40, (q[:, None] - q[None, :]) ** 2 + gm[..., None, :])
    best = cand.min(-1)
    np.testing.assert_array_equal(np.moveaxis(td.numpy(), axis, -1), np.where(best < MISS, best, MISS))


def test_nearest_scan_matches_reference():
    _, mask = scene(4, 30)
    flag = mask.reshape(16, 20, 24)
    flag[:, 3, :] = False  # empty columns
    jd, jn = jenv._nearest_scan(jnp.asarray(flag), 16)
    td, tn = tenv._nearest_scan(torch.tensor(flag))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("seed,n_obs", [(31, 40), (32, 3), (33, 400)])
def test_parallel_banding_matches_reference_and_oracle(seed, n_obs):
    """The exact EDT: packed output (so payloads) equal to the reference's,
    squared distances equal to brute force."""
    obs, mask = scene(seed, n_obs)
    jp, tp = packed_pair(mask)
    got = tenv.parallel_banding(tp, DIMS)
    ref = jax.jit(partial(jenv.parallel_banding, dims=DIMS))(jp)
    np.testing.assert_array_equal(u32(got), np.asarray(ref))
    np.testing.assert_array_equal(sqdist(got), np_exact_sqdist(obs, DIMS))


def test_parallel_banding_empty_grid_stays_uninitialised():
    tp = tedt.init_from_obstacle_mask(torch.zeros(DIMS[0] * DIMS[1] * DIMS[2], dtype=torch.bool), DIMS)
    assert (u32(tenv.parallel_banding(tp, DIMS)) == PBA_UNINITIALISED_PACKED).all()


def test_jump_flood_and_stats_match_reference():
    """Flat JFA with the fixpoint repair, and its telemetry variant, against
    the reference's jump_flood_with_stats (the same schedule)."""
    obs, mask = scene(5, 17)
    jp, tp = packed_pair(mask)
    ref, ref_iters = jedt.jump_flood_with_stats(jp, DIMS)
    got, iters = tedt.jump_flood_with_stats(tp, DIMS)
    np.testing.assert_array_equal(u32(got), np.asarray(ref))
    assert iters == int(ref_iters) < 64
    np.testing.assert_array_equal(u32(tedt.jump_flood(tp, DIMS)), np.asarray(ref))
    np.testing.assert_array_equal(sqdist(got), np_exact_sqdist(obs, DIMS))
    # without the repair, the step schedule alone, and with more refinement rounds
    plain = tedt.jump_flood(tp, DIMS, extra_rounds=2, converge=False)
    assert (sqdist(plain) >= np_exact_sqdist(obs, DIMS)).all()


def test_jump_flood_multires_matches_reference():
    dims = (16, 16, 16)
    obs, mask = scene(23, 60, dims)
    jp, tp = packed_pair(mask, dims)
    got = tedt.jump_flood_multires(tp, dims)
    np.testing.assert_array_equal(u32(got), np.asarray(jedt.jump_flood_multires(jp, dims)))
    np.testing.assert_array_equal(sqdist(got, dims), np_exact_sqdist(obs, dims))


def test_shift3d_wraps_like_reference():
    """An offset beyond an axis's size (the coarse JFA's steps on a flat
    grid) wraps part of the axis back in, in both packages (F8)."""
    grid = np.arange(4 * 5 * 6, dtype=np.int32).reshape(4, 5, 6)
    for off in [(1, -2, 3), (0, 0, 6), (7, 0, 0), (-9, 2, 0), (0, -5, -4)]:
        got = tedt._shift3d(torch.tensor(grid), off, -1)
        ref = jedt._shift3d(jnp.asarray(grid), off, -1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=str(off))


@pytest.mark.parametrize("seed", [11, 12])
def test_exact_separable_matches_reference(seed):
    """Meijster's envelope with the reference's tie rule: payloads equal."""
    obs, mask = scene(seed, 23)
    jp, tp = packed_pair(mask)
    got = tedt.exact_separable(tp, DIMS)
    np.testing.assert_array_equal(u32(got), np.asarray(jax.jit(partial(jedt.exact_separable, dims=DIMS))(jp)))
    np.testing.assert_array_equal(sqdist(got), np_exact_sqdist(obs, DIMS))


def test_exact_distances_matches_reference():
    obs, _ = scene(7, 9)
    obs = obs.astype(np.int32)
    obs = np.concatenate([obs, obs[:2], [[1023, 0, 0]]]).astype(np.int32)  # duplicates tie; an invalid row
    got = tedt.exact_distances(torch.tensor(obs), DIMS, chunk=1000)
    ref = jedt.exact_distances(jnp.asarray(obs), DIMS)
    np.testing.assert_array_equal(u32(got), np.asarray(ref))
    np.testing.assert_array_equal(sqdist(got), np_exact_sqdist(obs[:-1], DIMS))


def byte_oracle(d2: np.ndarray, radius: int) -> np.ndarray:
    """extract_byte_distances by integers: clamp(isqrt(d2) - radius, 0, 127),
    uninitialised voxels as 127."""
    root = np.array([math.isqrt(int(v)) for v in np.minimum(d2, 127 * 127)], np.int64)
    return np.clip(root - radius, 0, 127).astype(np.int8)


def test_floor_sqrt_is_exact_on_squares_and_their_neighbours():
    """The byte distance's root on every perfect square below 127^2, one
    below and one above each, and on squares up to 2^31, where the f32 root
    alone can floor one too high or too low."""
    k = np.arange(0, 46341, dtype=np.int64)
    for values in (k[:127] ** 2, k[1:127] ** 2 - 1, k[:127] ** 2 + 1, k[1:] ** 2 - 1, k ** 2):
        values = values[values < 2**31]
        got = tedt.floor_sqrt(torch.tensor(values)).numpy()
        np.testing.assert_array_equal(got, [math.isqrt(int(v)) for v in values])


def test_manhattan_bytes_and_differences_match_reference():
    obs, mask = scene(8, 12)
    jp, tp = packed_pair(mask)
    np.testing.assert_array_equal(tedt.manhattan_distance(torch.tensor(mask), DIMS).numpy(),
                                  np.asarray(jedt.manhattan_distance(jnp.asarray(mask), DIMS)))
    np.testing.assert_array_equal(tedt.manhattan_distance(torch.tensor(mask), DIMS, cap=5).numpy(),
                                  np.asarray(jedt.manhattan_distance(jnp.asarray(mask), DIMS, cap=5)))
    sep = tedt.exact_separable(tp, DIMS)
    d2 = sqdist(sep).reshape(-1).astype(np.int64)
    for radius in (0, 2):
        oracle = byte_oracle(d2, radius)
        port = tedt.extract_byte_distances(sep, DIMS, radius).numpy()
        ref = np.asarray(jedt.extract_byte_distances(jnp.asarray(np.array(u32(sep), copy=True)), DIMS, radius))
        # which side left the integer oracle, and where
        for side, got in (("port", port), ("reference", ref)):
            off = np.flatnonzero(got != oracle)
            assert off.size == 0, (f"radius {radius}: the {side} leaves the isqrt oracle at {off.size} of {d2.size} "
                                   f"voxels, d2 {d2[off[:8]].tolist()}: {got[off[:8]].tolist()} against "
                                   f"{oracle[off[:8]].tolist()}")
    assert int(tedt.differences(sep, tedt.exact_distances(torch.tensor(obs.astype(np.int32)), DIMS), DIMS)) == 0
    assert int(tedt.differences(sep, tp, DIMS)) == int(jedt.differences(jnp.asarray(u32(sep)), jp, DIMS)) > 0
