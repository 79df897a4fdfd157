"""Port conformance of kernel K6's two parts: the P x P min-pool of a depth
frame and the carve against the pooled table.

(a) The port's pool (`raycast_cuda.min_pool_depth`, its plain version on
    the CPU: the spec the pool kernel is held to on the card) against the
    reference's `raycast_pallas.min_pool_depth`, bit pattern for bit
    pattern: frames that are no multiple of P, NaN, -inf, +inf and invalid
    pixels. A NaN pixel must make its cell NaN (H11: a hand-written min with
    fminf would drop it, and the cell would carve where the spec carves
    nothing).
(b) A numpy model of the carve kernel's pool-cell index
    (csrc/carve_pooled.cu `pool_divisor`, `pool_cell`): a shift for a power
    of two, else the high word of a 32 x 32-bit product with a reciprocal,
    shifted; equal to u // P for every pixel of a 640 x 480 frame at every
    P up to 1,024 and at large P, and the proof's inequality at every P
    below 2^16.
(c) The pooled carve through `insert_depth_image(carve_pool=P)` against the
    reference's eager frame update at 64^3 on the edge-aligned pose, whose
    voxel centres project exactly onto pooled-cell edges and the image's
    edges (exact in f32 in both packages) and otherwise at least 1/64 px
    from a pixel edge; every measured point lies >= 1e-3 voxel from a cell
    boundary (H4).
The pool and carve kernels themselves are checked on a card by
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_cuda import EDGE_DIMS, EDGE_INTR, EDGE_SIDE, edge_frame, edge_pose, k6_frames

from gpu_voxels_tpu.ops import raycast as jrc
from gpu_voxels_tpu.ops import raycast_pallas as jrp
from gpu_voxels_tpu_torch.ops import raycast as trc
from gpu_voxels_tpu_torch.ops import raycast_cuda


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


@pytest.mark.parametrize("pool", [1, 2, 7, 8])
def test_min_pool_matches_reference_bit_for_bit(pool):
    frames = k6_frames()
    frames["odd"] = np.ascontiguousarray(frames["special"][:45, :61])
    for name, frame in frames.items():
        for invalid in (0.0, float("nan"), float(frame[3, 3])):
            got = raycast_cuda.min_pool_depth(torch.tensor(frame), pool, invalid).numpy()
            ref = np.asarray(jrp.min_pool_depth(jnp.asarray(frame), pool, invalid))
            assert got.shape == ref.shape == (-(-frame.shape[0] // pool), -(-frame.shape[1] // pool)), name
            np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=f"{name} {invalid}")
    # the special frame's NaN cells are NaN, its +inf cell +inf, and the
    # cells that reach past a 45 x 61 frame hold at least the padding 3e38
    special = raycast_cuda.min_pool_depth(torch.tensor(frames["special"]), pool).numpy()
    assert np.isnan(special).any() and np.isneginf(special).any()
    if pool == 8:
        assert special[5, 7] == np.inf
    odd = raycast_cuda.min_pool_depth(torch.tensor(np.full((45, 61), np.inf, np.float32)), pool).numpy()
    edge = np.zeros(odd.shape, bool)
    if 45 % pool:
        edge[-1, :] = True
    if 61 % pool:
        edge[:, -1] = True
    assert (odd[edge] == np.float32(3.0e38)).all() and (odd[~edge] == np.inf).all()


def pool_divisor(pool: int) -> tuple[int, int]:
    """csrc/carve_pooled.cu pool_divisor: (mul, shift)."""
    s = pool.bit_length() - 1
    if pool & (pool - 1) == 0:
        return 0, s
    return ((1 << (32 + s)) + pool - 1) // pool, s


def pool_cell(u: np.ndarray, mul: int, shift: int) -> np.ndarray:
    """csrc/carve_pooled.cu pool_cell for 0 <= u < 2^31, in uint64."""
    x = u.astype(np.uint64)
    q = (x * np.uint64(mul)) >> np.uint64(32) if mul else x
    return (q >> np.uint64(shift)).astype(np.int64)


def test_pool_cell_index_is_exact():
    u, v = np.arange(640), np.arange(480)
    for pool in list(range(1, 1025)) + [1031, 4095, 65537, 2**20 + 1, 2**30 - 1, 2**30, 2**31 - 1]:
        mul, shift = pool_divisor(pool)
        assert 0 <= mul < 2**32 and (mul == 0) == (pool & (pool - 1) == 0)
        np.testing.assert_array_equal(pool_cell(u, mul, shift), u // pool, err_msg=str(pool))
        np.testing.assert_array_equal(pool_cell(v, mul, shift), v // pool, err_msg=str(pool))
        # the largest u, and both sides of the last cell edges below 2^31
        edges = (2**31 - 1) // pool * pool - pool * np.arange(3, dtype=np.int64)
        top = np.concatenate([np.arange(2**31 - 64, 2**31), edges, edges - 1])
        top = top[top >= 0]
        np.testing.assert_array_equal(pool_cell(top, mul, shift), top // pool, err_msg=str(pool))
    # the proof's step: e = mul * P - 2^(32+s) times the largest u stays below 2^(32+s)
    for pool in range(3, 2**16):
        mul, shift = pool_divisor(pool)
        if mul:
            e = mul * pool - (1 << (32 + shift))
            assert 0 <= e < pool and (2**31 - 1) * e < 1 << (32 + shift), pool


def _boundary_safe(depth: np.ndarray, margin: float = 2e-3) -> np.ndarray:
    """The edge frame with every pixel whose world point lies within `margin`
    voxel of a cell boundary marked invalid (float64 pinhole model)."""
    fx, fy, cx, cy = EDGE_INTR
    h, w = depth.shape
    z = depth.astype(np.float64)
    u, v = np.arange(w, dtype=np.float64)[None, :], np.arange(h, dtype=np.float64)[:, None]
    world = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], axis=-1) + edge_pose()[:3, 3]
    f = world / EDGE_SIDE
    out = depth.copy()
    out[(np.abs(f - np.round(f)) < margin).any(axis=-1)] = 0.0
    return out


def _projections_on_edges(dims, side, intr, shape):
    """Voxel centres in front of the edge-aligned camera, in exact arithmetic:
    (u, v in P * Z inside the image, at each P), (u or v on an image edge),
    and the least distance of a projection off a pixel edge to one."""
    dx, dy, dz = dims
    fx, fy, cx, cy = intr
    h, w = shape
    x = np.arange(dx)[None, None, :] - dx // 2
    y = np.arange(dy)[None, :, None] - dy // 2
    z = np.arange(1, dz)[:, None, None]
    num_u, num_v = int(fx) * x, int(fy) * y  # u - cx = num_u / z exactly
    on_u, on_v = num_u % z == 0, num_v % z == 0
    u = np.where(on_u, num_u // z, 0) + int(cx)
    v = np.where(on_v, num_v // z, 0) + int(cy)
    inside = on_u & on_v & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    corners = {p: int((inside & (u % p == 0) & (v % p == 0)).sum()) for p in (2, 4, 7, 8)}
    edges = int((on_u & ((u == 0) | (u == w))).sum() + (on_v & ((v == 0) | (v == h))).sum())
    off_u = np.abs(num_u / z - np.round(num_u / z))
    off_v = np.abs(num_v / z - np.round(num_v / z))
    least = min(off_u[~np.broadcast_to(on_u, off_u.shape)].min(), off_v[~np.broadcast_to(on_v, off_v.shape)].min())
    return corners, edges, least


@pytest.mark.parametrize("pool", [2, 4, 7, 8])
def test_pooled_insert_on_edge_aligned_pose_matches_reference(pool):
    corners, edges, least = _projections_on_edges(EDGE_DIMS, EDGE_SIDE, EDGE_INTR, (48, 64))
    assert min(corners.values()) > 0 and edges > 0 and least >= 1 / 64, (corners, edges, least)
    depth = _boundary_safe(edge_frame())
    pose = edge_pose()
    pts = trc.depth_image_to_point_cloud(torch.tensor(depth), *EDGE_INTR).numpy().astype(np.float64) + pose[:3, 3]
    f = pts[np.isfinite(pts).all(axis=1)] / EDGE_SIDE
    assert len(f) > 2000 and np.abs(f - np.round(f)).min() >= 1e-3
    n = EDGE_DIMS[0] * EDGE_DIMS[1] * EDGE_DIMS[2]
    data = np.random.default_rng(pool).integers(-128, 128, n).astype(np.int8)
    ref = jrc.insert_depth_image(jnp.asarray(data), jnp.asarray(depth), jnp.asarray(pose), *EDGE_INTR, EDGE_SIDE,
                                 EDGE_DIMS, carve_pool=pool)
    got = trc.insert_depth_image(torch.tensor(data), depth, pose, *EDGE_INTR, EDGE_SIDE, EDGE_DIMS, carve_pool=pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the carve moved voxels, and stayed inside the exact carve
    free = trc.projective_free_space_pooled(torch.tensor(depth), torch.tensor(pose), *EDGE_INTR, EDGE_SIDE, EDGE_DIMS,
                                            pool=pool)
    exact = trc.projective_free_space(torch.tensor(depth), torch.tensor(pose), *EDGE_INTR, EDGE_SIDE, EDGE_DIMS)
    assert int(free.sum()) > 1000 and not bool((free & ~exact).any())
