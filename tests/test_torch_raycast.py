"""Port conformance: the exact projective carve (kernel K3's spec) and
depth-image fusion.

The carve masks of gpu_voxels_tpu_torch must equal, bit for bit, the JAX
spec `raycast.projective_free_space` and the Pallas kernel
`projective_free_space_exact_tpu` run in interpret mode, on the fixtures of
tests/test_raycast.py. Fused int8 maps must be equal too. They are held
against the reference's frame update run op by op (`raycast.insert_depth_image`
called eagerly), which evaluates the spec's expressions as written: jitted
on the CPU, XLA rewrites the division by the static fx into a multiply by
its reciprocal and re-rounds the projection, which moves points by an ulp
and flips voxels whose centre projects within ~1e-5 px of a pixel edge. The
fixtures keep every measured point at least 1e-3 voxel from a cell
boundary, so the transform's summation order cannot move a hit either. K3
itself is checked on a card by tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import sensors as jsens
from gpu_voxels_tpu.geometry import transforms as jtf
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import raycast as jrc
from gpu_voxels_tpu.ops import raycast_pallas as jrp
from gpu_voxels_tpu_torch import sensors as tsens
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
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


DIMS = (64, 64, 64)
INTR = (52.0, 52.0, 32.0, 24.0)


def _scenes():
    """tests/test_raycast.py:183-207 and :234-238 (64^3, 64x48 frames)."""
    rng = np.random.default_rng(7)
    d1 = np.full((48, 64), 40.0, np.float32)
    d1[:, 32:] = 20.0  # step edge
    d1[10:14, 5:9] = 0.0  # invalid patch
    d1[30:34, :] += rng.uniform(-5, 5, (4, 64)).astype(np.float32)  # noisy rows
    d2 = rng.uniform(5, 60, (48, 64)).astype(np.float32)  # every cell ambiguous
    d2[d2 < 6] = 0.0
    p = np.eye(4, dtype=np.float32)
    p[:3, 3] = [32, 32, 1]
    th = 0.4
    rot = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)], [0, np.sin(th), np.cos(th)]], np.float32)
    p2 = np.eye(4, dtype=np.float32)
    p2[:3, :3] = rot
    p2[:3, 3] = [20, 45, 3]
    d3 = np.random.default_rng(9).uniform(5, 60, (48, 64)).astype(np.float32)
    d3[8:40, 16:48] = 0.0  # big invalid block
    return {"step_axis": (d1, p), "step_tilted": (d1, p2), "noise_axis": (d2, p),
            "noise_tilted": (d2, p2), "invalid_beam": (d3, p)}


@pytest.mark.parametrize("scene", ["step_axis", "step_tilted", "noise_axis", "noise_tilted", "invalid_beam"])
def test_carve_matches_spec_and_pallas_interpret(scene):
    depth, pose = _scenes()[scene]
    got = raycast_cuda.projective_free_space_exact(torch.tensor(depth), torch.tensor(pose), *INTR, 1.0, DIMS)
    spec = np.asarray(jrc.projective_free_space(jnp.asarray(depth), jnp.asarray(pose), *INTR, 1.0, DIMS))
    pallas = np.asarray(jrp.projective_free_space_exact_tpu(jnp.asarray(depth), jnp.asarray(pose), *INTR, 1.0, DIMS))
    assert got.dtype == torch.bool and got.shape == (64**3,)
    np.testing.assert_array_equal(got.numpy(), spec)
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert spec.sum() > 0


def test_carve_far_projections_stay_outside():
    """A camera behind and beside the grid: projections far outside the
    image (clamped before the int cast) must carve nothing spurious."""
    depth = np.full((48, 64), 30.0, np.float32)
    pose = np.asarray(jtf.from_rpy(np.asarray([0.0, 1.45, 0.3], np.float32), np.asarray([-5.0, 30.0, 70.0], np.float32), xp=np))
    got = trc.projective_free_space(torch.tensor(depth), torch.tensor(pose), 520.0, 1e7, 32.0, 24.0, 1.0, DIMS)
    spec = jrc.projective_free_space(jnp.asarray(depth), jnp.asarray(pose), 520.0, 1e7, 32.0, 24.0, 1.0, DIMS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(spec))


def _boundary_safe(depth, pose, side, intr, margin=2e-3):
    """Mark invalid (0) every pixel whose world point lies within `margin`
    voxel of a cell boundary (float64 pinhole model)."""
    fx, fy, cx, cy = intr
    h, w = depth.shape
    u = np.arange(w, dtype=np.float64)[None, :]
    v = np.arange(h, dtype=np.float64)[:, None]
    z = depth.astype(np.float64)
    pts = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], axis=-1).reshape(-1, 3)
    world = pts @ pose[:3, :3].astype(np.float64).T + pose[:3, 3]
    f = world / side
    near = (np.abs(f - np.round(f)) < margin).any(axis=1).reshape(h, w)
    out = depth.copy()
    out[near] = 0.0
    return out


def _min_boundary_distance(points, side):
    p = np.asarray(points, np.float64)
    p = p[np.isfinite(p).all(axis=1)] / side
    return float(np.min(np.abs(p - np.round(p))))


def test_insert_depth_image_matches_reference_maps():
    """Three frames through the port's ProbVoxelMap.insert_depth_image and
    the reference's frame update (hits +72, carve -10, clamp): the int8 maps
    must be equal."""
    side = 0.05
    sensor_kw = dict(
        position=np.asarray([1.6, 1.55, 0.05], np.float32),
        orientation_rpy=np.asarray([0.05, -0.03, 0.02], np.float32),
        data_width=64, data_height=48, fx=52.0, fy=52.0, cx=32.0, cy=24.0,
    )
    jsensor, tsensor = jsens.Sensor(**sensor_kw), tsens.Sensor(**sensor_kw)
    np.testing.assert_array_equal(tsensor.pose(), jsensor.pose())
    rng = np.random.default_rng(11)
    jdata, tmap = JProb.create(DIMS, side).data, TProb.create(DIMS, side, device="cpu")
    for frame in range(3):
        depth = np.full((48, 64), 2.4 + 0.05 * frame, np.float32)
        depth[10:30, 20:44] = 1.3  # a box in front of the wall
        depth[40:46, 2:9] = 0.0  # invalid patch
        depth += rng.normal(0, 0.01, depth.shape).astype(np.float32)
        depth = _boundary_safe(depth, tsensor.pose(), side, INTR)
        pts = np.asarray(jsensor.process_depth_image(depth))
        assert _min_boundary_distance(pts, side) >= 1e-3
        assert _min_boundary_distance(tsensor.process_depth_image(depth, device="cpu").numpy(), side) >= 1e-3
        jdata = jrc.insert_depth_image(
            jdata, jnp.asarray(depth), jnp.asarray(jsensor.pose()), *INTR, side, DIMS
        )
        tmap = tmap.insert_depth_image(depth, tsensor)
        np.testing.assert_array_equal(tmap.data.numpy(), np.asarray(jdata), err_msg=f"frame {frame}")
    data = tmap.data.numpy()
    assert (data > 0).sum() > 500 and (data < -127).sum() > 0 and ((data < 0) & (data > -128)).sum() > 1000


def test_point_cloud_and_ops_insert_depth_image():
    """The back-projection (eager, IEEE division in both) and the op-level
    frame update with a robot cut-out."""
    depth, pose = _scenes()["step_tilted"]
    got = trc.depth_image_to_point_cloud(torch.tensor(depth), *INTR)
    ref = jrc.depth_image_to_point_cloud(jnp.asarray(depth), *INTR)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    n = DIMS[0] * DIMS[1] * DIMS[2]
    data = np.random.default_rng(2).integers(-128, 128, n).astype(np.int8)
    robot = np.zeros(n, bool)
    robot[n // 3 : n // 2] = True
    safe = _boundary_safe(depth, pose, 1.0, INTR)
    ref = jrc.insert_depth_image(jnp.asarray(data), jnp.asarray(safe), jnp.asarray(pose), *INTR, 1.0, DIMS,
                                 cut_real_robot=True, robot_occupied_mask=jnp.asarray(robot))
    got = trc.insert_depth_image(torch.tensor(data), safe, pose, *INTR, 1.0, DIMS,
                                 cut_real_robot=True, robot_occupied_mask=torch.tensor(robot))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the pooled carve (K6's spec): dx = 64 is not a multiple of 128, so the
    # reference runs its XLA spec, projective_free_space_pooled
    for pool in (4, 8):
        ref = jrc.insert_depth_image(jnp.asarray(data), jnp.asarray(safe), jnp.asarray(pose), *INTR, 1.0, DIMS,
                                     cut_real_robot=True, robot_occupied_mask=jnp.asarray(robot), carve_pool=pool)
        got = trc.insert_depth_image(torch.tensor(data), safe, pose, *INTR, 1.0, DIMS,
                                     cut_real_robot=True, robot_occupied_mask=torch.tensor(robot), carve_pool=pool)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=f"carve_pool={pool}")


def _kinect_frame():
    """640x480 depth with step edges, noise and an invalid patch."""
    rng = np.random.default_rng(0)
    depth = np.full((480, 640), 4.0, np.float32)
    depth[100:300, 200:450] = 2.5
    depth[350:460, 50:250] = 1.8
    depth += rng.normal(0, 0.003, depth.shape).astype(np.float32)
    depth[20:60, 560:620] = 0.0
    return depth


def _row_kernel_order(depth, pose, fx, fy, cx, cy, side, dims, hoist_sum):
    """The exact carve in the order of K3's row kernel (csrc/carve_exact.cu,
    carve_projection.cuh): per (y, z) row the six products with wy and wz
    once, per voxel the sums in the spec's order (r00 * wx + r01 * wy) +
    r02 * wz. With `hoist_sum` the row's two products are added first,
    r00 * wx + (r01 * wy + r02 * wz): the hoisting the kernel must not do."""
    from gpu_voxels_tpu_torch.ops.insert import floor_to_int32

    dx, dy, dz = dims
    h, w = depth.shape
    side = torch.tensor(np.float32(side))
    rot_t, origin = pose[:3, :3].T, pose[:3, 3]
    wy = (torch.arange(dy, dtype=torch.float32).view(1, dy, 1) + 0.5) * side - origin[1]
    wz = (torch.arange(dz, dtype=torch.float32).view(dz, 1, 1) + 0.5) * side - origin[2]
    row = [(rot_t[i, 1] * wy, rot_t[i, 2] * wz) for i in range(3)]  # each [*, dy, 1] x [dz, *, 1]
    wx = (torch.arange(dx, dtype=torch.float32).view(1, 1, dx) + 0.5) * side - origin[0]
    if hoist_sum:
        sx, sy, sz = (rot_t[i, 0] * wx + (row[i][0] + row[i][1]) for i in range(3))
    else:
        sx, sy, sz = ((rot_t[i, 0] * wx + row[i][0]) + row[i][1] for i in range(3))
    in_front = sz > 1e-6
    safe_z = torch.where(in_front, sz, 1.0)
    u = floor_to_int32(fx * sx / safe_z + cx)
    v = floor_to_int32(fy * sy / safe_z + cy)
    seen = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d = depth.reshape(-1)[v.clamp(0, h - 1).to(torch.int64) * w + u.clamp(0, w - 1).to(torch.int64)]
    eps = float(np.float32(1.0) * np.float32(side))
    return (seen & (d != 0.0) & (sz < d - eps)).reshape(-1), (sx, sy, sz)


def test_row_kernel_order_is_the_spec_bit_for_bit():
    """K3's hoisting (row products once, per-voxel sums in the spec's order)
    gives the spec's mask bit for bit at 64^3 over a 5.12 m cube under the
    card smoke run's three poses. Hoisting a sum instead moves camera-frame
    coordinates by an ulp in many voxels of the rotated poses, which is what
    separates the two orders here; at 64^3 none of those ulps crosses a pixel
    edge or the depth threshold, so these masks alone would not tell them
    apart (at 256^3 on a card K3 is held to the spec's mask bit for bit)."""
    from gpu_voxels_tpu_torch.geometry import transforms as ttf

    bench = np.eye(4, dtype=np.float32)
    bench[:3, 3] = [2.56, 2.56, 0.1]
    poses = {
        "bench": bench,
        "tilted": ttf.from_rpy_np([0.3, -0.2, 0.1], [2.0, 2.8, 0.3]),
        "inside": ttf.from_rpy_np([0.05, 0.1, 0.0], [2.56, 2.56, 2.56]),  # half the grid behind the camera
    }
    depth = torch.tensor(_kinect_frame())
    intr, side = (525.0, 525.0, 320.0, 240.0), 0.08
    moved = {}
    for name, pose in poses.items():
        pose = torch.tensor(np.asarray(pose, np.float32))
        spec = trc.projective_free_space(depth, pose, *intr, side, DIMS)
        got, coords = _row_kernel_order(depth, pose, *intr, side, DIMS, hoist_sum=False)
        assert 0 < int(spec.sum()) < spec.numel(), name
        assert torch.equal(got, spec), name
        hoisted, hoisted_coords = _row_kernel_order(depth, pose, *intr, side, DIMS, hoist_sum=True)
        moved[name] = (sum(int((a != b).sum()) for a, b in zip(coords, hoisted_coords)),
                       int((hoisted != spec).sum()))
    # the axis-aligned pose has one non-zero product per sum, so nothing can
    # move there; under a rotation a hoisted sum rounds differently
    assert moved["bench"] == (0, 0), moved
    assert moved["tilted"][0] > 0 and moved["inside"][0] > 0, moved
