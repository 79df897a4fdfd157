"""Port conformance: the multi-device builders (parallel/sharded.py, the
sharded EDTs) against the reference on the same numpy inputs.

The port's mesh is 8 slabs on the CPU (`devices=["cpu"] * 8`), the
counterpart of the reference's 8-device virtual CPU mesh
(tests/conftest.py). The reference's own tests assert that its sharded
calls equal its single-device calls, so the port is held against the
reference's single-device functions, and against the reference's sharded
builders once, at the smallest shape, for the exact EDT and the sensor
cycle. Counts are exact; the exact EDT is bit-identical; the JFA gives
equal squared distances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.constants import PBA_UNINITIALISED_PACKED, float_to_probability
from gpu_voxels_tpu.geometry import generation
from gpu_voxels_tpu.maps import hierarchical as JH
from gpu_voxels_tpu.maps import paged as JP
from gpu_voxels_tpu.maps import voxellist as JL
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import edt as jedt
from gpu_voxels_tpu.ops import raycast as jray
from gpu_voxels_tpu_torch.maps import hierarchical as TH
from gpu_voxels_tpu_torch.maps import paged as TP
from gpu_voxels_tpu_torch.maps import voxellist as TL
from gpu_voxels_tpu_torch.ops import edt as tedt
from gpu_voxels_tpu_torch.ops import edt_envelope as tenv
from gpu_voxels_tpu_torch.ops import raycast as tray
from gpu_voxels_tpu_torch.parallel import (build_sharded_bit_cycle, build_sharded_cycle, build_sharded_hier_probe,
                                           build_sharded_list_collide, build_sharded_paged_probe,
                                           build_sharded_sensor_cycle, make_grid_mesh, sharded_collide_count)
from gpu_voxels_tpu_torch.parallel.sharded_edt import build_sharded_edt
from gpu_voxels_tpu_torch.parallel.sharded_edt_exact import build_sharded_parallel_banding


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


CPU8 = ["cpu"] * 8


def mesh(world=1):
    return make_grid_mesh(8, world=world, devices=CPU8)


def box(lo, hi, delta):
    return np.asarray(generation.create_box_of_points((lo,) * 3, (hi,) * 3, delta), np.float32)


def test_mesh_shape_and_round_robin_devices():
    m = make_grid_mesh(8, world=2, devices=CPU8)
    assert m.shape == {"world": 2, "z": 4} and m.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in m.devices.reshape(-1))
    assert make_grid_mesh(3, devices=["cpu"]).z_devices() == [torch.device("cpu")] * 3
    with pytest.raises(ValueError):
        make_grid_mesh(6, world=4, devices=CPU8)


def test_sharded_cycle_matches_single_device():
    dims = (32, 32, 32)
    p1, p2 = box(2.1, 20.1, 0.5), box(3.1, 21.1, 0.5)
    got = int(build_sharded_cycle(mesh(), dims, 1.0, 0.1)(torch.tensor(p1), torch.tensor(p2)))
    m1 = JProb.create(dims).insert_point_cloud(jnp.asarray(p1))
    m2 = JProb.create(dims).insert_point_cloud(jnp.asarray(p2))
    assert got == int(m1.collide_with(m2, 0.1)) > 0


def test_sharded_cycle_with_world_axis():
    dims = (16, 16, 16)
    p1, p2a = box(1.1, 8.1, 1.0), box(2.1, 9.1, 1.0)
    p2b = p2a + 100.0  # second scene: no overlap
    fn = build_sharded_cycle(mesh(world=2), dims, 1.0, 0.1)
    counts = fn(torch.tensor(np.stack([p1, p1])), torch.tensor(np.stack([p2a, p2b])))
    assert counts.shape == (2,) and counts.dtype == torch.int64
    m1 = JProb.create(dims).insert_point_cloud(jnp.asarray(p1))
    m2 = JProb.create(dims).insert_point_cloud(jnp.asarray(p2a))
    assert int(counts[0]) == int(m1.collide_with(m2, 0.1)) > 0
    assert int(counts[1]) == 0


def test_sharded_collide_presharded():
    rng = np.random.default_rng(0)
    a = rng.integers(-128, 128, 512).astype(np.int8)
    b = rng.integers(-128, 128, 512).astype(np.int8)
    m = mesh()
    got = int(sharded_collide_count(m, torch.tensor(a), torch.tensor(b), 0, 0))
    assert got == int(((a.astype(int) >= 0) & (b.astype(int) >= 0)).sum())
    slabs = list(torch.chunk(torch.tensor(a), 8))
    assert int(sharded_collide_count(m, slabs, torch.tensor(b), 0, 0)) == got


def test_sharded_edt_matches_single_device():
    """The sharded JFA's squared distances equal jump_flood_multires'
    (the port's, which test_torch_edt holds bit-identical to the
    reference's; compiling the reference's here would double this file's
    time)."""
    dims = (32, 32, 64)  # z over 8 slabs of 8
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(5)
    mask = np.zeros(n, bool)
    mask[rng.integers(0, n, 300)] = True
    packed = tedt.init_from_obstacle_mask(torch.tensor(mask), dims)
    fn = build_sharded_edt(mesh(), dims, coarse_factor=4, fine_steps=(8, 4, 2, 1, 1))
    sharded = torch.cat(fn(packed))
    d_sh = tedt.squared_distance_grid(sharded, dims).numpy()
    d_single = tedt.squared_distance_grid(tedt.jump_flood_multires(packed, dims), dims).numpy()
    np.testing.assert_array_equal(d_sh, d_single)
    exact = tedt.squared_distance_grid(tenv.parallel_banding(packed, dims), dims).numpy()
    assert (d_sh >= exact).all() and (d_sh == exact).mean() > 0.99
    with pytest.raises(ValueError):
        build_sharded_edt(mesh(), dims, fine_steps=(16, 1))  # a step past the slab depth


def test_sharded_edt_repairs_past_the_single_device_cap():
    """The sharded repair runs to its fixpoint, as the reference's
    while_loop does, where the single-device repair stops at 64 rounds.
    Two sites share a coarse block; the one nearer the block centre seeds
    the whole coarse grid, so the other's cell (x >= 3 along a 128-voxel
    grid) is repaired one voxel a round: ~109 rounds."""
    dims = (128, 4, 32)
    mask = np.zeros(dims[0] * dims[1] * dims[2], bool)
    mask[[1, 3]] = True
    packed = tedt.init_from_obstacle_mask(torch.tensor(mask), dims)
    steps = (8, 4, 2, 1, 1)
    d_sh = tedt.squared_distance_grid(
        torch.cat(build_sharded_edt(make_grid_mesh(4, devices=CPU8[:4]), dims, fine_steps=steps)(packed)), dims)
    exact = tedt.squared_distance_grid(tenv.parallel_banding(packed, dims), dims)
    assert torch.equal(d_sh, exact)
    capped, iters = tedt.jump_flood_multires_with_stats(packed, dims, fine_steps=steps)
    assert iters == 64 and not torch.equal(tedt.squared_distance_grid(capped, dims), exact)  # the cap binds
    fixpoint, iters = tedt.jump_flood_multires_with_stats(packed, dims, fine_steps=steps, max_iters=1000)
    assert 64 < iters < 1000
    assert torch.equal(tedt.squared_distance_grid(fixpoint, dims), d_sh)


SENSOR_INTR = (8.0, 8.0, 8.0, 6.0)


def _sensor_scene(seed, side, origin=(0.5, 16.0, 16.0)):
    rng = np.random.default_rng(seed)
    depth = (rng.uniform(5.0, 25.0, (12, 16)) * side).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    pose[:3, 3] = np.asarray(origin, np.float32) * np.float32(side)
    env = (rng.uniform(0, 32, (500, 3)) * side).astype(np.float32)
    return depth, pose, env


def _assert_off_boundaries(depth, pose, side, dims, margin=1e-3):
    """Every voxel centre in front of the camera projects at least `margin`
    pixel from a pixel boundary, every seen voxel lies at least `margin`
    voxel from its carve threshold (a float64 model of the projection), and
    every measurement lands at least `margin` voxel from a cell boundary
    (the f32 points the insert voxelizes): no voxel's decision rests on a
    rounding, where the reference's jitted and eager carves can differ
    (H4 / F4)."""
    from gpu_voxels_tpu_torch.geometry import transforms

    fx, fy, cx, cy = SENSOR_INTR
    dx, dy, dz = dims
    z, y, x = np.meshgrid(np.arange(dz), np.arange(dy), np.arange(dx), indexing="ij")
    centres = (np.stack([x, y, z], -1).reshape(-1, 3) + 0.5) * np.float64(np.float32(side))
    s = (centres - pose[:3, 3].astype(np.float64)) @ pose[:3, :3].astype(np.float64)
    s = s[s[:, 2] > 1e-6]
    u, v = fx * s[:, 0] / s[:, 2] + cx, fy * s[:, 1] / s[:, 2] + cy
    assert min(np.abs(u - np.round(u)).min(), np.abs(v - np.round(v)).min()) >= margin
    h, w = depth.shape
    seen = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d = depth[np.floor(v[seen]).astype(int), np.floor(u[seen]).astype(int)].astype(np.float64)
    assert np.abs(s[seen, 2] - (d - side)).min() >= margin * side
    pts = transforms.transform_points(torch.tensor(pose), tray.depth_image_to_point_cloud(torch.tensor(depth), fx, fy,
                                                                                         cx, cy)).numpy()
    q = pts * np.float32(1.0 / side)
    assert np.abs(q - np.round(q)).min() >= margin


def _ref_sensor_count(depth, pose, env_pts, side, dims, t):
    env = JProb.create(dims, side).insert_point_cloud(jnp.asarray(env_pts))
    new = jray.insert_depth_image(JProb.create(dims, side).data, jnp.asarray(depth), jnp.asarray(pose),
                                  *SENSOR_INTR, side, dims)
    count = int(((np.asarray(new).astype(int) >= t) & (np.asarray(env.data).astype(int) >= t)).sum())
    return count, env


def test_sharded_sensor_cycle_matches_single_device():
    """The port's sharded sensor cycle equals the reference's single-device
    eager insert + count and the reference's sharded builder."""
    from gpu_voxels_tpu.parallel import build_sharded_sensor_cycle as jbuild
    from gpu_voxels_tpu.parallel import make_grid_mesh as jmesh

    dims = (32, 32, 32)
    depth, pose, env_pts = _sensor_scene(7, 1.0)
    expect, env = _ref_sensor_count(depth, pose, env_pts, 1.0, dims, float_to_probability(0.25))
    fn = build_sharded_sensor_cycle(mesh(), dims, 1.0, *SENSOR_INTR, 0.25)
    got = int(fn(torch.tensor(depth), torch.tensor(pose), torch.tensor(np.asarray(env.data))))
    assert got == expect > 0
    ref_sharded = jbuild(jmesh(8), dims, 1.0, *SENSOR_INTR, 0.25)
    assert got == int(ref_sharded(jnp.asarray(depth), jnp.asarray(pose), env.data))


def test_sharded_sensor_cycle_fractional_side_length():
    """H4 / F4: at an f32-unrepresentable side length (0.05) the slab carve
    shifts integer z indices and keeps the pose, so the sharded count equals
    the single-device one. The camera sits off the voxel grid's symmetry
    (at (0.51, 15.695, 16.28) voxels), so every projection, threshold and
    measurement keeps 1e-3 from a boundary (asserted), where the
    reference's jitted and eager carves agree."""
    dims = (32, 32, 32)
    side = 0.05
    depth, pose, env_pts = _sensor_scene(11, side, origin=(0.51, 15.695, 16.28))
    _assert_off_boundaries(depth, pose, side, dims)
    expect, env = _ref_sensor_count(depth, pose, env_pts, side, dims, float_to_probability(0.25))
    fn = build_sharded_sensor_cycle(mesh(), dims, side, *SENSOR_INTR, 0.25)
    got = int(fn(torch.tensor(depth), torch.tensor(pose), torch.tensor(np.asarray(env.data))))
    assert got == expect > 0


@pytest.mark.parametrize("side", [1.0, 0.05])
def test_carve_z_index_offset_matches_reference_and_stacks(side):
    """projective_free_space(z_index_offset=z0) equals the reference's, and
    eight 4-deep slabs stacked equal the whole grid's mask."""
    dims = (24, 20, 32)
    rng = np.random.default_rng(3)
    depth = (rng.uniform(4.0, 30.0, (12, 16)) * side).astype(np.float32)
    depth[2:4, 3:6] = 0.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32)
    pose[:3, 3] = np.asarray([0.5, 10.2, 16.3], np.float32) * np.float32(side)
    td, tp = torch.tensor(depth), torch.tensor(pose)
    whole = tray.projective_free_space(td, tp, *SENSOR_INTR, side, dims)
    slabs = []
    for z0 in range(0, 32, 4):
        local = (24, 20, 4)
        got = tray.projective_free_space(td, tp, *SENSOR_INTR, side, local, z_index_offset=z0)
        want = jray.projective_free_space(jnp.asarray(depth), jnp.asarray(pose), *SENSOR_INTR, side, local,
                                          z_index_offset=z0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        slabs.append(got)
    np.testing.assert_array_equal(torch.cat(slabs).numpy(), whole.numpy())
    assert whole.any()


def test_sharded_bit_cycle_matches_single_device():
    dims = (16, 16, 32)
    rng = np.random.default_rng(3)
    pa = rng.uniform(0, 16, (300, 3)).astype(np.float32) * np.array([1, 1, 2], np.float32)
    pb = np.concatenate([pa[:90], rng.uniform(0, 16, (100, 3)).astype(np.float32)])
    got = int(build_sharded_bit_cycle(mesh(), dims, 1.0)(torch.tensor(pa), torch.tensor(pb)))
    a = JBit.create(dims).insert_point_cloud(jnp.asarray(pa))
    b = JBit.create(dims).insert_point_cloud(jnp.asarray(pb))
    assert got == int(a.collide_with(b)) > 0


def test_sharded_hier_probe_matches_single_device():
    dims = (16, 16, 64)
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 16, (200, 3)).astype(np.float32) * np.array([1, 1, 4], np.float32)
    qs = np.concatenate([np.stack([rng.integers(0, d, 256) for d in dims], axis=1),
                         np.floor(pts[:50]),
                         # past the grid: the single-device gather's rule (a
                         # negative index counts from the end, then clamps)
                         np.floor(pts[50:64]) + [0, 0, 64], np.floor(pts[64:78]) - [0, 0, 64],
                         np.floor(pts[78:82]) * [-1, 1, 1]]).astype(np.int32)
    jh = JH.HierarchicalBitMap.create(dims).insert_point_cloud(jnp.asarray(pts))
    occ, _, _ = jh.probe(jnp.asarray(qs))
    th = TH.HierarchicalBitMap.create(dims, device="cpu").insert_point_cloud(torch.tensor(pts))
    fn = build_sharded_hier_probe(mesh(), th.levels, th.padded_dims)
    got = int(fn(th.pyramid[0], tuple(th.pyramid[1:]), torch.tensor(qs)))
    assert got == int(np.asarray(occ).sum()) > 0


def test_sharded_paged_probe_matches_single_device():
    rng = np.random.default_rng(11)
    dims = (4096, 4096, 4096)
    pts = rng.uniform(0, 4096, (1500, 3)).astype(np.float32)
    qs = np.concatenate([rng.integers(0, 4096, (464, 3)), np.floor(pts[:48])]).astype(np.int32)  # 64 a slab
    jm = JP.PagedHierarchicalMap(dims, 1.0)
    jm.insert_point_cloud(jnp.asarray(pts))
    e_occ, e_unk = jm.collide_with_counting_unknown_coords(jnp.asarray(qs))
    tm = TP.PagedHierarchicalMap(dims, 1.0, device="cpu").insert_point_cloud(torch.tensor(pts))
    occ, unk = build_sharded_paged_probe(mesh())(tm.snapshot(), torch.tensor(qs))
    assert int(occ) == int(e_occ) > 0 and int(unk) == int(e_unk) > 0
    with pytest.raises(ValueError):
        build_sharded_paged_probe(mesh())(tm.snapshot(), torch.tensor(qs[:-1]))


def test_sharded_list_collide_matches_single_device():
    rng = np.random.default_rng(12)
    dims = (64, 64, 64)
    pa = rng.uniform(0, 64, (300, 3)).astype(np.float32)
    pb = np.concatenate([pa[:80], rng.uniform(0, 64, (150, 3)).astype(np.float32)])
    fn = build_sharded_list_collide(mesh())
    for id_mode in ("linear", "morton"):
        ja = JL.VoxelList.create(dims, 1.0, capacity=512, id_mode=id_mode).insert_point_cloud(
            jnp.asarray(pa), grow=False)
        jb = JL.VoxelList.create(dims, 1.0, capacity=512, id_mode=id_mode).insert_point_cloud(
            jnp.asarray(pb), grow=False)
        ta = TL.VoxelList.create(dims, 1.0, capacity=512, id_mode=id_mode, device="cpu").insert_point_cloud(
            torch.tensor(pa), grow=False)
        tb = TL.VoxelList.create(dims, 1.0, capacity=512, id_mode=id_mode, device="cpu").insert_point_cloud(
            torch.tensor(pb), grow=False)
        assert int(fn(ta, tb)) == int(ja.collide_with(jb)) > 0, id_mode


def test_sharded_exact_edt_bit_identical():
    """The sharded exact EDT equals, bit for bit, the port's single-device
    parallel_banding (held bit-identical to the reference's in
    test_torch_edt) and the reference's sharded builder; an empty grid
    stays uninitialised everywhere."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpu_voxels_tpu.parallel import make_grid_mesh as jmesh
    from gpu_voxels_tpu.parallel.sharded_edt_exact import build_sharded_parallel_banding as jbuild

    dims = (16, 32, 64)  # slabs of 8
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(7)
    mask = np.zeros(n, bool)
    mask[rng.integers(0, n, 200)] = True
    packed = tedt.init_from_obstacle_mask(torch.tensor(mask), dims)
    fn = build_sharded_parallel_banding(mesh(), dims, bound_c=8)
    slabs = fn(packed)
    assert len(slabs) == 8 and all(s.shape == (n // 8,) for s in slabs)
    got = torch.cat(slabs).numpy()
    np.testing.assert_array_equal(got, tenv.parallel_banding(packed, dims).numpy())
    jpacked = jedt.init_from_obstacle_mask(jnp.asarray(mask), dims)
    jm = jmesh(8)
    ref_sharded = jbuild(jm, dims, bound_c=8)(jax.device_put(jpacked, NamedSharding(jm, P("z"))))
    np.testing.assert_array_equal(got, np.asarray(ref_sharded))

    empty = tedt.init_from_obstacle_mask(torch.zeros(n, dtype=torch.bool), dims)
    assert all((s == PBA_UNINITIALISED_PACKED).all() for s in fn(list(torch.chunk(empty, 8))))
    for bad in ((16, 32, 60), (16, 32, 32)):  # 60 % 8; 4-deep slabs under bound_c 8
        with pytest.raises(ValueError):
            build_sharded_parallel_banding(mesh(), bad, bound_c=8)
