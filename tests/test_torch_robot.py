"""Port conformance of the robot modules: bit shifts and margin checks,
DH transforms and chains, the UR presets, meta inserts, bit maintenance and
the facade's robot calls.

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch on the CPU. Integer contracts (bit vectors, maps,
counts) must be equal; forward kinematics differs between the frameworks
by ulps (F4), so FK points are held with rtol 1e-6 and atol 1e-6, and maps
built from FK points use fixtures at least 1e-3 voxel from cell boundaries.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import bitops as jbit
from gpu_voxels_tpu.api import GpuVoxels as JGvl
from gpu_voxels_tpu.constants import SV_START, BitVoxelMeaning, MapType
from gpu_voxels_tpu.geometry import transforms as jtf
from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.robot import presets as jpresets
from gpu_voxels_tpu.robot.dh import DHParameters as JDH
from gpu_voxels_tpu.robot.dh import KinematicChain as JChain
from gpu_voxels_tpu_torch import bitops as tbit
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.geometry import transforms as ttf
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
from gpu_voxels_tpu_torch.geometry.pointcloud import PointCloud
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.robot import presets as tpresets
from gpu_voxels_tpu_torch.robot.dh import DHJointType, DHParameters
from gpu_voxels_tpu_torch.robot.robot import interpolate_linear


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


FK_TOL = dict(rtol=1e-6, atol=1e-6)


def _words(rng, n, zero_p=0.0):
    """uint32[8, n] random words; bit 31 set in the first voxels' words."""
    w = rng.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
    w[:, :4] |= np.uint32(1 << 31)
    return w * (rng.random(n) >= zero_p).astype(np.uint32)


def _t(w):
    return torch.tensor(np.ascontiguousarray(w).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _min_boundary_distance(points, side):
    f = np.asarray(points, np.float64) / side
    return np.abs(f - np.round(f)).min()


def test_shift_bits_and_left_shift_match_reference():
    """Masked logical shifts on int32 views (F1): words with bit 31 set."""
    rng = np.random.default_rng(0)
    w = _words(rng, 257)
    for k in (1, -1, 4, -4, 31, -31, 32, -32, 33, -33, 70, -70):
        np.testing.assert_array_equal(_u32(tbit.shift_bits(_t(w), k)), np.asarray(jbit.shift_bits(jnp.asarray(w), k)), k)
    for s in range(57):
        np.testing.assert_array_equal(
            _u32(tbit.perform_left_shift(_t(w), s)), np.asarray(jbit.perform_left_shift(jnp.asarray(w), s)), s
        )
    for s in (-1, 57):
        with pytest.raises(ValueError):
            tbit.perform_left_shift(_t(w), s)


def test_margin_check_packed_matches_reference():
    rng = np.random.default_rng(1)
    v1, v2 = _words(rng, 300, 0.3), _words(rng, 300, 0.3)
    for margin in list(range(25)) + [25, 31]:  # past 24 the full-domain form, as in the reference
        hit, coll = tbit.bit_margin_collision_check_packed(_t(v1), _t(v2), margin)
        jhit, jcoll = jbit.bit_margin_collision_check_packed(jnp.asarray(v1), jnp.asarray(v2), margin)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit), margin)
        np.testing.assert_array_equal(_u32(coll), np.asarray(jcoll), margin)


@pytest.mark.parametrize("margin", [0, 5, 31])
def test_margin_check_full_matches_reference_and_byte_oracle(margin):
    """Every quirk of the reference's 64-bit buffer: against the packed
    reference and, voxel by voxel, the byte-level oracle of BitVector.h."""
    rng = np.random.default_rng(2 + margin)
    n = 40
    v1, v2, coll = _words(rng, n), _words(rng, n), _words(rng, n)
    v1[:, :20] &= _words(rng, 20)  # sparser voxels too
    for sv_offset in (0, 3, 4, 9, 17):
        hit, out = tbit.bit_margin_collision_check_packed_full(_t(v1), _t(v2), _t(coll), margin, sv_offset)
        jhit, jout = jbit.bit_margin_collision_check_packed_full(
            jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(coll), margin, sv_offset
        )
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        np.testing.assert_array_equal(_u32(out), np.asarray(jout))
        got = _u32(out)
        for i in range(n):
            as_bytes = [np.ascontiguousarray(x[:, i]).view(np.uint8) for x in (v1, v2, coll)]
            ohit, ocoll = jbit.bit_margin_collision_check_np(*as_bytes, margin, sv_offset)
            np.testing.assert_array_equal(np.ascontiguousarray(got[:, i]).view(np.uint8), ocoll, (sv_offset, i))
            assert bool(hit[i]) == bool(ohit)
    with pytest.raises(ValueError):
        tbit.bit_margin_collision_check_packed_full(_t(v1), _t(v2), _t(coll), 32, 0)


def test_or_reduce_matches_reference():
    rng = np.random.default_rng(3)
    for shape in ((1,), (7,), (1000,), (5, 33)):
        w = rng.integers(0, 2**32, (8,) + shape, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(_u32(tbit.or_reduce(_t(w), 0)), np.asarray(jbit.or_reduce(jnp.asarray(w), 0)))
    assert tbit.or_reduce_words(torch.zeros((8, 0), dtype=torch.int32)).tolist() == [0] * 8


def test_dh_matrix_matches_reference():
    rng = np.random.default_rng(4)
    for jt in (DHJointType.REVOLUTE, DHJointType.PRISMATIC):
        for _ in range(5):
            d, theta, a, alpha, v = (float(x) for x in rng.uniform(-2, 2, 5))
            ref = np.asarray(jtf.dh_matrix(d, theta, a, alpha, v, int(jt)))
            got = ttf.dh_matrix(d, theta, a, alpha, v, int(jt), device="cpu")
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, **FK_TOL)
        values = rng.uniform(-3, 3, 6).astype(np.float32)  # a batch of joint values
        batch = ttf.dh_matrix(0.3, 0.1, -0.5, 1.2, torch.tensor(values), int(jt))
        assert batch.shape == (6, 4, 4)
        for v, m in zip(values, batch):
            np.testing.assert_allclose(m.numpy(), np.asarray(jtf.dh_matrix(0.3, 0.1, -0.5, 1.2, v, int(jt))), **FK_TOL)


def _ur_pair(model="ur10", spacing=0.05):
    return jpresets.ur_robot(model, spacing), tpresets.ur_robot(model, spacing, device="cpu")


def test_ur_presets_byte_equal_and_fk_matches_reference():
    for model in ("ur3", "ur5", "ur10"):
        jarm, tarm = _ur_pair(model)
        np.testing.assert_array_equal(tarm.clouds.points.numpy(), np.asarray(jarm.clouds.points))
        np.testing.assert_array_equal(tarm.clouds.cloud_ids.numpy(), np.asarray(jarm.clouds.cloud_ids))
        assert tarm.clouds.offsets == jarm.clouds.offsets and tarm.clouds.names == jarm.clouds.names
        assert tarm.get_joint_names() == jarm.get_joint_names()
        assert tarm.get_lower_joint_limits() == jarm.get_lower_joint_limits()
    rng = np.random.default_rng(5)
    cfg = {n: float(v) for n, v in zip(jarm.get_joint_names(), rng.uniform(-2, 2, 7))}
    jarm.set_configuration(cfg)
    tarm.set_configuration(cfg)
    assert tarm.get_configuration() == jarm.get_configuration()
    np.testing.assert_allclose(
        tarm.get_transformed_clouds().points.numpy(), np.asarray(jarm.get_transformed_clouds().points), **FK_TOL
    )
    # [T, n_links] -> [T, num_clouds, 4, 4]: the batch the reference vmaps
    traj = rng.uniform(-2, 2, (4, 7)).astype(np.float32)
    mats = tarm.link_matrices(torch.tensor(traj))
    assert mats.shape == (4, 7, 4, 4)
    pts = tarm.transformed_clouds_for(torch.tensor(traj)).points
    for t in range(4):
        np.testing.assert_allclose(mats[t].numpy(), np.asarray(jarm.link_matrices(jnp.asarray(traj[t]))), **FK_TOL)
        np.testing.assert_allclose(
            pts[t].numpy(), np.asarray(jarm.transformed_clouds_for(jnp.asarray(traj[t])).points), **FK_TOL
        )
    # update_point_cloud, same size and resized
    seg = np.asarray(jarm.clouds.get_cloud(2)) * 0.5
    jarm.update_point_cloud("elbow_joint", seg)
    tarm.update_point_cloud("elbow_joint", seg)
    np.testing.assert_allclose(
        tarm.get_transformed_clouds().points.numpy(), np.asarray(jarm.get_transformed_clouds().points), **FK_TOL
    )
    jarm.update_point_cloud("elbow_joint", seg[:10])
    tarm.update_point_cloud("elbow_joint", seg[:10])
    assert tarm.clouds.offsets == jarm.clouds.offsets
    assert interpolate_linear({"a": 0.0, "b": 2.0}, {"a": 1.0, "b": 4.0}, 0.5) == {"a": 0.5, "b": 3.0}


def test_interop_builds_the_same_chain():
    """A robot's state (DH table plus link clouds) carried over from the reference."""
    jarm = jpresets.ur_robot("ur5", 0.06)
    jarm.set_configuration({"elbow_joint": 0.7})
    c = jarm.clouds
    tarm = interop.kinematic_chain_from_numpy(
        jarm.link_names,
        [(p.d, p.theta, p.a, p.alpha, p.value) for p in jarm.dh.values()],
        [int(p.joint_type) for p in jarm.dh.values()],
        np.asarray(c.points), np.asarray(c.cloud_ids), c.offsets, c.names,
        jarm.get_lower_joint_limits(), jarm.get_upper_joint_limits(), device="cpu",
    )
    tarm.set_configuration(jarm.get_configuration())
    np.testing.assert_allclose(
        tarm.get_transformed_clouds().points.numpy(), np.asarray(jarm.get_transformed_clouds().points), **FK_TOL
    )
    with pytest.raises(ValueError):
        interop.meta_point_cloud_from_numpy(np.zeros((3, 3), np.float64), [0, 0, 0], (0, 3), ("a",), "cpu")


def _safe_arm(side, cfg, base=(1.5, 1.5, 1.5)):
    """The UR10 at 0.08 m spacing behind a fixed DH base link that puts its
    first frame at `base`, with the link-cloud points that land, at `cfg`,
    at least 2e-3 voxel from every cell boundary (FK ulps must not flip a
    voxel): (links, DH parameters, clouds) for each package."""
    arm = jpresets.ur_robot("ur10", 0.08)
    links = ["base"] + arm.link_names
    row = dict(d=base[2], theta=np.pi / 4, a=float(np.hypot(base[0], base[1])), alpha=0.0)
    jparams = [JDH(**row)] + list(arm.dh.values())
    full = JChain(links, jparams, arm.clouds)
    full.set_configuration(cfg)
    f = np.asarray(full.get_transformed_clouds().points).astype(np.float64) / side
    keep = (np.abs(f - np.round(f)) >= 2e-3).all(axis=1)
    pts = np.asarray(arm.clouds.points)
    offs = arm.clouds.offsets
    clouds = [pts[lo:hi][keep[lo:hi]] for lo, hi in zip(offs, offs[1:])]
    tparams = [DHParameters(p.d, p.theta, p.a, p.alpha) for p in jparams]
    return ((links, jparams, JMeta.from_clouds(clouds, arm.clouds.names)),
            (links, tparams, TMeta.from_clouds(clouds, arm.clouds.names, device="cpu")))


def test_facade_robot_calls_match_reference():
    dims, side = (64, 64, 64), 0.05
    cfg = {"shoulder_pan_joint": 0.4, "shoulder_lift_joint": -0.9, "elbow_joint": 1.1, "wrist_1_joint": 0.2}
    jargs, targs = _safe_arm(side, cfg)
    jg, tg = JGvl(), TGvl()
    jg.initialize(*dims, side)
    tg.initialize(*dims, side, device="cpu")
    for g, args in ((jg, jargs), (tg, targs)):
        g.add_map(MapType.MT_BITVECTOR_VOXELMAP, "bits")
        g.add_map(MapType.MT_PROBAB_VOXELMAP, "prob")
        g.add_robot_dh("ur10", *args)
        g.set_robot_configuration("ur10", cfg)
        g.insert_robot_into_map("ur10", "bits", BitVoxelMeaning.eBVM_OCCUPIED)
        g.insert_robot_into_map("ur10", "bits", BitVoxelMeaning.eBVM_COLLISION)
        g.insert_meta_point_cloud_into_map(g.get_robot("ur10").get_transformed_clouds(), "bits",
                                           [SV_START + i for i in range(7)])
    assert tg.get_robot_configuration("ur10") == jg.get_robot_configuration("ur10")
    assert int(tg.get_map("bits").occ.sum()) > 20
    jclash = jg.insert_robot_into_map_self_collision_aware("ur10", "prob")
    tclash = tg.insert_robot_into_map_self_collision_aware("ur10", "prob")
    assert tclash.dtype == torch.bool and bool(tclash) == bool(jclash)

    def same(name):
        if name == "prob":
            np.testing.assert_array_equal(tg.get_map(name).data.numpy(), np.asarray(jg.get_map(name).data))
        else:
            planes, occ = interop.to_numpy(tg.get_map(name))
            np.testing.assert_array_equal(planes, np.asarray(jg.get_map(name).data))
            np.testing.assert_array_equal(occ, np.asarray(jg.get_map(name).occ))

    same("bits")
    same("prob")
    for g in (jg, tg):
        g.clear_map("bits", BitVoxelMeaning.eBVM_COLLISION)
        g.clear_map("prob", BitVoxelMeaning.eBVM_OCCUPIED)
    same("bits")
    same("prob")
    assert not tg.get_map("bits").get_bit_mask(BitVoxelMeaning.eBVM_COLLISION).any()
    cloud = PointCloud.from_numpy([[0.52, 0.53, 0.54]], device="cpu")
    tg.insert_point_cloud_into_map(cloud, "bits", SV_START)
    assert bool(tg.get_map("bits").get_bit_mask(SV_START)[10 * 64 * 64 + 10 * 64 + 10])
    tg.add_robot_object("again", tg.get_robot("ur10"))
    assert tg.get_robot("again") is tg.get_robot("ur10")
    tg.update_robot_part("ur10", "tool0", np.zeros((4, 3), np.float32))
    arm = tg.get_robot("ur10")
    assert arm.clouds.cloud_size(arm.clouds.cloud_index("tool0")) == 4
    assert arm.get_transformed_clouds().points.shape == (arm.clouds.accumulated_size, 3)
    # URDF robots (item 12): the pan/tilt unit's link cloud through FK, as the reference's
    urdf = Path(__file__).resolve().parent.parent / "examples" / "models" / "pan_tilt.urdf"
    jg.add_robot("pt", urdf)
    tg.add_robot("pt", urdf)
    for g in (jg, tg):
        g.set_robot_configuration("pt", {"pan_joint": 0.3, "tilt_joint": -0.2})
    np.testing.assert_allclose(tg.get_robot("pt").get_transformed_clouds().points.numpy(),
                               np.asarray(jg.get_robot("pt").get_transformed_clouds().points), rtol=1e-6, atol=1e-6)


def test_prob_meta_insert_later_subcloud_wins():
    dims, side = (16, 16, 16), 0.1
    rng = np.random.default_rng(6)
    base = rng.uniform(0.0, 1.6, (300, 3)).astype(np.float32)
    clouds = [base[:150], base[100:250], base[200:], np.asarray([[9.0, 9.0, 9.0]], np.float32)]  # overlaps, one out of map
    meanings = [BitVoxelMeaning.eBVM_OCCUPIED, BitVoxelMeaning.eBVM_FREE, SV_START + 3, BitVoxelMeaning.eBVM_OCCUPIED]
    jm, tm = JMeta.from_clouds(clouds), TMeta.from_clouds(clouds, device="cpu")
    start = JProb.create(dims, side).insert_point_cloud(rng.uniform(0, 1.6, (200, 3)).astype(np.float32))
    tstart = interop.prob_map_from_numpy(np.asarray(start.data), dims, side, "cpu")
    ref = start.insert_meta_point_cloud(jm, meanings)
    got = tstart.insert_meta_point_cloud(tm, meanings)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    np.testing.assert_array_equal(
        tstart.insert_meta_point_cloud(tm).data.numpy(), np.asarray(start.insert_meta_point_cloud(jm).data)
    )
    jb = JBit.create(dims, side).insert_meta_point_cloud(jm, [int(m) for m in meanings])
    tb = TBit.create(dims, side, device="cpu").insert_meta_point_cloud(tm, [int(m) for m in meanings])
    np.testing.assert_array_equal(_u32(tb.data), np.asarray(jb.data))
    np.testing.assert_array_equal(tb.occ.numpy(), np.asarray(jb.occ))


def test_self_collision_clash_and_robot_configuration_match_reference():
    dims = (4, 4, 4)
    overlapping = [[[1.5, 1.5, 1.5]], [[1.5, 1.5, 1.5]]]
    separate = [[[1.5, 1.5, 1.5], [1.6, 1.5, 1.5]], [[2.5, 2.5, 2.5]]]  # a duplicate within one cloud never clashes
    for clouds in (overlapping, separate):
        jm, tm = JMeta.from_clouds(clouds), TMeta.from_clouds(clouds, device="cpu")
        _, jclash = JProb.create(dims).insert_meta_point_cloud_with_self_collision_check(jm)
        tnew, tclash = TProb.create(dims, device="cpu").insert_meta_point_cloud_with_self_collision_check(tm)
        assert bool(tclash) == bool(jclash)
        for jmap, tmap in ((JProb.create(dims), TProb.create(dims, device="cpu")),
                           (JBit.create(dims), TBit.create(dims, device="cpu"))):
            for test in (False, True):
                jn, jok = jmap.insert_robot_configuration(jm, test)
                tn, tok = tmap.insert_robot_configuration(tm, test)
                assert tok.dtype == torch.bool and bool(tok) == bool(jok)
                ref = np.asarray(jn.data)
                np.testing.assert_array_equal(tn.data.numpy().view(ref.dtype), ref)
    assert bool(TProb.create(dims, device="cpu").insert_meta_point_cloud_with_self_collision_check(
        TMeta.from_clouds(overlapping, device="cpu"))[1])


def test_bit_maintenance_matches_reference():
    dims, side = (12, 10, 8), 0.1
    rng = np.random.default_rng(7)
    pts = [rng.uniform(0, 0.8, (150, 3)).astype(np.float32) for _ in range(4)]
    jm, tm = JBit.create(dims, side), TBit.create(dims, side, device="cpu")
    for p, meaning in zip(pts, (0, 2, SV_START + 1, 200)):
        jm, tm = jm.insert_point_cloud(p, meaning), tm.insert_point_cloud(p, meaning)
    for p, meaning in zip(pts, (SV_START, SV_START + 30, SV_START + 55, 31)):
        jm, tm = jm.insert_point_cloud(p[::2], meaning), tm.insert_point_cloud(p[::2], meaning)

    def same(t, j):
        np.testing.assert_array_equal(_u32(t.data), np.asarray(j.data))
        np.testing.assert_array_equal(t.occ.numpy(), np.asarray(j.occ))

    same(tm.clear_bit(SV_START + 1), jm.clear_bit(SV_START + 1))
    same(tm.clear_bits([2, 31, 200]), jm.clear_bits([2, 31, 200]))
    same(tm.clear_voxel_meaning(0), jm.clear_voxel_meaning(0))
    same(tm.clear_collision_flags(), jm.clear_collision_flags())
    for k in (0, 1, 9, 32, 56):
        same(tm.shift_left_swept_volume_ids(k), jm.shift_left_swept_volume_ids(k))
    for meaning in (0, 2, SV_START + 30, 200):
        np.testing.assert_array_equal(tm.get_bit_mask(meaning).numpy(), np.asarray(jm.get_bit_mask(meaning)))


def _fk64(params, types, cloud_link, point_cloud, points, values):
    """float64 [T, P, 3] oracle of the chain: DH_0 ... DH_{i-1} moves link
    i's cloud (numpy, independent of both packages)."""
    values = np.atleast_2d(np.asarray(values, np.float64))
    out = np.empty((len(values), len(points), 3))
    for t, v in enumerate(values):
        acc, before = np.eye(4), []
        for (d, theta, a, alpha), jt, q in zip(params, types, v):
            before.append(acc)
            d, theta = (d + q, theta) if jt == int(DHJointType.PRISMATIC) else (d, theta + q)
            ct, st, ca, sa = np.cos(theta), np.sin(theta), np.cos(alpha), np.sin(alpha)
            acc = acc @ np.array([[ct, -st * ca, st * sa, a * ct], [st, ct * ca, -ct * sa, a * st],
                                  [0, sa, ca, d], [0, 0, 0, 1]])
        m = np.stack([before[i] for i in cloud_link])[point_cloud]
        out[t] = np.einsum("pij,pj->pi", m[:, :3, :3], points) + m[:, :3, 3]
    return out


def _fk_arm(case):
    """A UR10 at 0.05 m spacing; `prismatic` makes the elbow a sliding
    joint, `subset` keeps clouds on three of the seven links only."""
    arm = tpresets.ur_robot("ur10", 0.05, device="cpu")
    if case in ("prismatic", "subset"):
        params = [arm.dh[n] for n in arm.link_names]
        if case == "prismatic":
            params[2] = DHParameters(0.1, 0.2, -0.5723, 0.3, joint_type=DHJointType.PRISMATIC)
        keep = [1, 3, 6] if case == "subset" else range(7)
        clouds = TMeta.from_clouds([arm.clouds.get_cloud(i).numpy() for i in keep],
                                   [arm.clouds.names[i] for i in keep], device="cpu")
        arm = type(arm)(arm.link_names, params, clouds)
    return arm


@pytest.mark.parametrize("case", ["unbatched", "T1", "T34", "prismatic", "subset", "set_configuration", "checks"])
def test_chain_fk_on_the_cpu_takes_the_plain_path(case, monkeypatch):
    """A CPU chain runs the plain versions of robot/dh_cuda.py and never its
    kernels (their launch counts stay 0, the library is never loaded): FK
    of [L] and [T, L] joint values, a prismatic joint and clouds on a strict
    subset of the links against a float64 oracle (and, unbatched, the
    reference), link_matrices equal to dh_chain_plain, set_configuration
    equal to transformed_clouds_for; and the card route's argument checks
    (`_checked`, `_checked_points`) raise without a card."""
    from gpu_voxels_tpu_torch.robot import dh_cuda
    from gpu_voxels_tpu_torch.utils import kernels

    def no_library():
        raise AssertionError("a CPU chain must not load the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(kernels.launches)
    arm = _fk_arm(case)
    params, types, cloud_link = arm._table
    assert params.dtype == torch.float32 and types.dtype == torch.int32 and cloud_link.dtype == torch.int32
    table = (params.tolist(), types.tolist(), cloud_link.tolist(), arm._point_cloud.numpy(), arm.clouds.points.numpy())
    rng = np.random.default_rng(20)
    if case == "checks":
        pc, pts = arm._point_cloud, arm.clouds.points
        vals = torch.zeros((2, 7))
        bad = [
            ((vals.double(), params, types, cloud_link), "float32"),
            ((vals[:, :3].contiguous(), params, types, cloud_link), "params .* \\[3, 4\\]"),
            ((vals, params[:, :3].contiguous(), types, cloud_link), "params"),
            ((vals, params, types.long(), cloud_link), "joint_types"),
            ((vals, params, types, cloud_link.long()), "cloud_link"),
            ((vals, params, types, cloud_link[:0]), "C >= 1"),
            ((torch.zeros((2, 65)), torch.zeros((65, 4)), torch.zeros(65, dtype=torch.int32), cloud_link), "1 to 64"),
            ((torch.zeros(()), params, types, cloud_link), "1 to 64"),
            ((vals.numpy()[0].astype(np.float64), params, types, cloud_link), "host values"),
            ((vals.numpy(), params, types, cloud_link), "host values"),
            ((vals, params.to("meta"), types, cloud_link), "values must be on meta"),
        ]
        for args, msg in bad:  # the card's checks; a CPU table takes the plain versions
            with pytest.raises(ValueError, match=msg):
                dh_cuda._checked(*args)
        for more, msg in [((pc.long(), pts), "point_cloud"), ((pc[None], pts), r"\[P\]"),
                          ((pc, pts.T.contiguous().T), "points"), ((pc, pts[:-1]), "points")]:
            with pytest.raises(ValueError, match=msg):
                dh_cuda._checked_points(*more, params.device)
        flat, t, n, c = dh_cuda._checked(torch.zeros((3, 4, 7)).transpose(0, 1), params, types, cloud_link)
        assert flat.shape == (12, 7) and flat.is_contiguous() and (t, n, c) == (12, 7, 7)
        assert dh_cuda._checked(vals.numpy()[0], params, types, cloud_link)[1:] == (1, 7, 7)
    elif case == "set_configuration":
        cfg = {n: float(v) for n, v in zip(arm.link_names, rng.uniform(-2, 2, 7))}
        arm.set_configuration(cfg)
        pts = arm.get_transformed_clouds().points
        assert torch.equal(pts, arm.transformed_clouds_for(cfg).points)
        assert torch.equal(pts, arm.transformed_clouds_for(None).points)
        np.testing.assert_allclose(pts.numpy(), _fk64(*table, [cfg[n] for n in arm.link_names])[0], atol=2e-6)
        seg = arm.clouds.get_cloud(2).numpy()[:10] * 0.5  # resized: the point ids are packed anew
        arm.update_point_cloud("elbow_joint", seg)
        assert torch.equal(arm._point_cloud, arm.clouds.cloud_ids.to(torch.int32))
        assert torch.equal(arm.get_transformed_clouds().points, arm.transformed_clouds_for(cfg).points)
    else:
        shape = {"unbatched": (7,), "T1": (1, 7), "T34": (34, 7)}.get(case, (5, 7))
        vals = torch.from_numpy(rng.uniform(-np.pi, np.pi, shape).astype(np.float32))
        got = arm.transformed_clouds_for(vals).points
        mats = arm.link_matrices(vals)
        assert got.shape == shape[:-1] + (arm.clouds.accumulated_size, 3)
        assert mats.shape == shape[:-1] + (arm.clouds.num_clouds, 4, 4)
        assert torch.equal(mats, dh_cuda.dh_chain_plain(vals, params, types, cloud_link))
        assert torch.equal(got, dh_cuda.dh_fk_points_plain(vals, params, types, cloud_link, arm._point_cloud,
                                                           arm.clouds.points))
        np.testing.assert_allclose(got.numpy().reshape(-1, 3), _fk64(*table, vals.numpy()).reshape(-1, 3), atol=2e-6)
        if case == "unbatched":
            jarm = jpresets.ur_robot("ur10", 0.05)
            np.testing.assert_allclose(got.numpy(), np.asarray(jarm.transformed_clouds_for(jnp.asarray(vals)).points),
                                       **FK_TOL)
    assert kernels.launches == before


@pytest.mark.parametrize("shape", [(7,), (5, 7), (2, 3, 7)], ids=["L", "T,L", "A,B,L"])
def test_dh_wrappers_on_cpu_equal_the_plain_route_bit_for_bit(shape, monkeypatch):
    """On a CPU table `dh_chain` and `dh_fk_points` are the route a CPU chain
    took before they routed it: dh_chain_plain, then the clouds' batched
    transform (MetaPointCloud.transformed_per_cloud), bit for bit, at the
    batch shape given; and they launch nothing and never load the library."""
    from gpu_voxels_tpu_torch.robot import dh_cuda
    from gpu_voxels_tpu_torch.utils import kernels

    def no_library():
        raise AssertionError("a CPU table must not load the kernel library")

    monkeypatch.setattr(kernels, "library", no_library)
    before = dict(kernels.launches)
    arm = _fk_arm("prismatic")
    vals = torch.from_numpy(np.random.default_rng(22).uniform(-np.pi, np.pi, shape).astype(np.float32))
    mats = dh_cuda.dh_chain_plain(vals, *arm._table)
    assert torch.equal(dh_cuda.dh_chain(vals, *arm._table), mats)
    pts = dh_cuda.dh_fk_points(vals, *arm._table, arm._point_cloud, arm.clouds.points)
    assert pts.shape == shape[:-1] + (arm.clouds.accumulated_size, 3)
    assert torch.equal(pts, arm.clouds.transformed_per_cloud(mats).points)
    assert torch.equal(arm.transformed_clouds_for(vals).points, pts) and torch.equal(arm.link_matrices(vals), mats)
    assert kernels.launches == before
