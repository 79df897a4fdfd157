"""Port conformance of the swept-volume slice: robot -> swept volume ->
types collide, and the plain version of kernel K4.

The same numpy inputs go through gpu_voxels_tpu (JAX, the reference) and
gpu_voxels_tpu_torch on the CPU; counts, colliding meanings, maps and
occupancy summaries must be equal. K4's plain version (the CPU route of
ops/collide_cuda.collide_types_bit_bit) is held against the Pallas kernel
itself, run in interpret mode on the CPU, and against the reference's XLA
path. Also: the port's entry points default to the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.constants import SV_START
from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import collide as jcollide
from gpu_voxels_tpu.ops import collide_pallas as jpallas
from gpu_voxels_tpu.ops import insert as jinsert
from gpu_voxels_tpu.robot import swept_volume as jsv
from gpu_voxels_tpu.robot.dh import DHParameters as JDH
from gpu_voxels_tpu.robot.dh import KinematicChain as JChain
from gpu_voxels_tpu_torch import bitops, interop, utils
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.constants import MapType
from gpu_voxels_tpu_torch.geometry import transforms as ttf
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import CountingVoxelMap as TCount
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import collide_cuda
from gpu_voxels_tpu_torch.ops import insert as tinsert
from gpu_voxels_tpu_torch.ops import raycast
from gpu_voxels_tpu_torch.robot import swept_volume as tsv
from gpu_voxels_tpu_torch.robot.dh import DHParameters as TDH
from gpu_voxels_tpu_torch.robot.dh import KinematicChain as TChain
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


def _t(w):
    return torch.tensor(np.ascontiguousarray(w).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _dense(seed, n):
    """Dense-random words, whole voxels zeroed with p = 0.7
    (tests/test_collide_pallas.py:45-55)."""
    r = np.random.default_rng(seed)
    w = r.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
    return w * (r.random(n) < 0.3).astype(np.uint32)


def _same_types(got, ref):
    cnt, meanings, new = got
    assert cnt.dtype == torch.int64 and meanings.dtype == torch.int32
    assert int(cnt) == int(ref[0])
    np.testing.assert_array_equal(_u32(meanings), np.asarray(ref[1]))
    np.testing.assert_array_equal(_u32(new), np.asarray(ref[2]))


def test_k4_plain_matches_the_pallas_kernel(monkeypatch):
    """Against `_types_kernel` itself (interpret mode), ungated and gated by
    the occupancy summaries, with the bit-0-only hazard voxel: a holds only
    eBVM_FREE (occupancy 0) where b holds SV bit 6, which margins >= 4 reach
    (tests/test_collide_pallas.py:91-127)."""
    monkeypatch.setattr(jpallas, "TYPES_TILE_ROWS", 8)  # many small tiles
    rng = np.random.default_rng(11)
    n = 5000
    a, b = np.zeros((8, n), np.uint32), np.zeros((8, n), np.uint32)
    for w in (a, b):
        k = n // 5
        w[rng.integers(0, 8, k), rng.choice(n, k, replace=False)] = np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32)
    a[:, 5], b[:, 5] = 0, 0
    a[0, 5], b[0, 5] = 1, 1 << 6

    def occ(w):
        return jnp.asarray(((w[0] & 0xFFFFFFFE) | np.bitwise_or.reduce(w[1:], axis=0)) != 0).astype(jnp.uint8)

    for margin, mark, gated in ((0, True, False), (8, True, True), (4, False, True), (8, False, False)):
        gate = dict(occ_a=occ(a), occ_b=occ(b)) if gated else {}
        ref = jpallas.collide_types_bit_bit(jnp.asarray(a), jnp.asarray(b), margin, mark=mark, **gate)
        _same_types(collide_cuda.collide_types_bit_bit(_t(a), _t(b), margin, mark), ref)
        if margin >= 4:
            assert int(ref[0]) >= 1  # the hazard voxel is counted


@pytest.mark.parametrize("margin", [0, 1, 4, 7, 24])
def test_k4_plain_matches_the_xla_path(margin):
    n = 70_000  # not a multiple of any tile
    a, b = _dense(3, n), _dense(4, n)
    ref = jcollide.collide_with_types_bit_bit(jnp.asarray(a), jnp.asarray(b), margin=margin, sv_offset=0)
    ta = _t(a)
    _same_types(collide_cuda.collide_types_bit_bit(ta, _t(b), margin, True), ref)
    cnt, meanings, same = collide_cuda.collide_types_bit_bit(ta, _t(b), margin, False)
    assert same is ta and int(cnt) == int(ref[0])  # without marking, `a` itself
    assert kernels.launches["gv_collide_types_bit_bit"] == 0  # CPU tensors take the plain version


def test_scatter_bits_multi_matches_reference():
    """Duplicate (voxel, bit) pairs (H7), out-of-map points (F2), bit 31
    and eBVM_FREE (masked out of the summary) in one scatter."""
    rng = np.random.default_rng(12)
    n = 4000
    idx = rng.integers(0, n + 1, 3000)  # n = out of map
    idx[:200] = idx[200:400]  # duplicates
    meanings = rng.choice([0, 1, 4, 31, 32, 63, 100, 255], 3000)
    planes = _dense(13, n) & _dense(14, n)
    occ = np.asarray(jnp.asarray(((planes[0] & 0xFFFFFFFE) | np.bitwise_or.reduce(planes[1:], axis=0)) != 0)).astype(np.uint8)
    jp, jo = jinsert.scatter_bits_multi(jnp.asarray(planes), jnp.asarray(occ), jnp.asarray(idx.astype(np.int32)), meanings)
    tp, to = tinsert.scatter_bits_multi(_t(planes), torch.tensor(occ), torch.tensor(idx), meanings)
    np.testing.assert_array_equal(_u32(tp), np.asarray(jp))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def _two_link_arm(pkg):
    dh, chain, meta = (JDH, JChain, JMeta) if pkg == "jax" else (TDH, TChain, TMeta)
    clouds = [[[0.5, 0.0, 0.0]], [[0.5, 0.0, 0.0]]]
    kw = {} if pkg == "jax" else {"device": "cpu"}
    params = [dh(d=0.0, theta=0.0, a=1.0, alpha=0.0), dh(d=0.0, theta=0.0, a=1.0, alpha=0.0)]
    return chain(["link1", "link2"], params, meta.from_clouds(clouds, names=("link1", "link2"), **kw))


class _TableFK:
    """A robot whose FK is a table of points per step (config [step]): both
    packages insert exactly the same points."""

    def __init__(self, table, pkg):
        self.table = jnp.asarray(table) if pkg == "jax" else torch.tensor(table)
        self.meta = (JMeta if pkg == "jax" else TMeta).from_clouds(
            [table[0]], **({} if pkg == "jax" else {"device": "cpu"}))
        self.pkg = pkg

    def transformed_clouds_for(self, cfg):
        from dataclasses import replace

        step = cfg[..., 0].astype(jnp.int32) if self.pkg == "jax" else cfg[..., 0].long()
        return replace(self.meta, points=self.table[step])


def test_batched_swept_volume_matches_reference_and_loop():
    """70 steps with num_ids=40 span planes 0-1 and wrap meanings (step 40
    reuses SV bit 4): the reference's maps and summaries exactly when fed the
    same FK points, and in the port batched equals looped
    (tests/test_robot.py:181-198)."""
    traj = np.stack([np.array([t, 0.3 * t], np.float32) for t in np.linspace(0, np.pi / 2, 70)])
    jarm = _two_link_arm("jax")
    table = np.asarray(jax.vmap(lambda c: jarm.transformed_clouds_for(c).points)(jnp.asarray(traj)))
    steps = np.arange(70, dtype=np.float32)[:, None]
    ref = jsv.insert_swept_volume_batched(JBit.create((8, 8, 8), 0.25), _TableFK(table, "jax"), steps, num_ids=40)
    got = tsv.insert_swept_volume_batched(TBit.create((8, 8, 8), 0.25, device="cpu"), _TableFK(table, "torch"),
                                          steps, num_ids=40)
    planes, occ = interop.to_numpy(got)
    np.testing.assert_array_equal(planes, np.asarray(ref.data))
    np.testing.assert_array_equal(occ, np.asarray(ref.occ))
    tarm = _two_link_arm("torch")
    base = TBit.create((8, 8, 8), 0.25, device="cpu")
    batched = tsv.insert_swept_volume_batched(base, tarm, traj, num_ids=40)
    looped = tsv.insert_swept_volume(base, tarm, list(traj), num_ids=40)
    assert torch.equal(batched.data, looped.data) and torch.equal(batched.occ, looped.occ)
    assert not batched.data[3:].any() and batched.data[1].any()
    assert tsv.sv_meaning_for_step(40, 40) == SV_START == jsv.sv_meaning_for_step(40, 40)
    assert tsv.NUM_SV_IDS == jsv.NUM_SV_IDS


def _example_arm(pkg):
    """examples/swept_volume_vs_environment.py's arm, its link clouds moved
    by (0.013, 0.027, 0.061) m so that every FK point of the trajectory
    lies >= 1e-3 voxel from a cell boundary (the example's own points sit
    on boundaries, where FK ulps between the frameworks could flip a voxel)."""
    dh, chain, meta = (JDH, JChain, JMeta) if pkg == "jax" else (TDH, TChain, TMeta)
    cloud = (np.linspace([0.1, 0, 0], [0.9, 0, 0], 9) + np.asarray([0.013, 0.027, 0.061])).astype(np.float32)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    clouds = meta.from_clouds([cloud] * 2, names=("link1", "link2"), **kw)
    return chain(["link1", "link2"], [dh(0, 0, 1.0, 0), dh(0, 0, 1.0, 0)], clouds)


def test_swept_volume_scene_matches_reference():
    """The slice as a whole: the scene of examples/swept_volume_vs_environment.py
    at 64^3 through both packages' entry points."""
    dims, side = (64, 64, 64), 0.125
    traj = [np.array([t, t / 2], np.float32) for t in np.linspace(0, np.pi / 2, 20)]
    jarm, tarm = _example_arm("jax"), _example_arm("torch")
    fk = np.array(jax.vmap(lambda c: jarm.transformed_clouds_for(c).points)(jnp.asarray(np.stack(traj))))
    f = fk.astype(np.float64) / side
    assert np.abs(f - np.round(f)).min() >= 1e-3
    jsweep = jsv.insert_swept_volume_batched(JBit.create(dims, side), jarm, np.stack(traj))
    tsweep = tsv.insert_swept_volume_batched(TBit.create(dims, side, device="cpu"), tarm, np.stack(traj))
    np.testing.assert_array_equal(_u32(tsweep.data), np.asarray(jsweep.data))
    np.testing.assert_array_equal(tsweep.occ.numpy(), np.asarray(jsweep.occ))

    # the obstacle appears at step 10's position of the elbow
    cfg = {"link1": float(traj[10][0]), "link2": float(traj[10][1])}
    jarm.set_configuration(cfg)
    tarm.set_configuration(cfg)
    jpts = np.asarray(jarm.get_transformed_clouds().points)[:3]
    tpts = tarm.get_transformed_clouds().points[:3]
    np.testing.assert_allclose(tpts.numpy(), jpts, rtol=1e-6, atol=1e-6)
    jenv = JBit.create(dims, side).insert_point_cloud(jpts, SV_START + 10)
    tenv = TBit.create(dims, side, device="cpu").insert_point_cloud(tpts, SV_START + 10)

    def same(t, j):
        cnt, meanings, marked = t
        assert int(cnt) == int(j[0])
        np.testing.assert_array_equal(_u32(meanings), np.asarray(j[1]))
        np.testing.assert_array_equal(_u32(marked.data), np.asarray(j[2].data))
        np.testing.assert_array_equal(marked.occ.numpy(), np.asarray(j[2].occ))
        return int(cnt)

    counts = [same(tsweep.collide_with_types(tenv, 1.0, sv_window=w), jsweep.collide_with_types(jenv, 1.0, sv_window=w))
              for w in (0, 2, 5)]
    assert min(counts) > 0
    assert bool(bitops.get_bit(tsweep.collide_with_types(tenv, 1.0, sv_window=0)[1], SV_START + 10))
    for margin, sv_offset in ((0, 0), (8, 0), (3, 9)):  # K4's domain and the plain full domain
        assert int(tsweep.collide_with_bitcheck(tenv, margin, sv_offset)) == \
            int(jsweep.collide_with_bitcheck(jenv, margin, sv_offset))
    same(tsweep.collide_with_types(tenv, 1.0, sv_window=2, sv_offset=4),
         jsweep.collide_with_types(jenv, 1.0, sv_window=2, sv_offset=4))
    jshift, tshift = jsweep.shift_left_swept_volume_ids(1), tsweep.shift_left_swept_volume_ids(1)
    assert same(tshift.collide_with_types(tenv, 1.0, 2), jshift.collide_with_types(jenv, 1.0, 2)) > 0
    # bit x prob (plain): the prob side's threshold, the bit voxel's whole vector
    jprob = JProb.create(dims, side).insert_point_cloud(fk[7])
    tprob = TProb.create(dims, side, device="cpu").insert_point_cloud(fk[7])
    assert same(tsweep.collide_with_types(tprob, 0.55), jsweep.collide_with_types(jprob, 0.55)) > 0
    marked = tsweep.collide_with_types(tenv, 1.0, 5)[2]
    np.testing.assert_array_equal(_u32(marked.clear_collision_flags().data), np.asarray(jsweep.data))


def test_entry_points_default_to_the_card():
    """With no device, every entry point allocates on CUDA: tensors on the
    card where there is one, torch's own error where there is none."""
    calls = [
        lambda: TProb.create((4, 4, 4)).data,
        lambda: TBit.create((4, 4, 4)).data,
        lambda: bitops.zeros((3,)),
        lambda: ttf.identity(),
        lambda: ttf.from_rpy([0.1, 0.2, 0.3]),
        lambda: utils.to_device(np.zeros(3), torch.float32),
        lambda: TMeta.from_clouds([np.zeros((2, 3), np.float32)]).points,
        lambda: interop.prob_map_from_numpy(np.zeros(64, np.int8), (4, 4, 4), 1.0).data,
        lambda: TCount.create((4, 4, 4)).data,
        lambda: interop.counting_map_from_numpy(np.zeros(64, np.int8), (4, 4, 4), 1.0).data,
        lambda: interop.bit_map_from_numpy(np.zeros((8, 64), np.uint32), None, (4, 4, 4), 1.0).data,
        lambda: raycast.ray_crossing_counts((0.5, 0.5, 0.5), np.ones((2, 3), np.float32), 1.0, (4, 4, 4), 4),
    ]
    gvl = TGvl()
    gvl.initialize(4, 4, 4, 1.0)
    assert gvl._device == utils.default_device() == torch.device("cuda")
    calls.append(lambda: gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "m").data)
    for call in calls:
        if torch.cuda.is_available():
            assert call().is_cuda
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA|accelerator"):
                call()
    # a tensor keeps its own device
    assert utils.to_device(torch.zeros(2), torch.int32).device.type == "cpu"
