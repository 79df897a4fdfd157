"""Exact-count contracts of tests_tpu/test_tpu_contracts.py on the card.

Each test keeps its counterpart's name, `_on_tpu` read as `_on_cuda`, its
scale and its exact integers. Where the reference holds a compiled Pallas
kernel against its XLA formulation, the port's hand-written CUDA kernel is
held against its plain torch version on the same inputs, on the card. The
oracles are the reference's own: the linkage count 8000
(example_how_to_link/gvl_linkage_test_lib.cpp:20-38), differences3D == 0
(test/testing_distance.cu:79-119), bitMarginCollisionCheck's byte oracle
(helpers/BitVector.h:415-471), host brute force and set arithmetic. Two
contracts are this port's own: every map tier taking a slab-sharded operand
(parallel/shard_value) at 64^3 on the card, a DH chain's FK as one launch
(csrc/dh_fk.cu) against float64 on the planner workcell's UR10, and a depth
frame's hits and log-odds update as one launch each (csrc/depth_insert.cu)
on the workcell Kinect's frames, against their plain versions and float64.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch import bitops
from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import SV_END, SV_START, BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.geometry import transforms
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import collide_cuda, raycast_cuda
from gpu_voxels_tpu_torch.utils import kernels


def _t(x, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _planes(words: np.ndarray, device) -> torch.Tensor:
    """uint32[8, N] words as the port's int32 bit planes on `device`."""
    return torch.from_numpy(np.ascontiguousarray(words, np.uint32).view(np.int32)).to(device)


def _fresh_gvl(card) -> GpuVoxels:
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(150, 150, 150, 0.01, device=card)
    return gvl


def test_linkage_scene_exact_count_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:32. BASELINE config #1: the
    gvl_linkage_test overlap is exactly 8000 on the card (K1 on the facade's
    maps)."""
    gvl = _fresh_gvl(card)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "a")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "b")
    center, box, overlap = np.array([0.5] * 3), np.array([0.4] * 3), np.array([0.1] * 3)
    c1 = center - overlap
    c2 = c1 + box
    c3 = center + overlap
    c4 = c3 - box
    gvl.insert_box_into_map(c1, c2, "a", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map(c4, c3, "b", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    before = kernels.launches["gv_count_prob_prob"]
    assert int(gvl.get_map("a").collide_with(gvl.get_map("b"))) == 8000
    assert kernels.launches["gv_count_prob_prob"] == before + 1
    GpuVoxels._instance = None


def test_cuda_collide_count_matches_plain_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:47 (Pallas vs XLA). K1 returns the
    plain version's count, and numpy's, on random int8 occupancy of a length
    that leaves a ragged tail."""
    rng = np.random.default_rng(7)
    n = 257 * 1024 + 13
    a = rng.integers(-128, 128, n, dtype=np.int8)
    b = rng.integers(-128, 128, n, dtype=np.int8)
    t = 100
    want = int(np.sum((a.astype(np.int32) >= t) & (b.astype(np.int32) >= t)))
    ta, tb = _t(a, card), _t(b, card)
    before = kernels.launches["gv_count_prob_prob"]
    got = collide_cuda.count_prob_prob(ta, tb, t, t)
    assert kernels.launches["gv_count_prob_prob"] == before + 1
    assert int(got) == int(collide_cuda.count_prob_prob_plain(ta, tb, t, t)) == want


def _byte_oracle(v1_bytes, v2_bytes, coll_bytes, margin, sv_offset):
    """bitMarginCollisionCheck (helpers/BitVector.h:415-471) byte for byte on
    one voxel's uint8[32]: (any collision, collision bytes)."""
    v1_bytes = np.asarray(v1_bytes, dtype=np.uint8)
    v2_bytes = np.asarray(v2_bytes, dtype=np.uint8)
    coll = np.array(coll_bytes, dtype=np.uint8, copy=True)
    num_bits = 8 * len(v1_bytes)
    buffer_half = 32
    m64 = (1 << 64) - 1  # C++ uint64 wraparound: shifts past bit 63 drop
    buf = 0
    for byte_nr in range(4):
        ib = int(v2_bytes[byte_nr])
        if byte_nr == 0:
            ib &= 0b11110000
        buf = (buf + (ib << (buffer_half + byte_nr * 8))) & m64
    byte_offset = sv_offset % 8
    bit_offset = sv_offset // 8
    i = SV_START + byte_offset
    while i < SV_END:
        byte = 0
        byte_1 = (int(v1_bytes[i >> 3]) << (buffer_half - margin + bit_offset)) & m64
        for k in range(2 * margin + 1):
            byte |= ((byte_1 & buf) >> (buffer_half - margin + k)) & 0xFF
            byte_1 = (byte_1 << 1) & m64
        coll[i >> 3] = byte
        buf >>= 8
        if i < num_bits - buffer_half:
            buf = (buf + (int(v2_bytes[(i + buffer_half) >> 3]) << 56)) & m64
        i += 8
    return (coll != 0).any(), coll


def test_bit_margin_packed_full_vs_byte_oracle_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:63. bitMarginCollisionCheck over
    margin / offset pairs, the uint64-truncation regime included, on the
    card's planes against the byte oracle."""
    rng = np.random.default_rng(3)
    n = 513
    v1 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    v2 = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    v1[:, 0] &= 0xF0  # ids live in bits 4..253
    v2[:, 0] &= 0xF0
    p1 = _planes((v1.reshape(n, 8, 4).astype(np.uint32) @ (256 ** np.arange(4)).astype(np.uint32)).T, card)
    p2 = _planes((v2.reshape(n, 8, 4).astype(np.uint32) @ (256 ** np.arange(4)).astype(np.uint32)).T, card)
    for margin, sv_offset in [(1, 0), (5, 6), (24, 40), (31, 0), (31, 17)]:
        want = np.array([_byte_oracle(v1[i], v2[i], np.zeros(32, np.uint8), margin, sv_offset)[0]
                         for i in range(n)])
        got, _ = bitops.bit_margin_collision_check_packed_full(p1, p2, bitops.zeros((n,), device=card), margin,
                                                               sv_offset)
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy(), want, err_msg=f"margin={margin} off={sv_offset}")


def test_edt_parallel_banding_exact_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:86. differences3D(parallel_banding,
    brute) == 0 with K5, the envelope kernel."""
    dims = (96, 80, 64)
    rng = np.random.default_rng(11)
    obs = np.stack([rng.integers(0, dims[0], 500), rng.integers(0, dims[1], 500), rng.integers(0, dims[2], 500)],
                   -1).astype(np.float32)
    m = DistanceVoxelMap.create(dims, device=card).insert_point_cloud(obs + 0.5)
    pba = m.parallel_banding()
    brute = m.exact_distances(np.unique(np.floor(obs), axis=0))
    assert int(pba.differences(brute)) == 0


def test_jump_flood_api_routes_exact_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:102. jumpFlood3D at 128^3 routes to
    the exact envelope sweeps on the card; differences3D against the brute
    oracle is 0."""
    dims = (128, 128, 128)
    rng = np.random.default_rng(12)
    obs = np.unique(np.stack([rng.integers(0, d, 400) for d in dims], -1), axis=0)
    m = DistanceVoxelMap.create(dims, device=card).insert_point_cloud(obs.astype(np.float32) + 0.5)
    assert DistanceVoxelMap._jump_flood_route(dims, 1, card) == "banding"
    jf = m.jump_flood()
    brute = m.exact_distances(obs.astype(np.int32))
    assert int(jf.differences(brute)) == 0


def test_list_dispatch_directions_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:121. List -> dense routing and the
    cross linear x morton list collide on the card."""
    from gpu_voxels_tpu_torch.geometry import generation
    from gpu_voxels_tpu_torch.maps.voxellist import bit_vector_morton_voxel_list, bit_vector_voxel_list

    dims = (32, 32, 32)
    pts = generation.create_box_of_points((1.1,) * 3, (5.1,) * 3, 1.0)
    pts_b = generation.create_box_of_points((3.1,) * 3, (7.1,) * 3, 1.0)
    lin = bit_vector_voxel_list(dims, device=card).insert_point_cloud(pts, 50)
    mor = bit_vector_morton_voxel_list(dims, device=card).insert_point_cloud(pts_b, 50)
    assert int(lin.collide_with(mor)) == 27
    assert int(mor.collide_with(lin)) == 27
    assert int(lin.collide_with(mor, offset=(2, 0, 0))) == 45
    dense_b = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(pts_b, 50)
    assert int(lin.collide_with(dense_b)) == 27
    assert int(mor.collide_with(dense_b)) == 125
    prob_b = ProbVoxelMap.create(dims, device=card).insert_point_cloud(pts_b)
    assert int(lin.collide_with(prob_b)) == 27


def test_edt_512_sampled_brute_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:150. parallel_banding at the full
    512^3 BASELINE scale (K5), spot-checked against a host brute-force
    nearest-obstacle oracle on 2048 random voxels."""
    dims = (512, 512, 512)
    rng = np.random.default_rng(17)
    obs = np.unique(rng.integers(0, 512, (20_000, 3)).astype(np.int64), axis=0)
    m = DistanceVoxelMap.create(dims, device=card).insert_point_cloud(obs.astype(np.float32) + 0.5)
    pba = m.parallel_banding()
    q = rng.integers(0, 512, (2048, 3)).astype(np.int64)
    dx, dy, _ = dims
    lin = q[:, 2] * dx * dy + q[:, 1] * dx + q[:, 0]
    got = torch.take(pba.squared_distances().reshape(-1), _t(lin, card)).cpu().numpy()
    want = np.empty(len(q), np.int64)
    for i in range(0, len(q), 256):
        d = obs[None, :, :] - q[i:i + 256, None, :]
        want[i:i + 256] = (d * d).sum(-1).min(1)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_voxellist_morton60_membership_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:177. 60-bit Morton ids at 4096^3:
    coords past 1024 do not alias."""
    dims = (4096, 4096, 4096)
    coords = np.array([[1, 2, 3], [1025, 9, 3000], [4095, 4095, 4095], [1, 2, 3]], np.float32)
    lst = VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton", device=card)
    lst = lst.insert_point_cloud(coords + 0.5)
    assert int(lst.count) == 3  # the duplicate folded, no aliasing between rows
    other = VoxelList.create(dims, 1.0, kind="bit", capacity=8, id_mode="morton", device=card)
    other = other.insert_point_cloud(np.array([[4095, 4095, 4095]], np.float32) + 0.5)
    assert int(lst.collide_with(other)) == 1


def test_bitvector_swept_volume_window_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:189. The windowed swept-volume
    collide (K4 without marking) counts exactly."""
    dims = (32, 32, 32)
    sv0 = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)
    pts = np.array([[4.5, 4.5, 4.5], [10.5, 4.5, 4.5]], np.float32)
    a = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(pts, sv0)
    b = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(pts[:1], sv0 + 3)
    before = kernels.launches["gv_collide_types_bit_bit"]
    assert int(a.collide_with_bitcheck(b, margin=2)) == 0  # steps 3 apart
    assert int(a.collide_with_bitcheck(b, margin=3)) == 1
    assert kernels.launches["gv_collide_types_bit_bit"] == before + 2


def test_prob_bit_cross_collide_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:203. Prob x bit (DefaultCollider
    thresholds): exactly 4 * 8 * 8."""
    dims = (64, 64, 64)
    pts = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5
    prob = ProbVoxelMap.create(dims, device=card).insert_point_cloud(pts.astype(np.float32))
    bitm = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud((pts + [4, 0, 0]).astype(np.float32))
    assert int(prob.collide_with(bitm)) == 4 * 8 * 8


def test_paged_octree_scale_contracts_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:216. The sparse 32768^3 tier on the
    card: exact probes after an insert with ray-carved free space, sparse
    memory."""
    from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap

    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0, device=card)
    hits = np.array([[31000.5, 17.5, 22222.5], [200.5, 200.5, 190.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, (200.5, 200.5, 200.5))
    occ, _, _ = m.probe(_t(np.floor(hits).astype(np.int32), card))
    assert bool(occ.all())
    o2, _, f2 = m.probe(_t([[200, 200, 195]], card, torch.int32))
    assert bool(f2[0]) and not bool(o2[0])
    _, u3, _ = m.probe(_t([[1, 1, 1]], card, torch.int32))
    assert bool(u3[0])
    assert m.memory_usage() < 300 * 1024 * 1024


def test_collide_types_one_pass_kernel_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:233 (Pallas vs XLA). K4's one pass
    (count, meanings OR, marking) equals the packed plain formulation and the
    plain version of K4 across the margin domain."""
    n = 70_000

    def mk(seed):
        r = np.random.default_rng(seed)
        w = r.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
        return _planes(w * (r.random(n) < 0.3), card)

    a, b = mk(3), mk(4)
    for margin in (0, 4, 24):
        got_c, got_m, got_a = collide_cuda.collide_types_bit_bit(a, b, margin)
        hit, rec = bitops.bit_margin_collision_check_packed(a, b, margin)
        ref_m = bitops.or_reduce_words(torch.where(hit[None, :], rec, 0))
        assert int(got_c) == int(hit.sum()), margin
        assert torch.equal(got_m, ref_m), margin
        plain_c, plain_m, plain_a = collide_cuda.collide_types_bit_bit_plain(a, b, margin)
        assert int(plain_c) == int(got_c) and torch.equal(plain_m, got_m) and torch.equal(plain_a, got_a), margin


def test_prob_paged_octree_scale_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:258. The probabilistic paged tier at
    32768^3: exact insertSensorData log-odds (UNKNOWN -> -128 + 72 -> + 72,
    occupied at >= 10, crossings clamp at -127)."""
    from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap

    m = PagedHierarchicalMap((32768, 32768, 32768), 1.0, probabilistic=True, device=card)
    origin = (20000.5, 20000.5, 20000.5)
    hits = np.array([[20020.5, 20000.5, 20000.5]], np.float32)
    m.insert_point_cloud_with_free_space(hits, origin)
    hit_q = _t([[20020, 20000, 20000]], card, torch.int32)
    ray_q = _t([[20010, 20000, 20000]], card, torch.int32)
    assert int(m.probe_occupancy(hit_q)[0]) == -56  # -128 + 72
    assert int(m.probe_occupancy(ray_q)[0]) == -127
    o1, _, f1 = m.probe(torch.cat([hit_q, ray_q]))
    assert not bool(o1[0]) and bool(f1[1])
    m.insert_point_cloud_with_free_space(hits, origin)
    assert int(m.probe_occupancy(hit_q)[0]) == 16  # -56 + 72
    assert bool(m.probe(hit_q)[0][0])  # 16 >= THRESHOLD_OCCUPANCY
    assert bool(m.probe(_t([[1, 1, 1]], card, torch.int32))[1][0])  # unknown
    assert m.memory_usage() < 300 * 1024 * 1024


def test_exact_carve_band_refinement_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:284 (Pallas vs the exact per-pixel
    carve). K3 is bit for bit its plain version on depth edges, an invalid
    patch and an off-axis pose."""
    dims = (64, 64, 64)
    rng = np.random.default_rng(7)
    depth = np.full((48, 64), 40.0, np.float32)
    depth[:, 32:] = 20.0
    depth[10:14, 5:9] = 0.0
    depth[30:34, :] += rng.uniform(-5, 5, (4, 64)).astype(np.float32)
    th = 0.4
    rot = np.array([[1, 0, 0], [0, np.cos(th), -np.sin(th)], [0, np.sin(th), np.cos(th)]], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = rot
    pose[:3, 3] = [20, 45, 3]
    args = (_t(depth, card), _t(pose, card), 52.0, 52.0, 32.0, 24.0, 1.0, dims)
    exact = raycast_cuda.projective_free_space_plain(*args)
    before = kernels.launches["gv_carve_exact"]
    got = raycast_cuda.projective_free_space_exact(*args)
    assert kernels.launches["gv_carve_exact"] == before + 1
    assert torch.equal(got, exact)
    assert int(exact.sum()) > 0


def test_gated_types_collide_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:321 (the gated Pallas kernel). K4
    gated by both occupancy summaries equals the ungated kernel and the
    packed oracle on a sparse scene, the margin >= 4 eBVM_FREE hazard voxel
    included."""
    dims = (128, 128, 128)
    r = np.random.default_rng(5)

    def band(z0, z1, m):
        return np.stack([r.uniform(4, 124, m), r.uniform(4, 124, m), r.uniform(z0, z1, m)], axis=-1).astype(
            np.float32)

    a = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(band(20, 60, 40_000), 10)
    b = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(band(50, 90, 40_000), 12)
    # the hazard: a bit-0-only voxel in a dead region of a, an SV bit within margin reach
    ap, bp = a.data.clone(), b.data.clone()
    ap[0, 7] = 1
    bp[0, 7] = 1 << 6
    oa, ob = bitops.occupied(ap).to(torch.uint8), bitops.occupied(bp).to(torch.uint8)
    for margin in (0, 4, 8):
        cg, mg, ng = collide_cuda.collide_types_bit_bit(ap, bp, margin, mark=True, occ_a=oa, occ_b=ob)
        hit, rec = bitops.bit_margin_collision_check_packed(ap, bp, margin)
        ref_m = bitops.or_reduce_words(torch.where(hit[None, :], rec, 0))
        assert int(cg) == int(hit.sum()), margin
        assert torch.equal(mg, ref_m), margin
        cn, _, _ = collide_cuda.collide_types_bit_bit(ap, bp, margin, mark=False)
        assert int(cn) == int(hit.sum()), margin
        pc, pm, pn = collide_cuda.collide_types_bit_bit_plain(ap, bp, margin, True, oa, ob)
        assert int(pc) == int(cg) and torch.equal(pm, mg) and torch.equal(pn, ng), margin
    c8, _, _ = collide_cuda.collide_types_bit_bit(ap, bp, 8, mark=False, occ_a=oa, occ_b=ob)
    hit8, _ = bitops.bit_margin_collision_check_packed(ap, bp, 8)
    assert bool(hit8[7])  # the hazard voxel really hits at 8
    assert int(c8) == int(hit8.sum())


def test_occupancy_summary_coherence_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:358. The uint8 occupancy summary stays
    exactly !noneButEmpty(data) through insert -> shift -> types-mark ->
    merge on the card."""
    dims = (96, 96, 96)
    r = np.random.default_rng(8)
    pts = r.uniform(2, 94, (30_000, 3)).astype(np.float32)
    m = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(pts, 10)
    other = BitVectorVoxelMap.create(dims, device=card).insert_point_cloud(pts[:5000] + 0.5, 12)

    def check(mm, tag):
        assert torch.equal(mm.occ, bitops.occupied(mm.data).to(torch.uint8)), tag

    check(m, "insert")
    m2 = m.shift_left_swept_volume_ids(3)
    check(m2, "shift")
    _, _, m3 = m2.collide_with_types(other, sv_window=2)
    check(m3, "types-mark")
    check(m3.merge(other, new_meaning=20), "merge-remeaned")
    check(m3.merge(other), "merge")
    check(m3.clear_bit(10), "clear_bit")


def test_fused_multi_meaning_scatter_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:384. The one-pass multi-meaning meta
    insert equals per-meaning inserts bit for bit, the summary included."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud

    rngl = np.random.default_rng(11)
    clouds = [rngl.uniform(0.0, 16.0, (257, 3)).astype(np.float32) for _ in range(5)]
    meanings = [4, 44, 99, 4, BitVoxelMeaning.eBVM_FREE]
    meta = MetaPointCloud.from_clouds(clouds, device=card)
    base = BitVectorVoxelMap.create((16, 16, 16), device=card)
    fused = base.insert_meta_point_cloud(meta, meanings)
    looped = base
    for pts, mn in zip(clouds, meanings):
        looped = looped.insert_point_cloud(pts, mn)
    assert torch.equal(fused.data, looped.data)
    assert torch.equal(fused.occ, looped.occ)


def test_fitter_slot_delays_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:404. Three swept maps sharing cells at
    steps 10-12 need exactly the greedy [0, 4, 8] delays at margin 1, through
    K4's bit checks."""
    from gpu_voxels_tpu_torch.robot.fitter import deconflict_slot, fit_schedule

    sv = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)
    dims = (64, 64, 64)

    def box(lo, hi):
        ax = [np.arange(lo[i], hi[i], dtype=np.float32) + 0.5 for i in range(3)]
        return np.stack(np.meshgrid(*ax, indexing="ij"), axis=-1).reshape(-1, 3)

    def swept(home_lo):
        m = BitVectorVoxelMap.create(dims, 1.0, device=card)
        home = box(home_lo, tuple(c + 4 for c in home_lo))
        for s in range(5):
            m = m.insert_point_cloud(home, sv + s)
        shared = box((20, 20, 20), (26, 26, 26))
        for s in range(10, 13):
            m = m.insert_point_cloud(shared, sv + s)
        return m

    a, b, c = swept((1, 1, 1)), swept((40, 1, 1)), swept((1, 40, 1))
    before = kernels.launches["gv_collide_types_bit_bit"]
    assert int(a.collide_with_bitcheck(b, margin=1)) == 216  # 6^3 shared
    assert deconflict_slot([a, b, c], margin=1) == [0, 4, 8]
    robots = [("A", [("t", a)]), ("B", [("t", b)]), ("C", [("t", c)])]
    rescued = fit_schedule(robots, margin=1, windows_in_search=True)
    assert rescued[0][1] == [[0, 4, 8]]
    assert kernels.launches["gv_collide_types_bit_bit"] > before


def test_native_streamed_disk_io_on_cuda(card, tmp_path):
    """tests_tpu/test_tpu_contracts.py:422. The port has no native streamer
    (ROADMAP "Not ported"): write_to_disk / read_from_disk of a card-resident
    bit map round-trips bit for bit, and its bytes equal the file of the same
    map built on the CPU."""
    pts = np.random.default_rng(0).uniform(0.1, 1.2, size=(4000, 3)).astype(np.float32)

    def build(device):
        m = BitVectorVoxelMap.create((64, 64, 64), 0.02, device=device)
        return m.insert_point_cloud(pts, 17).insert_point_cloud(pts[::3] + 0.04, 201)

    m = build(card)
    p = tmp_path / "bits.bin"
    assert m.write_to_disk(p)
    back = m.read_from_disk(p)
    assert back.data.is_cuda and torch.equal(back.data, m.data) and torch.equal(back.occ, m.occ)
    p2 = tmp_path / "bits_cpu.bin"
    assert build("cpu").write_to_disk(p2)
    assert p.read_bytes() == p2.read_bytes()


def test_sharded_paged_world_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:447. ShardedPagedWorld on the card
    (one device, one slab): every result equals the plain
    PagedHierarchicalMap's."""
    from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
    from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld

    dims = (64, 64, 64)
    rng = np.random.default_rng(41)
    pts = rng.uniform([0, 0, 0], dims, size=(300, 3)).astype(np.float32)
    single = PagedHierarchicalMap(dims, 1.0, device=card)
    single.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=64)
    world = ShardedPagedWorld(dims, 1.0, devices=[card])
    world.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 2.5), max_steps=64)
    world.assert_distributed()
    assert world.check_tree() and world.n_tiles() == single.n_tiles()
    q = np.concatenate([rng.integers([0, 0, 0], dims, size=(480, 3)),
                        np.floor(pts[:32]).astype(np.int64)]).astype(np.int32)  # occupied hits
    assert torch.equal(world.probe_status(q).cpu(), single.probe_status(q).cpu())
    count = int(world.collide_with_coords(q))
    assert count == int(single.collide_with_coords(q)) and count >= 32
    lst = VoxelList.create(dims, 1.0, "bit", 2048, "linear", device=card).insert_point_cloud(
        rng.uniform([0, 0, 0], dims, size=(200, 3)).astype(np.float32))
    off = (1, -2, 3)
    assert int(world.collide_with(lst, offset=off)) == int(single.collide_with(lst, offset=off))


class _Cloud:
    def __init__(self, points):
        self.points = points


class _PointRobot:
    """cfg IS the end effector: one point at cfg, for a [3] or [T, 3] tensor
    of configurations."""

    def transformed_clouds_for(self, cfg):
        return _Cloud(cfg[..., None, :])


def test_rrt_connect_planner_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:483. RRT-Connect on the card replays
    the CPU suite's tree (183 iterations; every device step is an exact
    integer gather and compare), and the simplified path is collision-free."""
    from gpu_voxels_tpu_torch.planning import GvlValidityChecker, JointSpace, MotionValidator, PathSimplifier
    from gpu_voxels_tpu_torch.planning import RRTConnect

    ys, zs = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    pts = np.stack([np.full(ys.size, 8.5), ys.ravel() + 0.5, zs.ravel() + 0.5], axis=1).astype(np.float32)
    hole = (pts[:, 1] < 3.0) & (pts[:, 2] < 3.0)
    env = ProbVoxelMap.create((16, 16, 16), 1.0, device=card).insert_point_cloud(pts[~hole])
    checker = GvlValidityChecker(env, _PointRobot(), 0.7)
    validator = MotionValidator(checker, resolution=0.5)
    space = JointSpace(np.zeros(3, np.float32), np.full(3, 16.0, np.float32))
    start = np.array([2.5, 8.5, 8.5], np.float32)
    goal = np.array([14.5, 8.5, 8.5], np.float32)
    ok, _ = validator.check_motion(start, goal)
    assert not ok  # the wall blocks the straight segment
    planner = RRTConnect(space, validator, step=2.0, seed=3)
    assert not planner.endpoint_precheck  # the card's default: one read per extension
    result = planner.solve(start, goal, max_iters=4000)
    assert result.solved and result.iterations == 183  # the CPU suite's tree
    path = PathSimplifier(validator, seed=5).simplify(result.path)
    states = path.interpolate(validator.resolution)
    assert int(checker.batch_colliding_voxels(states).max()) == 0
    np.testing.assert_array_equal(path.states[0], start)
    np.testing.assert_array_equal(path.states[-1], goal)


def test_voxellist_per_point_meanings_on_cuda(card):
    """tests_tpu/test_tpu_contracts.py:532. The fused per-point-meaning insert
    equals the per-meaning loop exactly (keys, count and payload planes)."""
    from gpu_voxels_tpu_torch.maps.voxellist import bit_vector_voxel_list

    dims = (32, 32, 32)
    rng = np.random.default_rng(4)
    pts = (rng.uniform(0, 8, (64, 3)).astype(np.float32) // 1) + 0.5
    meanings = rng.choice(np.array([12, 57, 99, 201], np.int32), 64)
    fused = bit_vector_voxel_list(dims, device=card).insert_point_cloud_with_meanings(pts, meanings)
    oracle = bit_vector_voxel_list(dims, device=card)
    for m in np.unique(meanings):
        oracle = oracle.insert_point_cloud(pts[meanings == m], int(m))
    n = int(fused.count)
    assert n == int(oracle.count)
    assert torch.equal(fused.keys[:n], oracle.keys[:n])
    assert torch.equal(fused.payload[:, :n], oracle.payload[:, :n])


# -- this port's own contract: sharded operands on the card ---------------------------------
OPERAND_DIMS = (64, 64, 64)


def test_sharded_operand_matrix_on_cuda(card):
    """Every tier taking a slab-sharded operand (8 slabs of the one card,
    parallel/shard_value) answers the single-device call exactly and the
    set oracle |A n B|, in both orders where the reference answers both; the
    pairs the reference refuses raise TypeError with the single call's
    message; extraction of the sharded maps equals the single maps'."""
    from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
    from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
    from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld, make_grid_mesh, shard_map_value
    from gpu_voxels_tpu_torch.parallel.shard_value import ShardedDenseMap, _joined
    from gpu_voxels_tpu_torch.vis import extract

    mesh = make_grid_mesh(8, devices=[card])
    rng = np.random.default_rng(11)
    pa = rng.uniform(0.5, 63.5, (4000, 3)).astype(np.float32)
    pb = rng.uniform(0.5, 63.5, (4000, 3)).astype(np.float32)
    pb[:800] = pa[:800]
    vox = [{tuple(v) for v in np.floor(p).astype(np.int64)} for p in (pa, pb)]
    oracle = len(vox[0] & vox[1])
    lists = {"bitlist": ("bit", "linear"), "mortonlist": ("bit", "morton"), "problist": ("prob", "linear"),
             "countlist": ("count", "linear")}
    dense = {"prob": ProbVoxelMap, "bit": BitVectorVoxelMap, "hierbit": HierarchicalBitMap,
             "hierprob": HierarchicalProbMap}

    def make(kind, pts):
        if kind in lists:
            k, mode = lists[kind]
            return VoxelList.create(OPERAND_DIMS, 1.0, kind=k, capacity=8192, id_mode=mode,
                                    device=card).insert_point_cloud(pts)
        return dense[kind].create(OPERAND_DIMS, 1.0, device=card).insert_point_cloud(pts)

    a = {k: make(k, pa) for k in list(dense) + list(lists)}
    b = {k: make(k, pb) for k in list(dense) + list(lists)}
    for side in (a, b):
        side["paged"] = PagedHierarchicalMap(OPERAND_DIMS, 1.0, device=card)
        side["paged"].insert_point_cloud(pa if side is a else pb)
    world = ShardedPagedWorld(OPERAND_DIMS, 1.0, devices=[card])
    world.insert_point_cloud(pa)
    sa = {k: shard_map_value(a[k], mesh) for k in dense}
    sb = {k: shard_map_value(b[k], mesh) for k in dense}

    def count(r):
        return int(r[0] if isinstance(r, tuple) else r)

    def equal(x, y):
        if isinstance(y, tuple):
            return len(x) == len(y) and all(equal(p, q) for p, q in zip(x, y))
        if isinstance(y, torch.Tensor):
            return torch.equal(x, y)
        x = _joined(x, card) if isinstance(x, ShardedDenseMap) else x
        return torch.equal(x.data, y.data) and (getattr(y, "occ", None) is None or torch.equal(x.occ, y.occ))

    checked = 0
    for an in a:
        for bn in b:
            for call in ("collide_with", "collide_with_resolution", "collide_with_counting_unknown",
                         "collide_with_dense"):
                if not hasattr(a[an], call) or (call == "collide_with_dense" and bn not in ("prob", "bit")):
                    continue
                forms = [(a[an], sb[bn])] if bn in dense else []
                forms += [(sa[an], b[bn])] if an in dense else []
                forms += [(sa[an], sb[bn])] if an in dense and bn in dense else []
                if an == "paged" and bn in ("prob", "bit") and call != "collide_with_resolution":
                    forms.append((world, sb[bn]))  # the world has no collide_with_resolution
                try:
                    want = getattr(a[an], call)(b[bn])
                except TypeError as e:  # dense x list, dense x octree
                    for x, y in forms:
                        with pytest.raises(TypeError) as err:
                            getattr(x, call)(y)
                        assert str(err.value) == str(e), (an, bn, call)
                    continue
                for x, y in forms:
                    got = getattr(x, call)(y)
                    assert equal(got, want), (an, bn, call)
                    assert count(got) == oracle, (an, bn, call)
                    checked += 1
    # the dense calls that return maps: plain x sharded keeps self's plain layout
    sv = {k: BitVectorVoxelMap.create(OPERAND_DIMS, 1.0, device=card).insert_point_cloud(p, m)
          for k, p, m in (("a", pa, 10), ("b", pb, 12))}
    map_calls = [(a["prob"], b["prob"], "collide_with_marking", {"offset": (3, 1, -9)}),
                 (sv["a"], sv["b"], "collide_with_types", {"sv_window": 2}),
                 (sv["a"], b["prob"], "collide_with_types", {}),
                 (sv["a"], sv["b"], "collide_with_bitcheck", {"margin": 2}),
                 (a["prob"], b["prob"], "merge", {}),
                 (sv["a"], sv["b"], "merge", {"new_meaning": 20})]
    for x, y, call, kw in map_calls:
        want = getattr(x, call)(y, **kw)
        got = getattr(x, call)(shard_map_value(y, mesh), **kw)
        assert not any(isinstance(part, ShardedDenseMap) for part in (got if isinstance(got, tuple) else (got,)))
        assert equal(got, want), call
        assert equal(getattr(shard_map_value(x, mesh), call)(y, **kw), want), call
        checked += 2
    assert checked > 100
    for k in dense:
        for got, want in zip(extract.extract_cubes(sa[k], max_cubes=1000), extract.extract_cubes(a[k], max_cubes=1000)):
            assert np.array_equal(got, want), k


# -- this port's own contract: a DH chain's FK as one launch -------------------------------
WORKCELL = Path(__file__).resolve().parent.parent / "portbench" / "configs" / "ur10_ompl_workcell_150.json"
FK_ERR_VOX = 5e-5  # float32 against float64, in voxels of the workcell's 0.02 m
# kernel against the plain torch version on the card, in metres: each lies
# within 1e-6 m (FK_ERR_VOX) of float64, so within 2e-6 m of the other; they
# differ at all because cuBLAS, which the plain version's 4x4 and 3x3
# products call, may fuse and order the sums otherwise than the kernel's
# separately rounded, in-order sums
FK_PLAIN_ATOL = 2e-6


def _workcell_ur10(card):
    """The UR10 of the planner's workcell at its cloud spacing (the port's
    preset, whose DH table is the configuration's), and the configuration."""
    from gpu_voxels_tpu_torch.robot.presets import ur_robot

    cfg = json.loads(WORKCELL.read_text())
    robot = cfg["robot"]
    arm = ur_robot(robot["model"], robot["cloud_spacing_m"], device=card)
    table = [(p.d, p.a, p.alpha) for p in arm.dh.values()][:6]
    assert table == list(zip(robot["dh_d_m"], robot["dh_a_m"], robot["dh_alpha_rad"]))
    return arm, cfg


def _fk64(arm, values: torch.Tensor) -> torch.Tensor:
    """float64 [T, P, 3] of the chain for float32 values [T, L] on the card:
    the DH table's own (double) numbers, the products taken before each
    link's matrix."""
    v = values.double()
    acc, before = torch.eye(4, dtype=torch.float64, device=v.device).expand(len(v), 4, 4), []
    for i, p in enumerate(arm.dh[n] for n in arm.link_names):
        before.append(acc)
        q = v[:, i]
        d, theta = (p.d + q, p.theta + 0 * q) if p.joint_type == 1 else (p.d + 0 * q, p.theta + q)
        ct, st, ca, sa = torch.cos(theta), torch.sin(theta), np.cos(p.alpha), np.sin(p.alpha)
        z, o = torch.zeros_like(ct), torch.ones_like(ct)
        rows = [[ct, -st * ca, st * sa, p.a * ct], [st, ct * ca, -ct * sa, p.a * st],
                [z, z + sa, z + ca, d], [z, z, z, o]]
        acc = acc @ torch.stack([torch.stack(r, -1) for r in rows], -2)
    links = [arm.link_names.index(n) for n in arm.clouds.names]
    m = torch.stack([before[i] for i in links], 1)[:, arm.clouds.cloud_ids]
    return (m[..., :3, :3] @ arm.clouds.points.double()[:, :, None])[..., 0] + m[..., :3, 3]


@pytest.mark.parametrize("states", [1, 14, 34, 256, 70_000])
def test_dh_fk_one_launch_against_float64_on_cuda(card, states):
    """The workcell's UR10 at 1, 14, 34 (a motion check's batches), 256 and
    70,000 states (past 65,535): transformed_clouds_for and link_matrices are
    one launch each, with no host read; every point lies within 5e-5 voxel
    of float64 and, where the states fit the plain version, within
    FK_PLAIN_ATOL of it; and each point's voxel is float64's wherever
    float64 keeps 1e-3 voxel from a cell boundary (H4), which most points
    do."""
    from gpu_voxels_tpu_torch.robot import dh_cuda

    arm, cfg = _workcell_ur10(card)
    side = cfg["map"]["side_m"]
    rng = np.random.default_rng(states)
    lo, hi = np.asarray(cfg["joint_lower_rad"]), np.asarray(cfg["joint_upper_rad"])
    vals = np.zeros((states, 7), np.float32)
    vals[:, :6] = rng.uniform(lo, hi, (states, 6))
    vals = torch.from_numpy(vals).to(card)
    torch.cuda.synchronize()
    before = dict(kernels.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        pts = arm.transformed_clouds_for(vals).points
        mats = arm.link_matrices(vals)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert kernels.launches == {**before, "gv_dh_fk_points": before["gv_dh_fk_points"] + 1,
                                "gv_dh_chain": before["gv_dh_chain"] + 1}
    assert pts.shape == (states, arm.clouds.accumulated_size, 3) and mats.shape == (states, 7, 4, 4)
    worst, kept, same, total = 0.0, 0, 0, 0
    for i in range(0, states, 2048):
        ref = _fk64(arm, vals[i:i + 2048])
        got = pts[i:i + 2048].double()
        worst = max(worst, float((got - ref).abs().max()) / side)
        f = ref / side
        safe = ((f - torch.round(f)).abs() >= 1e-3).all(-1)
        kept += int(safe.sum())
        same += int((torch.floor(got / side) == torch.floor(f)).all(-1)[safe].sum())
        total += safe.numel()
    assert worst <= FK_ERR_VOX, worst
    assert same == kept and kept >= 0.9 * total, (same, kept, total)
    if states <= 256:
        table = (*arm._table, arm._point_cloud, arm.clouds.points)
        torch.testing.assert_close(pts, dh_cuda.dh_fk_points_plain(vals, *table), rtol=0, atol=FK_PLAIN_ATOL)
        torch.testing.assert_close(mats, dh_cuda.dh_chain_plain(vals, *arm._table), rtol=0, atol=FK_PLAIN_ATOL)


def test_dh_fk_chain_forms_on_cuda(card):
    """Every entry point of a CUDA chain takes the kernels: [L] values give
    [P, 3] points and [C, 4, 4] matrices, [A, B, L] values [A, B, P, 3]
    points equal to the same states' in a [T, L] batch; one state on the host (numpy, a
    dict by name, the stored configuration), which travels in the launch's
    arguments, gives the same points and matrices as on the card;
    set_configuration and update_point_cloud give transformed_clouds_for's
    points; a prismatic
    joint and clouds on a strict subset of the links agree with float64 and
    the plain version; an empty batch launches nothing; a CPU table takes
    the plain version, and CPU values beside a card's table are refused."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.robot import dh_cuda
    from gpu_voxels_tpu_torch.robot.dh import DHJointType, DHParameters, KinematicChain

    arm, cfg = _workcell_ur10(card)
    side = cfg["map"]["side_m"]
    params = [arm.dh[n] for n in arm.link_names]
    params[2] = DHParameters(0.1, 0.2, -0.5723, 0.3, joint_type=DHJointType.PRISMATIC)
    keep = [1, 3, 6]
    clouds = MetaPointCloud.from_clouds([arm.clouds.get_cloud(i).cpu().numpy() for i in keep],
                                        [arm.clouds.names[i] for i in keep], device=card)
    rng = np.random.default_rng(8)
    for chain in (arm, KinematicChain(arm.link_names, params, clouds)):
        vals = torch.from_numpy(rng.uniform(-np.pi, np.pi, (5, 7)).astype(np.float32)).to(card)
        cfg_ = {n: float(v) for n, v in zip(chain.link_names, vals[0].tolist())}
        host = vals[0].cpu().numpy()
        torch.cuda.synchronize()
        before = dict(kernels.launches)
        torch.cuda.set_sync_debug_mode("error")
        try:
            one = chain.transformed_clouds_for(vals[0]).points
            one_m = chain.link_matrices(vals[0])
            from_host, host_m = chain.transformed_clouds_for(host).points, chain.link_matrices(host)
            by_name = chain.transformed_clouds_for(cfg_).points
            chain.set_configuration(cfg_)
            stored = chain.get_transformed_clouds().points
            batch = chain.transformed_clouds_for(vals).points
            grid = chain.transformed_clouds_for(vals[:4].reshape(2, 2, 7)).points
            empty = chain.transformed_clouds_for(vals[:0]).points
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kernels.launches == {**before, "gv_dh_fk_points": before["gv_dh_fk_points"] + 6,
                                    "gv_dh_chain": before["gv_dh_chain"] + 2}
        assert one.shape == (chain.clouds.accumulated_size, 3) and one_m.shape == (chain.clouds.num_clouds, 4, 4)
        assert empty.shape == (0, chain.clouds.accumulated_size, 3)
        assert torch.equal(one, batch[0]) and torch.equal(by_name, one) and torch.equal(stored, one)
        assert torch.equal(grid, batch[:4].reshape(2, 2, -1, 3))
        assert torch.equal(from_host, one) and torch.equal(host_m, one_m)
        assert float((batch.double() - _fk64(chain, vals)).abs().max()) / side <= FK_ERR_VOX
        table = (*chain._table, chain._point_cloud, chain.clouds.points)
        torch.testing.assert_close(batch, dh_cuda.dh_fk_points_plain(vals, *table), rtol=0, atol=FK_PLAIN_ATOL)
        torch.testing.assert_close(one_m, dh_cuda.dh_chain_plain(vals[0], *chain._table), rtol=0,
                                   atol=FK_PLAIN_ATOL)
    arm.update_point_cloud("elbow_joint", arm.clouds.get_cloud(2)[:10].cpu().numpy())  # resized
    assert torch.equal(arm.get_transformed_clouds().points, arm.transformed_clouds_for(None).points)
    cpu_table = tuple(t.cpu() for t in arm._table)
    assert torch.equal(dh_cuda.dh_chain(vals.cpu(), *cpu_table), dh_cuda.dh_chain_plain(vals.cpu(), *cpu_table))
    with pytest.raises(ValueError, match="values must be on"):
        dh_cuda.dh_chain(vals.cpu(), *arm._table)


# -- this port's own contract: a depth frame's hits and update, one launch each ------------
CONFIGS = Path(__file__).resolve().parent.parent / "portbench" / "configs"
KINECT30 = CONFIGS.parent / "traffic" / "kinect30.json"
# the two update cells' configurations: the workcell monitor's 150 x 150 x 100
# at 0.02 m, and the distance cell's 256^3 at 0.01 m, whose world_offset_m
# moves boxes and camera alike (the same frames, the camera moved)
SENSE_CELLS = {"monitor": "ur10_kinect_workcell_150.json", "distance": "ur10_kinect_distance_256.json"}
# S1 against float64 and the plain version: equal at every voxel whose points
# keep this far, in voxels, from every cell boundary in float64. S1 divides
# in IEEE and sums in order; on the card the plain version multiplies by
# the reciprocal and cuBLAS orders its own sums: both lie ~1e-4 voxel or
# less from float64, so at most a point inside the band moves between them
HITS_BAND = 1e-3


def _sense_scene(card, cell: str, frames: int = 2):
    """(the workcell Kinect's frames as [H, W] float32 tensors on the card,
    its Sensor with the configuration's world offset, dims, side)."""
    from portbench.inputs import depth_frames

    from gpu_voxels_tpu_torch.sensors import Sensor

    cfg = json.loads((CONFIGS / SENSE_CELLS[cell]).read_text())
    scene = json.loads(KINECT30.read_text())["scene"]
    rendered = depth_frames(cfg, scene, frames, 2_100_000_021, card)
    s = cfg["sensor"]
    offset = np.asarray(cfg.get("world_offset_m", [0.0, 0.0, 0.0]), np.float32)
    sensor = Sensor(position=np.asarray(s["position_m"], np.float32) + offset,
                    orientation_rpy=np.asarray(s["rpy"], np.float32), data_width=s["width"],
                    data_height=s["height"], fx=s["fx"], fy=s["fy"], cx=s["cx"], cy=s["cy"],
                    invalid_value=s["invalid_value"])
    return [_t(f, card) for f in rendered], sensor, tuple(cfg["map"]["dims"]), cfg["map"]["side_m"]


def _intr(sensor) -> tuple:
    return float(sensor.fx), float(sensor.fy), float(sensor.cx), float(sensor.cy)


def _hits_band64(depth: torch.Tensor, pose, intr, side: float, dims, z0: int = 0) -> tuple:
    """(lo, hi) int64[N]: the fewest and the most of the frame's points each
    voxel can count, from the points in float64 (the float32 inputs and
    pose, the float32 reciprocal of the side): a point at least HITS_BAND
    voxel from every boundary counts in its voxel, one nearer in any voxel
    within HITS_BAND of it."""
    fx, fy, cx, cy = (float(np.float32(v)) for v in intr)
    h, w = depth.shape
    d = depth.double()
    u = torch.arange(w, dtype=torch.float64, device=depth.device)[None, :]
    v = torch.arange(h, dtype=torch.float64, device=depth.device)[:, None]
    pts = torch.stack([(u - cx) * d / fx, (v - cy) * d / fy, d], -1).reshape(-1, 3)
    valid = (depth != 0.0).reshape(-1) & torch.isfinite(pts).all(-1)
    m = torch.as_tensor(np.asarray(pose, np.float32), dtype=torch.float64, device=depth.device)
    f = (pts[valid] @ m[:3, :3].T + m[:3, 3]) * float(np.float32(1.0 / side))
    f[:, 2] -= z0
    sure = ((f - torch.round(f)).abs() >= HITS_BAND).all(-1)
    dx, dy, dz = dims

    def keys(c):
        c = c.to(torch.int64)
        inside = (c >= 0).all(-1) & (c[:, 0] < dx) & (c[:, 1] < dy) & (c[:, 2] < dz)
        return torch.where(inside, (c[:, 2] * dy + c[:, 1]) * dx + c[:, 0], -1)

    k = keys(torch.floor(f[sure]))
    lo = torch.bincount(k[k >= 0], minlength=dx * dy * dz)
    near = f[~sure]
    signs = [(a, b, c) for a in (-1, 1) for b in (-1, 1) for c in (-1, 1)]
    cand, _ = torch.sort(torch.stack([keys(torch.floor(near + HITS_BAND * near.new_tensor(sg))) for sg in signs], -1),
                         -1)
    first = torch.ones_like(cand, dtype=torch.bool)
    first[:, 1:] = cand[:, 1:] != cand[:, :-1]
    return lo, lo + torch.bincount(cand[first & (cand >= 0)], minlength=dx * dy * dz)


def _in_band(got: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> bool:
    return bool(((got >= lo) & (got <= hi)).all())


def _fusion_poses() -> list:
    """The main path's carve poses in its 256^3 grid at 0.02 m: axis-aligned
    at the z = 0 face, tilted, and at the centre (half the grid behind)."""
    bench = np.eye(4, dtype=np.float32)
    bench[:3, 3] = [2.56, 2.56, 0.1]
    return [bench, transforms.from_rpy_np([0.3, -0.2, 0.1], [2.0, 2.8, 0.3]),
            transforms.from_rpy_np([0.05, 0.1, 0.0], [2.56, 2.56, 2.56])]


@pytest.mark.parametrize("cell", ["monitor", "distance", "fusion"])
def test_depth_hits_one_launch_against_plain_and_float64_on_cuda(card, cell):
    """S1 on the workcell Kinect's frames at the update cells' grids (150 x
    150 x 100 at 0.02 m; 256^3 at 0.01 m, the camera moved by the world
    offset), or on its first frame at the main path's 256^3 at 0.02 m under
    its three carve poses ("fusion"), a frame with NaN, +inf and -inf
    pixels planted, and an all-invalid frame: one launch a call with no
    host read, the host pose (in the launch's arguments) equal to the same
    pose on the card, every count inside float64's band and equal to
    float64's and to the plain version's at every voxel whose points keep
    HITS_BAND voxel from every boundary; the frames hold invalid pixels and,
    at the update cells, points outside the map."""
    frames, sensor, dims, side = _sense_scene(card, cell if cell != "fusion" else "monitor")
    poses = [sensor.pose()] * len(frames)
    if cell == "fusion":
        frames, poses, dims = [frames[0]] * 3, _fusion_poses(), (256, 256, 256)
    planted = frames[0].clone()
    planted[100, 50:60] = torch.nan
    planted[200, 300:310] = torch.inf
    planted[300, 320] = -torch.inf
    frames += [planted, torch.zeros_like(planted)]
    poses += [poses[0]] * 2
    for i, (depth, pose) in enumerate(zip(frames, poses)):
        on_card = _t(pose, card)
        torch.cuda.synchronize()
        before = kernels.launches["gv_depth_hits"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = raycast_cuda.depth_hits(depth, pose, *_intr(sensor), side, dims)
            from_card = raycast_cuda.depth_hits(depth, on_card, *_intr(sensor), side, dims)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kernels.launches["gv_depth_hits"] == before + 2
        assert got.dtype == torch.int32 and got.shape == (dims[0] * dims[1] * dims[2],)
        assert torch.equal(got, from_card), i
        plain = raycast_cuda.depth_hits_plain(depth, on_card, *_intr(sensor), side, dims)
        lo, hi = _hits_band64(depth, pose, _intr(sensor), side, dims)
        sure = lo == hi
        assert _in_band(got, lo, hi) and _in_band(plain, lo, hi), i
        assert torch.equal(got[sure], lo[sure].to(torch.int32)) and torch.equal(got[sure], plain[sure]), i
        valid = int((torch.isfinite(depth) & (depth != 0.0)).sum())
        if i == len(frames) - 1:
            assert int(got.sum()) == 0
        else:
            assert 0 < int(got.sum()) <= valid and int((depth == 0.0).sum()) > 0, (i, int(got.sum()), valid)
            assert cell == "fusion" or int(got.sum()) < valid, (i, int(got.sum()), valid)
            assert int(sure.sum()) > 0.99 * got.numel(), i


def test_depth_hits_slabs_on_cuda(card):
    """S1 on 32-deep z-slabs of the distance cell's 256^3 grid at
    z_index_offset 0, 32 and 224: each slab's counts are the whole grid's
    rows [z0, z0 + 32) exactly, and inside float64's band against the plain
    version's slab; the pose given on the card."""
    frames, sensor, dims, side = _sense_scene(card, "distance", frames=1)
    depth, on_card = frames[0], _t(sensor.pose(), card)
    whole = raycast_cuda.depth_hits(depth, on_card, *_intr(sensor), side, dims).reshape(dims[2], -1)
    slab = (dims[0], dims[1], 32)
    for z0 in (0, 32, 224):
        got = raycast_cuda.depth_hits(depth, on_card, *_intr(sensor), side, slab, z_index_offset=z0)
        assert torch.equal(got, whole[z0:z0 + 32].reshape(-1)), z0
        plain = raycast_cuda.depth_hits_plain(depth, on_card, *_intr(sensor), side, slab, z_index_offset=z0)
        lo, hi = _hits_band64(depth, sensor.pose(), _intr(sensor), side, slab, z0)
        assert _in_band(got, lo, hi) and _in_band(plain, lo, hi), z0
        assert torch.equal(got[lo == hi], plain[lo == hi]), z0
    assert int(whole.sum()) > 0


@pytest.mark.parametrize("form", ["monitor", "distance", "ragged", "misaligned"])
def test_log_odds_update_byte_identical_on_cuda(card, form):
    """S2 against its plain version byte for byte on random int8 maps that
    hold -128, +-127 and values every count saturates, counts 0 to 5 and
    300,000, a random carve mask, with and without a robot mask; at the
    update cells' sizes, a length that is not a multiple of 16 and a map
    that is a view one byte off a 16-byte boundary (the voxel-a-thread
    form); one launch a call with no host read."""
    n = {"monitor": 150 * 150 * 100, "distance": 256**3, "ragged": 150 * 150 * 100 - 37,
         "misaligned": 150 * 150 * 100}[form]
    g = torch.Generator(device=card).manual_seed(n)
    offset = 1 if form == "misaligned" else 0
    data = torch.randint(-128, 128, (n + offset,), dtype=torch.int8, device=card, generator=g)[offset:]
    data[:6] = _t([-128, -127, 127, 126, -126, 120], card, torch.int8)
    counts = torch.randint(0, 6, (n,), dtype=torch.int32, device=card, generator=g)
    counts[5::1009] = 300_000
    free = torch.rand(n, device=card, generator=g) < 0.5
    robot = torch.rand(n, device=card, generator=g) < 0.1
    for mask in (None, robot):
        torch.cuda.synchronize()
        before = kernels.launches["gv_log_odds_update"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = raycast_cuda.log_odds_update(data, counts, free, mask)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert kernels.launches["gv_log_odds_update"] == before + 1
        want = raycast_cuda.log_odds_update_plain(data, counts, free, mask)
        assert got.dtype == torch.int8 and torch.equal(got, want), (form, mask is None)
        assert int((got == 127).sum()) > 0 and int((got == -127).sum()) > 0 and int((got == -128).sum()) > 0


def test_depth_insert_one_launch_each_and_refusals_on_cuda(card):
    """A ProbVoxelMap's depth insert on the card is S1, K3 and S2, one launch
    each, with no host read, equal to the plain hits and update on the same
    carve; the wrappers refuse what their kernels do not take."""
    from gpu_voxels_tpu_torch.ops import raycast

    frames, sensor, dims, side = _sense_scene(card, "monitor", frames=1)
    depth = frames[0]
    env = ProbVoxelMap.create(dims, side, device=card)
    names = ("gv_depth_hits", "gv_carve_exact", "gv_log_odds_update")
    torch.cuda.synchronize()
    before = {k: kernels.launches[k] for k in names}
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = env.insert_depth_image(depth, sensor)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert {k: kernels.launches[k] - before[k] for k in names} == dict.fromkeys(names, 1)
    pose = _t(sensor.pose(), card)
    hits = raycast_cuda.depth_hits(depth, pose, *_intr(sensor), side, dims)
    free = raycast_cuda.projective_free_space_exact(depth, pose, *_intr(sensor), side, dims)
    assert torch.equal(fused.data, raycast.log_odds_update(env.data, hits, free))
    assert int((fused.data > 0).sum()) > 0 and int(((fused.data < 0) & (fused.data > -128)).sum()) > 0

    n = dims[0] * dims[1] * dims[2]
    intr = _intr(sensor)
    bad_hits = [
        ((depth.double(), pose, *intr, side, dims), "float32"),
        ((depth.T, pose, *intr, side, dims), "contiguous"),
        ((depth, pose.double(), *intr, side, dims), "float32 \\[4, 4\\]"),
        ((depth, pose[:3].contiguous(), *intr, side, dims), "\\[4, 4\\]"),
        ((depth, sensor.pose()[:3], *intr, side, dims), "\\[4, 4\\]"),
        ((depth, pose, *intr, side, (2048, 1024, 1024)), "int32"),
    ]
    for args, msg in bad_hits:
        with pytest.raises(ValueError, match=msg):
            raycast_cuda.depth_hits(*args)
    with pytest.raises(ValueError, match="2\\^24"):
        raycast_cuda.depth_hits(depth, pose, *intr, side, dims, z_index_offset=2**24)
    data, counts = env.data, hits
    bad_update = [
        ((data.to(torch.int16), counts, free), "data"),
        ((data, counts.long(), free), "hit_counts"),
        ((data, counts, free.to(torch.uint8)), "free"),
        ((data, counts[:-1], free), "hit_counts"),
        ((data, counts, free, free[:-1]), "robot_occupied_mask"),
        ((data, counts.cpu(), free), "hit_counts must be on"),
        ((data, counts, free, torch.zeros(n, dtype=torch.bool)), "robot_occupied_mask must be on"),
        ((data.reshape(dims[2], -1), counts, free), "data"),
    ]
    for args, msg in bad_update:
        with pytest.raises(ValueError, match=msg):
            raycast_cuda.log_odds_update(*args)
