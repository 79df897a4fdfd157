"""Exact-count contracts of tests_tpu/test_tpu_contracts.py on the card.

Each test keeps its counterpart's name, `_on_tpu` read as `_on_cuda`, its
scale and its exact integers. Where the reference holds a compiled Pallas
kernel against its XLA formulation, the port's hand-written CUDA kernel is
held against its plain torch version on the same inputs, on the card. The
oracles are the reference's own: the linkage count 8000
(example_how_to_link/gvl_linkage_test_lib.cpp:20-38), differences3D == 0
(test/testing_distance.cu:79-119), bitMarginCollisionCheck's byte oracle
(helpers/BitVector.h:415-471), host brute force and set arithmetic. One
contract is this port's own: every map tier taking a slab-sharded operand
(parallel/shard_value) at 64^3 on the card.
"""
import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch import bitops
from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import SV_END, SV_START, BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxellist import VoxelList
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import collide_cuda, raycast_cuda


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
    before = collide_cuda.launches["count_prob_prob"]
    assert int(gvl.get_map("a").collide_with(gvl.get_map("b"))) == 8000
    assert collide_cuda.launches["count_prob_prob"] == before + 1
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
    before = collide_cuda.launches["count_prob_prob"]
    got = collide_cuda.count_prob_prob(ta, tb, t, t)
    assert collide_cuda.launches["count_prob_prob"] == before + 1
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
    before = collide_cuda.launches["collide_types_bit_bit"]
    assert int(a.collide_with_bitcheck(b, margin=2)) == 0  # steps 3 apart
    assert int(a.collide_with_bitcheck(b, margin=3)) == 1
    assert collide_cuda.launches["collide_types_bit_bit"] == before + 2


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
    before = raycast_cuda.launches["projective_free_space_exact"]
    got = raycast_cuda.projective_free_space_exact(*args)
    assert raycast_cuda.launches["projective_free_space_exact"] == before + 1
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
    before = collide_cuda.launches["collide_types_bit_bit"]
    assert int(a.collide_with_bitcheck(b, margin=1)) == 216  # 6^3 shared
    assert deconflict_slot([a, b, c], margin=1) == [0, 4, 8]
    robots = [("A", [("t", a)]), ("B", [("t", b)]), ("C", [("t", c)])]
    rescued = fit_schedule(robots, margin=1, windows_in_search=True)
    assert rescued[0][1] == [[0, 4, 8]]
    assert collide_cuda.launches["collide_types_bit_bit"] > before


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
