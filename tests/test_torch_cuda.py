"""The port's CUDA kernels K1-K7 against their plain torch versions.

This file imports torch and the port only (no JAX), so it also runs on a
machine with a card and no JAX:

    python -m pytest tests/test_torch_cuda.py -q

The tests marked `cuda` build the kernels with nvcc and need a CUDA device;
they skip elsewhere. The others check, without a card, that the ctypes
signatures match the C functions of csrc/ and that the build is keyed by
the sources.
"""
import re

import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch.geometry import transforms
from gpu_voxels_tpu_torch.ops import collide_cuda, edt_cuda, edt_envelope, raycast_cuda
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    return torch.device("cuda")


def test_ctypes_signatures_match_csrc():
    """Every bound C function exists in csrc/ with as many parameters."""
    found = {}
    for src in kernels._sources():
        for name, params in re.findall(r'extern "C" int (gv_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert found == {name: len(args) for name, args in kernels.SIGNATURES.items()}


def test_library_path_is_keyed_by_sources_and_flags():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR and path.name.startswith("libgvtorch_")
    assert kernels.library_path() == path
    assert "-fmad=false" in kernels.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def _carve_poses():
    """Axis-aligned, tilted, and inside the grid (half of it behind the camera)."""
    axis = np.eye(4, dtype=np.float32)
    axis[:3, 3] = [32, 32, 1]
    tilted = transforms.from_rpy_np([0.4, 0.0, 0.0], [20, 45, 3])
    inside = transforms.from_rpy_np([0.1, -0.2, 0.3], [32, 32, 32])
    return axis, tilted, inside


def _carve_scenes(dev):
    rng = np.random.default_rng(7)
    step = np.full((48, 64), 40.0, np.float32)
    step[:, 32:] = 20.0
    step[10:14, 5:9] = 0.0
    step[30:34, :] += rng.uniform(-5, 5, (4, 64)).astype(np.float32)
    noise = rng.uniform(5, 60, (48, 64)).astype(np.float32)
    noise[noise < 6] = 0.0
    for depth in (step, noise):
        for pose in _carve_poses():
            yield torch.tensor(depth, device=dev), torch.tensor(pose, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [(0, 0, 0), (-1, 0, -1), (3, -2, 1), (16, 0, 0)])
def test_k1_k2_match_plain_on_card(cuda_device, offset):
    """K1/K2 at a ragged size, incl. views whose addresses differ mod 16."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    dims = (67, 45, 39)
    n = dims[0] * dims[1] * dims[2]
    a = torch.randint(-128, 128, (n,), dtype=torch.int8, device=cuda_device, generator=g)
    b = torch.randint(-128, 128, (n,), dtype=torch.int8, device=cuda_device, generator=g)
    before = dict(collide_cuda.launches)
    for t1, t2 in ((-120, 0), (0, 0), (100, -50), (127, 127)):
        got = collide_cuda.count_prob_prob(a, b, t1, t2, dims, offset)
        assert got.dtype == torch.int64 and got.device == a.device
        assert int(got) == int(collide_cuda.count_prob_prob_plain(a, b, t1, t2, dims, offset))
        cnt, marked = collide_cuda.count_and_mark_prob(a, b, t1, t2, dims, offset)
        ref_c, ref_m = collide_cuda.count_and_mark_prob_plain(a, b, t1, t2, dims, offset)
        assert int(cnt) == int(ref_c)
        assert torch.equal(marked, ref_m)
    # same misalignment on both sides: the vector path's scalar head and tail
    x, y = a[7 : n - 5], b[7 : n - 5]
    assert int(collide_cuda.count_prob_prob(x, y, 0, 0)) == int(collide_cuda.count_prob_prob_plain(x, y, 0, 0))
    cnt, marked = collide_cuda.count_and_mark_prob(x, y, 0, 0)
    assert torch.equal(marked, collide_cuda.count_and_mark_prob_plain(x, y, 0, 0)[1])
    torch.cuda.synchronize()
    assert collide_cuda.launches["count_prob_prob"] == before["count_prob_prob"] + 5
    assert collide_cuda.launches["count_and_mark_prob"] == before["count_and_mark_prob"] + 5


@pytest.mark.cuda
def test_k3_matches_plain_on_card(cuda_device):
    """K3 bit for bit against the plain version on the card."""
    before = raycast_cuda.launches["projective_free_space_exact"]
    for i, (depth, pose) in enumerate(_carve_scenes(cuda_device)):
        got = raycast_cuda.projective_free_space_exact(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, (64, 64, 64))
        ref = raycast_cuda.projective_free_space_plain(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, (64, 64, 64))
        assert got.dtype == torch.bool and torch.equal(got, ref), i
    torch.cuda.synchronize()
    assert raycast_cuda.launches["projective_free_space_exact"] == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("z0", [0, 8, 40, 56])
def test_k3_z_index_offset_matches_plain_on_card(cuda_device, z0):
    """K3 on a z-slab of a larger grid (z_index_offset): bit for bit the
    plain version with the same offset, and eight 8-deep slabs stacked equal
    the whole 64^3 grid's mask."""
    slab = (64, 64, 8)
    for i, (depth, pose) in enumerate(_carve_scenes(cuda_device)):
        args = (depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0)
        got = raycast_cuda.projective_free_space_exact(*args, slab, z_index_offset=z0)
        assert torch.equal(got, raycast_cuda.projective_free_space_plain(*args, slab, z_index_offset=z0)), i
        whole = raycast_cuda.projective_free_space_exact(*args, (64, 64, 64))
        stacked = torch.cat([raycast_cuda.projective_free_space_exact(*args, slab, z_index_offset=k)
                             for k in range(0, 64, 8)])
        assert torch.equal(stacked, whole), i


@pytest.mark.cuda
def test_sharded_builders_match_single_device_on_card(cuda_device):
    """Every multi-device builder with its 8 slabs on the card (the default
    mesh: slabs round-robin over the visible cards) equals the single-device
    call on the card, and launches its kernels (K1, K3, K5, K7)."""
    from gpu_voxels_tpu_torch.constants import float_to_probability
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
    from gpu_voxels_tpu_torch.ops import edt, edt_envelope, raycast
    from gpu_voxels_tpu_torch.parallel import (build_sharded_bit_cycle, build_sharded_cycle,
                                               build_sharded_sensor_cycle, make_grid_mesh, shard_map_value)
    from gpu_voxels_tpu_torch.parallel.sharded_edt import build_sharded_edt
    from gpu_voxels_tpu_torch.parallel.sharded_edt_exact import build_sharded_parallel_banding

    mesh = make_grid_mesh(8)
    assert mesh.z_devices()[0].type == "cuda"
    dims = (64, 64, 64)
    rng = np.random.default_rng(3)
    pa = torch.tensor(rng.uniform(0, 64, (4000, 3)).astype(np.float32), device=cuda_device)
    pb = torch.cat([pa[:1500], torch.tensor(rng.uniform(0, 64, (2000, 3)).astype(np.float32), device=cuda_device)])
    before = {k: dict(m.launches) for k, m in (("c", collide_cuda), ("r", raycast_cuda), ("e", edt_cuda))}
    a = ProbVoxelMap.create(dims, device=cuda_device).insert_point_cloud(pa)
    b = ProbVoxelMap.create(dims, device=cuda_device).insert_point_cloud(pb)
    assert int(build_sharded_cycle(mesh, dims, 1.0, 0.5)(pa, pb)) == int(a.collide_with(b, 0.5)) > 0
    bits = [BitVectorVoxelMap.create(dims, device=cuda_device).insert_point_cloud(p) for p in (pa, pb)]
    assert int(build_sharded_bit_cycle(mesh, dims, 1.0)(pa, pb)) == int(bits[0].collide_with(bits[1])) > 0
    sa = shard_map_value(a, mesh)
    for off in ((0, 0, 0), (1, -2, 9), (0, 0, -13)):
        assert int(sa.collide_with(b, 0.5, off)) == int(a.collide_with(b, 0.5, off))
    for depth, pose in _carve_scenes(cuda_device):
        unknown = ProbVoxelMap.create(dims, device=cuda_device).data
        sensed = raycast.insert_depth_image(unknown, depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, dims)
        t = float_to_probability(0.6)
        want = int(collide_cuda.count_prob_prob(sensed, b.data, t, t))
        got = build_sharded_sensor_cycle(mesh, dims, 1.0, 52.0, 52.0, 32.0, 24.0, 0.6)(depth, pose, b.data)
        assert int(got) == want, (int(got), want)
    mask = torch.tensor(rng.random(64**3) < 0.002, device=cuda_device)
    packed = edt.init_from_obstacle_mask(mask, dims)
    slabs = build_sharded_parallel_banding(mesh, dims)(packed)
    assert torch.equal(torch.cat(slabs), edt_envelope.parallel_banding(packed, dims))
    jfa = torch.cat(build_sharded_edt(mesh, dims)(packed))
    # the sharded repair runs to its fixpoint: so does the single-device one
    # here, with the same fine steps and a cap it does not reach
    fixpoint, rounds = edt.jump_flood_multires_with_stats(packed, dims, fine_steps=(8, 4, 2, 1, 1), max_iters=4096)
    assert rounds < 4096
    assert torch.equal(edt.squared_distance_grid(jfa, dims), edt.squared_distance_grid(fixpoint, dims))
    torch.cuda.synchronize()
    assert collide_cuda.launches["count_prob_prob"] > before["c"]["count_prob_prob"]
    assert collide_cuda.launches["count_bit_bit"] > before["c"]["count_bit_bit"]
    assert raycast_cuda.launches["projective_free_space_exact"] > before["r"]["projective_free_space_exact"]
    assert edt_cuda.launches["envelope_pass"] >= before["e"]["envelope_pass"] + 16


@pytest.mark.cuda
def test_sharded_world_and_values_match_single_device_on_card(cuda_device):
    """A ShardedPagedWorld of 4 slabs on the card against the single paged
    map, and a sharded bit map's types collide (K4) against the single one."""
    from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap
    from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld, assert_sharded, make_grid_mesh, shard_map_value

    rng = np.random.default_rng(5)
    pts = (rng.uniform(0, 1, (3000, 3)) * np.asarray([64, 64, 512])).astype(np.float32)
    world = ShardedPagedWorld((64, 64, 512), 1.0, devices=[cuda_device] * 4)
    single = PagedHierarchicalMap((64, 64, 512), 1.0, device=cuda_device)
    for m in (world, single):
        m.insert_point_cloud_with_free_space(pts, (32.5, 32.5, 100.5), max_steps=256)
    world.assert_distributed()
    q = torch.tensor(rng.integers([0, 0, 0], [64, 64, 512], (4096, 3)).astype(np.int32), device=cuda_device)
    assert world.n_tiles() == single.n_tiles() and torch.equal(world.probe_status(q), single.probe_status(q))
    assert int(world.collide_with_coords(q)) == int(single.collide_with_coords(q))
    mesh = make_grid_mesh(8)
    a = BitVectorVoxelMap.create((64, 64, 64), device=cuda_device).insert_point_cloud(pts[:, :3] % 64, 40)
    b = BitVectorVoxelMap.create((64, 64, 64), device=cuda_device).insert_point_cloud(pts[::-1] % 64, 42)
    before = collide_cuda.launches["collide_types_bit_bit"]
    cnt, meanings, marked = shard_map_value(a, mesh).collide_with_types(b, 1.0, 5)
    w_cnt, w_meanings, w_marked = a.collide_with_types(b, 1.0, 5)
    assert int(cnt) == int(w_cnt) and torch.equal(meanings, w_meanings)
    assert_sharded(marked, mesh)
    assert torch.equal(marked.gather().data, w_marked.data)
    assert collide_cuda.launches["collide_types_bit_bit"] == before + 9  # 8 slabs, then the single call


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(3, 40, 30), (250, 64, 12), (1, 40, 70), (130, 33, 40)])
def test_k3_ragged_rows_match_plain_on_card(cuda_device, dims):
    """K3's row kernel where a row is no multiple of a thread's 8 voxels (the
    last thread of a row stores bytes) and where dx is no multiple of 8, so
    that rows start at addresses that are not 8-byte aligned (those rows
    store bytes throughout). The wrapper allocates the mask itself and takes
    no output view, so a misaligned row can only come from dx."""
    carved = 0
    for i, (depth, pose) in enumerate(_carve_scenes(cuda_device)):
        got = raycast_cuda.projective_free_space_exact(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, dims)
        ref = raycast_cuda.projective_free_space_plain(depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0, dims)
        assert got.shape == (dims[0] * dims[1] * dims[2],) and torch.equal(got, ref), i
        carved += int(got.sum())
    assert carved > 0


@pytest.mark.cuda
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda_device):
    a = torch.zeros(100, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError):
        collide_cuda.count_prob_prob(a, torch.zeros(100, dtype=torch.int8), 0, 0)
    with pytest.raises(TypeError):
        collide_cuda.count_prob_prob(a, torch.zeros(100, dtype=torch.int16, device=cuda_device), 0, 0)
    with pytest.raises(ValueError):
        collide_cuda.count_and_mark_prob(a[::2], a[::2], 0, 0)
    depth = torch.ones((4, 4), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        raycast_cuda.projective_free_space_exact(depth, torch.eye(4), 1.0, 1.0, 2.0, 2.0, 1.0, (4, 4, 4))


def _bit_fixture(n, seed, device):
    """Dense-random words zeroed per voxel with p = 0.7, bit 31 set in some
    words, plus the bit-0-only hazard voxel of a against an SV bit of b."""
    rng = np.random.default_rng(seed)
    words = []
    for _ in range(2):
        w = rng.integers(0, 2**32, (8, n), dtype=np.uint64).astype(np.uint32)
        w *= (rng.random(n) < 0.3).astype(np.uint32)
        words.append(w)
    a, b = words
    a[:, 5], b[:, 5] = 0, 0
    a[0, 5] = 1  # occupancy 0: eBVM_FREE only
    b[0, 5] = 1 << 6
    return (torch.tensor(a.view(np.int32), device=device), torch.tensor(b.view(np.int32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("margin", [0, 1, 4, 8, 24])
def test_k4_matches_plain_on_card(cuda_device, margin):
    """K4 equals its plain version exactly on count, meanings and marked map,
    at a length that is not a multiple of the block size."""
    a, b = _bit_fixture(100_003, margin, cuda_device)
    before = collide_cuda.launches["collide_types_bit_bit"]
    for mark in (True, False):
        cnt, meanings, new = collide_cuda.collide_types_bit_bit(a, b, margin, mark)
        ref_c, ref_m, ref_new = collide_cuda.collide_types_bit_bit_plain(a, b, margin, mark)
        assert cnt.dtype == torch.int64 and meanings.dtype == torch.int32
        assert int(cnt) == int(ref_c) > 0
        assert torch.equal(meanings, ref_m) and torch.equal(new, ref_new)
        assert (new.data_ptr() != a.data_ptr()) == mark
    torch.cuda.synchronize()
    assert collide_cuda.launches["collide_types_bit_bit"] == before + 2


def _bit_list(keys, payload, count):
    from gpu_voxels_tpu_torch.maps.voxellist import VoxelList

    return VoxelList(keys, payload, torch.tensor(count, device=keys.device), (128, 128, 64), 1.0, "bit")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [307_201, 1, 0])
def test_k4_as_the_list_bit_check_on_ragged_lengths(cuda_device, c):
    """VoxelList.collide_with_bitcheck at sv_offset 0 launches K4 on the
    list's payload and the matched partner payload, its unmatched columns
    zeroed, at list lengths that are no multiple of the block: the count
    equals bit_margin_collision_check_packed over the matched entries, and
    the same call on CPU copies. An empty list counts 0 without a launch."""
    from gpu_voxels_tpu_torch import bitops

    g = torch.Generator(device=cuda_device).manual_seed(c)
    n = 128 * 128 * 64
    mine = torch.randperm(n, device=cuda_device, generator=g)[:c].sort().values
    theirs = torch.cat([mine[::2], torch.randint(0, n, (c // 3,), device=cuda_device, generator=g)]).unique()
    words = lambda k: torch.randint(-(2**31), 2**31 - 1, (8, k), dtype=torch.int32, device=cuda_device,  # noqa: E731
                                    generator=g) * (torch.rand(k, device=cuda_device, generator=g) < 0.5)
    a = _bit_list(mine, words(c), c)
    b = _bit_list(theirs, words(theirs.numel()), theirs.numel())
    for margin in (0, 1, 24):
        before = collide_cuda.launches["collide_types_bit_bit"]
        got = a.collide_with_bitcheck(b, margin)
        torch.cuda.synchronize()
        assert collide_cuda.launches["collide_types_bit_bit"] == before + (c > 0)
        mask, partner = a.find_matching(b)
        hit, _ = bitops.bit_margin_collision_check_packed(a.payload, torch.where(mask[None, :], partner, 0), margin)
        want = int((hit & mask).sum())
        assert int(got) == want == int(a.to("cpu").collide_with_bitcheck(b.to("cpu"), margin))
        assert c < 1000 or want > 0


def _hazard_maps(n, device):
    """tests/test_collide_pallas.py:91-127's fixtures at length n, in its
    rng order: {density: (a, b)}, single random bits, and voxel 5 holding
    only eBVM_FREE in a (summary 0) where b holds SV bit 6."""
    rng = np.random.default_rng(11)
    out = {}
    for density in (0.0, 0.002, 0.2):
        a = np.zeros((8, n), np.uint32)
        b = np.zeros((8, n), np.uint32)
        k = max(1, int(n * density))
        ia, ib = rng.choice(n, k, replace=False), rng.choice(n, k, replace=False)
        a[rng.integers(0, 8, k), ia] = np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32)
        b[rng.integers(0, 8, k), ib] = np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32)
        a[0, 5] = 1
        b[0, 5] = 1 << 6
        out[density] = tuple(torch.from_numpy(x.view(np.int32)).to(device) for x in (a, b))
    return out


def _k4_gated_against_plain(a, b, margin, occ_a, occ_b, b_valid=None):
    """K4 with a mark and count only on one input against the plain
    version; one launch a call. Returns the count."""
    from gpu_voxels_tpu_torch import bitops

    if occ_a is not None:
        live = collide_cuda.k4_live_mask(a, occ_a, occ_b, margin)
        hit, _ = bitops.bit_margin_collision_check_packed(a, b, margin)
        assert not bool((hit & ~live).any())
    ref_c, ref_m, ref_new = collide_cuda.collide_types_bit_bit_plain(a, b, margin, True, b_valid=b_valid)
    before = collide_cuda.launches["collide_types_bit_bit"]
    got = [collide_cuda.collide_types_bit_bit(a, b, margin, mark, occ_a, occ_b, b_valid=b_valid)
           for mark in (True, False)]
    torch.cuda.synchronize()
    assert collide_cuda.launches["collide_types_bit_bit"] == before + 2
    for (cnt, meanings, new), mark in zip(got, (True, False)):
        assert int(cnt) == int(ref_c) and torch.equal(meanings, ref_m), (margin, mark)
        assert torch.equal(new, ref_new if mark else a), (margin, mark)
    return int(ref_c)


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.0, 0.002, 0.2])
@pytest.mark.parametrize("n", [256 ** 3, 100_003], ids=["256^3", "ragged"])
def test_k4_gated_matches_plain_on_card(cuda_device, n, density):
    """K4 gated by both summaries equals its plain version (which reads
    every voxel) on the reference's hazard fixtures, the bit-0-only voxel at
    margins 0, 3, 4 and 8 included, with a mark and count only."""
    from gpu_voxels_tpu_torch import bitops

    a, b = _hazard_maps(n, cuda_device)[density]
    occ_a, occ_b = bitops.occupied(a).to(torch.uint8), bitops.occupied(b).to(torch.uint8)
    counts = {m: _k4_gated_against_plain(a, b, m, occ_a, occ_b) for m in (0, 3, 4, 8)}
    assert counts[8] >= 1  # the window of b's bit 6 reaches a's bit 0 at voxel 5


@pytest.mark.cuda
def test_k4_gated_on_conservative_dead_and_misaligned_summaries(cuda_device):
    """A summary of ones, all-dead maps, summaries one byte off a 16-byte
    boundary and a list's match mask (alone and with summaries) at 256^3."""
    from gpu_voxels_tpu_torch import bitops

    n = 256 ** 3
    a, b = _bit_fixture(n, 5, cuda_device)
    occ = lambda x: bitops.occupied(x).to(torch.uint8)  # noqa: E731
    ones, dead = torch.ones(n, dtype=torch.uint8, device=cuda_device), torch.zeros_like(a)
    assert _k4_gated_against_plain(a, b, 5, ones, ones) > 0
    assert _k4_gated_against_plain(a, b, 5, None, None) > 0  # ungated
    assert _k4_gated_against_plain(dead, b, 8, occ(dead), occ(b)) == 0
    assert _k4_gated_against_plain(a, dead, 8, occ(a), occ(dead)) == 0
    sa, sb = a[:, 1:].contiguous(), b[:, 1:].contiguous()
    assert _k4_gated_against_plain(sa, sb, 4, occ(a)[1:], occ(b)[1:]) > 0
    valid = torch.rand(n, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(3)) < 0.3
    ref_c, ref_m, _ = collide_cuda.collide_types_bit_bit_plain(a, b, 5, False, b_valid=valid)
    cnt, meanings, _ = collide_cuda.collide_types_bit_bit(a, b, 5, False, b_valid=valid)
    assert int(cnt) == int(ref_c) > 0 and torch.equal(meanings, ref_m)
    assert _k4_gated_against_plain(a, b, 4, occ(a), occ(b), valid) > 0
    with pytest.raises(ValueError):  # a summary of another length
        collide_cuda.collide_types_bit_bit(a, b, 0, True, ones[1:], ones)
    with pytest.raises(ValueError):  # a summary that is not one byte a voxel
        collide_cuda.collide_types_bit_bit(a, b, 0, True, ones.int(), ones)


@pytest.mark.cuda
def test_live_streaming_loop_sustains_30hz(cuda_device, tmp_path, monkeypatch):
    """The live loop (robot_vs_environment: a 60 Hz StreamingDepthSource ->
    640x480 exact-carve fusion into 256^3 -> DH robot insert -> collide ->
    async visualize publish) sustains >= 30 Hz with the publish on, the
    contract of tests_tpu/test_examples_tpu.py:38-56, and both providers
    paint during the loop."""
    from gpu_voxels_tpu_torch.examples import robot_vs_environment

    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path))
    out = robot_vs_environment.main(frames=90, live_vis=True, device=cuda_device)
    assert out["processed"] >= 80  # at most a few frames dropped
    assert out["sustained_hz"] >= 30.0, out
    assert max(out["counts"]) >= 0 and len(out["counts"]) == out["processed"]
    assert min(out["painted"]) >= 1, out


@pytest.mark.cuda
def test_k4_raises_on_inputs_it_does_not_take(cuda_device):
    a = torch.zeros((8, 100), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        collide_cuda.collide_types_bit_bit(a, a.to(torch.int64), 0)
    with pytest.raises(ValueError):
        collide_cuda.collide_types_bit_bit(a, a.cpu(), 0)
    with pytest.raises(ValueError):
        collide_cuda.collide_types_bit_bit(a, a, 25)
    with pytest.raises(ValueError):
        collide_cuda.collide_types_bit_bit(a[:, ::2], a[:, ::2], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(64, 32, 20), (67, 45, 39)], ids=["n%4==0", "ragged-n"])
def test_k7_matches_plain_on_card(cuda_device, dims):
    """K7 equals the plane fold exactly over offsets: those that keep both
    slices at one address mod 16 (the vector variant), those that do not, and
    a ragged N (the scalar variant); the eBVM_FREE-only voxel never counts."""
    n = dims[0] * dims[1] * dims[2]
    a, b = _bit_fixture(n, 11, cuda_device)
    b[0, 5] = 1  # both sides hold only bit 0 of plane 0 at voxel 5
    a[:, 9], b[:, 9] = 0, 0
    a[7, 9], b[7, 9] = -(2**31), -(2**31)  # only bit 31 of plane 7: counts
    before = collide_cuda.launches["count_bit_bit"]
    offsets = [(0, 0, 0), (4, 0, 0), (-8, 1, 0), (1, 0, 0), (3, -2, 1), (-1, 0, -1), (0, 0, dims[2] - 1)]
    for off in offsets:
        got = collide_cuda.count_bit_bit(a, b, dims, off)
        assert got.dtype == torch.int64 and got.device == a.device and got.ndim == 0
        assert int(got) == int(collide_cuda.count_bit_bit_plain(a, b, dims, off)) > 0, off
    assert int(collide_cuda.count_bit_bit(a, b)) == int(collide_cuda.count_bit_bit_plain(a, b))
    zero = torch.zeros_like(a)
    assert int(collide_cuda.count_bit_bit(a, zero)) == 0 and int(collide_cuda.count_bit_bit(zero, zero)) == 0
    one = torch.zeros((8, 1), dtype=torch.int32, device=cuda_device)
    one[3, 0] = 1
    assert int(collide_cuda.count_bit_bit(one, one)) == 1
    torch.cuda.synchronize()
    assert collide_cuda.launches["count_bit_bit"] == before + len(offsets) + 4


@pytest.mark.cuda
def test_k7_raises_on_inputs_it_does_not_take(cuda_device):
    a = torch.zeros((8, 100), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        collide_cuda.count_bit_bit(a, a.to(torch.int64))
    with pytest.raises(ValueError):
        collide_cuda.count_bit_bit(a, a.cpu())
    with pytest.raises(ValueError):
        collide_cuda.count_bit_bit(a[:, ::2], a[:, ::2])
    with pytest.raises(ValueError):
        collide_cuda.count_bit_bit(a, a[:, :50].contiguous())
    with pytest.raises(ValueError):
        collide_cuda.count_bit_bit(a[:4].contiguous(), a[:4].contiguous())


@pytest.mark.cuda
def test_raw_plane_maps_collide_through_k7(cuda_device):
    """A BitVectorVoxelMap without a summary counts through K7; with
    summaries on both sides it does not launch."""
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap

    dims = (16, 12, 10)
    a, b = _bit_fixture(dims[0] * dims[1] * dims[2], 12, cuda_device)
    raw_a, raw_b = BitVectorVoxelMap(a, dims, 1.0), BitVectorVoxelMap(b, dims, 1.0)
    sum_a, sum_b = BitVectorVoxelMap.from_planes(a, dims), BitVectorVoxelMap.from_planes(b, dims)
    before = collide_cuda.launches["count_bit_bit"]
    for off in ((0, 0, 0), (2, -1, 1)):
        expect = int(sum_a.collide_with(sum_b, offset=off))
        assert collide_cuda.launches["count_bit_bit"] == before
        assert int(raw_a.collide_with(raw_b, offset=off)) == expect > 0
        assert int(raw_a.collide_with(sum_b, offset=off)) == expect
        assert int(sum_a.collide_with(raw_b, offset=off)) == expect
        before += 3
    assert collide_cuda.launches["count_bit_bit"] == before


def k6_frames():
    """The pool's frames: random depths, the same cropped to 47x63 (neither
    side a multiple of 2, 4, 7 or 8), and one with NaN, -inf and +inf pixels
    beside an invalid patch."""
    rng = np.random.default_rng(8)
    noise = rng.uniform(5, 60, (48, 64)).astype(np.float32)
    special = noise.copy()
    for value, share in ((np.nan, 0.02), (-np.inf, 0.02), (np.inf, 0.05)):
        special[rng.random(special.shape) < share] = value
    special[40:48, 56:64] = np.inf  # a whole cell at P = 8
    special[10:14, 5:9] = 0.0
    return {"noise": noise, "cropped": np.ascontiguousarray(noise[:47, :63]), "special": special}


# An axis-aligned camera at the centre of a 64^3 grid's z = 0 face, 0.25 m
# voxels, fx = fy = 84 for a 64x48 frame: wx = (x - 32) * 0.25 and sz = z * 0.25
# hold exactly, so u = 32 + 84 * (x - 32) / z (v likewise) is an integer
# wherever z divides 84 * (x - 32). Voxel centres project exactly onto pooled
# cell edges and onto the image's edges (z = 21: u = 0 at x = 24, u = 64 at
# x = 40; z = 7: v = 0 at y = 30, v = 48 at y = 34).
EDGE_INTR, EDGE_SIDE, EDGE_DIMS = (84.0, 84.0, 32.0, 24.0), 0.25, (64, 64, 64)


def edge_pose():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [32.5 * EDGE_SIDE, 32.5 * EDGE_SIDE, 0.5 * EDGE_SIDE]
    return pose


def edge_frame():
    """Depths of 9.3 and 5.6 m (planes z of ~37 and ~22 voxels), 1 in 50 pixels invalid."""
    depth = np.full((48, 64), 9.3, np.float32)
    depth[8:30, 10:40] = 5.6
    depth[np.random.default_rng(4).random(depth.shape) < 0.02] = 0.0
    return depth


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 2, 4, 7, 8])
def test_k6_pool_matches_plain_on_card(cuda_device, pool):
    """K6's pool kernel against the plain min-pool, bit pattern for bit
    pattern (a NaN cell equals a NaN cell), for invalid values 0, NaN and one
    that occurs in the frame."""
    before = raycast_cuda.launches["min_pool_depth"]
    frames = k6_frames()
    for name, frame in frames.items():
        depth = torch.tensor(frame, device=cuda_device)
        for invalid in (0.0, float("nan"), float(frame[3, 3])):
            got = raycast_cuda.min_pool_depth(depth, pool, invalid)
            ref = raycast_cuda.min_pool_depth_plain(depth, pool, invalid)
            assert got.dtype == torch.float32 and got.shape == ref.shape, (name, invalid)
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), (name, invalid)
    torch.cuda.synchronize()
    assert raycast_cuda.launches["min_pool_depth"] == before + 3 * len(frames)


def _k6_cases(dev):
    """(depth, pose, intrinsics, side, dims) of K6's card tests."""
    for depth, pose in _carve_scenes(dev):
        yield depth, pose, (52.0, 52.0, 32.0, 24.0), 1.0, (64, 64, 64)
    frames = {name: torch.tensor(f, device=dev) for name, f in k6_frames().items()}
    axis, _, inside = (torch.tensor(p, device=dev) for p in _carve_poses())
    yield frames["noise"], axis, (52.0, 52.0, 32.0, 24.0), 1.0, (250, 64, 12)
    yield frames["cropped"], inside, (52.0, 52.0, 32.0, 24.0), 1.0, (64, 64, 64)
    yield frames["special"], axis, (52.0, 52.0, 32.0, 24.0), 1.0, (64, 64, 64)
    yield torch.tensor(edge_frame(), device=dev), torch.tensor(edge_pose(), device=dev), EDGE_INTR, EDGE_SIDE, \
        EDGE_DIMS


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [2, 4, 7, 8])
def test_k6_matches_plain_on_card(cuda_device, pool):
    """K6 (pool, then carve) bit for bit against the plain pooled carve, and
    inside K3's mask: the carve scenes, a ragged grid (dx = 250), a cropped
    frame, a frame with NaN and infinities, and the edge-aligned pose."""
    before = raycast_cuda.launches["projective_free_space_pooled"]
    cases = list(_k6_cases(cuda_device))
    for i, (depth, pose, intr, side, dims) in enumerate(cases):
        args = (depth, pose, *intr, side, dims)
        got = raycast_cuda.projective_free_space_pooled(*args, pool=pool)
        ref = raycast_cuda.projective_free_space_pooled_plain(*args, pool=pool)
        assert got.dtype == torch.bool and torch.equal(got, ref), i
        assert not bool((got & ~raycast_cuda.projective_free_space_exact(*args)).any()), i
        assert int(got.sum()) > 0, i
    torch.cuda.synchronize()
    assert raycast_cuda.launches["projective_free_space_pooled"] == before + len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [2, 4, 7, 8])
def test_k6_z_index_offset_matches_plain_on_card(cuda_device, pool):
    """K6 on a z-slab of a larger grid: at offsets 0, 8, 40 and 56 bit for
    bit the plain version with the same offset (the wrapper and the carve
    against a prebuilt table), offset 0 equal to the call without one, and
    eight 8-deep slabs against one table stacked equal the whole 64^3
    grid's mask; one carve launch a slab."""
    slab = (64, 64, 8)
    for i, (depth, pose) in enumerate(_carve_scenes(cuda_device)):
        args = (depth, pose, 52.0, 52.0, 32.0, 24.0, 1.0)
        table = raycast_cuda.min_pool_depth(depth, pool)
        on_table = (table, pool, depth.shape, pose, 52.0, 52.0, 32.0, 24.0, 1.0, slab)
        for z0 in (0, 8, 40, 56):
            ref = raycast_cuda.projective_free_space_pooled_plain(*args, slab, pool=pool, z_index_offset=z0)
            assert torch.equal(raycast_cuda.projective_free_space_pooled(*args, slab, pool=pool, z_index_offset=z0),
                               ref), (i, z0)
            assert torch.equal(raycast_cuda.carve_against_pooled(*on_table, z_index_offset=z0), ref), (i, z0)
        assert torch.equal(raycast_cuda.carve_against_pooled(*on_table), raycast_cuda.carve_against_pooled(
            *on_table, z_index_offset=0)), i
        whole = raycast_cuda.projective_free_space_pooled(*args, (64, 64, 64), pool=pool)
        before = raycast_cuda.launches["projective_free_space_pooled"]
        stacked = torch.cat([raycast_cuda.carve_against_pooled(*on_table, z_index_offset=k) for k in range(0, 64, 8)])
        assert torch.equal(stacked, whole) and int(whole.sum()) > 0, i
        assert raycast_cuda.launches["projective_free_space_pooled"] == before + 8
    with pytest.raises(ValueError, match="2\\^24"):
        raycast_cuda.carve_against_pooled(*on_table, z_index_offset=2**24)


@pytest.mark.cuda
def test_sharded_dense_forms_match_single_device_on_card(cuda_device, tmp_path):
    """The slab forms of sharded dense maps with 8 slabs on the card against
    the single-device calls on the card: the depth insert at carve_pool 1
    (K3 a slab) and 8 (one pool, K6 a slab), the DDA, the marking collide
    (K2 a run of slabs) at offsets that cross slabs, the robot insert with
    the self-collision check, the distance tier's jump_flood (K5 a slab and
    pass), its queries, and a file written slab by slab."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
    from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh, shard_map_value

    mesh = make_grid_mesh(8)
    dims = (128, 128, 128)
    sensor = _fusion_sensor()
    rng = np.random.default_rng(9)
    frame = rng.uniform(1.0, 6.0, (48, 64)).astype(np.float32)
    single = ProbVoxelMap.create(dims, 0.05, device=cuda_device)
    sharded = shard_map_value(single, mesh)

    def same(got, want):
        assert_sharded(got, mesh)
        return torch.equal(got.gather().data, want.data)

    for pool, kernel in ((1, "projective_free_space_exact"), (8, "projective_free_space_pooled")):
        before = dict(raycast_cuda.launches)
        got = sharded.insert_depth_image(frame, sensor, carve_pool=pool)
        assert raycast_cuda.launches[kernel] == before[kernel] + 8
        assert raycast_cuda.launches["min_pool_depth"] == before["min_pool_depth"] + (pool > 1)
        assert same(got, single.insert_depth_image(frame, sensor, carve_pool=pool)), pool
    rays = sensor.process_depth_image(frame, device=cuda_device)
    assert same(sharded.insert_sensor_data(rays, sensor_origin=sensor.position),
                single.insert_sensor_data(rays, sensor_origin=sensor.position))
    pa = torch.tensor(rng.uniform(0, 6.4, (20000, 3)).astype(np.float32), device=cuda_device)
    a = single.insert_point_cloud(pa)
    b = single.insert_point_cloud(torch.cat([pa[:5000] + 0.05, pa[5000:9000]]))
    for off in ((0, 0, 0), (1, -2, 17), (-3, 0, -40)):
        before = collide_cuda.launches["count_and_mark_prob"]
        cnt, marked = shard_map_value(a, mesh).collide_with_marking(b, 0.5, off)
        w_cnt, w_marked = a.collide_with_marking(b, 0.5, off)
        assert int(cnt) == int(w_cnt) > 0 and same(marked, w_marked), off
        assert collide_cuda.launches["count_and_mark_prob"] > before + 8 - (off == (0, 0, 0))
    meta = MetaPointCloud.from_clouds([pa[:3000].cpu().numpy(), pa[2000:6000].cpu().numpy()], device=cuda_device)
    bits = BitVectorVoxelMap.create(dims, 0.05, device=cuda_device)
    got, ok = shard_map_value(bits, mesh).insert_robot_configuration(meta, True)
    w_map, w_ok = bits.insert_robot_configuration(meta, True)
    assert same(got, w_map) and torch.equal(got.gather().occ, w_map.occ) and bool(ok) == bool(w_ok) is False
    dist = DistanceVoxelMap.create(dims, 0.05, device=cuda_device).insert_point_cloud(pa[:300])
    before = edt_cuda.launches["envelope_pass"]
    field = shard_map_value(dist, mesh).jump_flood()
    assert edt_cuda.launches["envelope_pass"] == before + 16
    want = dist.jump_flood()
    assert same(field, want) and torch.equal(field.min_distance_to(pa[9000:]), want.min_distance_to(pa[9000:]))
    assert torch.equal(field.extract_distances(), want.extract_distances())
    assert torch.equal(field.init_floodfill(), want.init_floodfill())
    field.write_to_disk(tmp_path / "sharded.bin")
    want.write_to_disk(tmp_path / "single.bin")
    assert (tmp_path / "sharded.bin").read_bytes() == (tmp_path / "single.bin").read_bytes()
    assert same(field.read_from_disk(tmp_path / "sharded.bin"), want)


ENVELOPE_SHAPES = {
    # (7 * 33 = 231 lines along Y, 910 along X: neither a multiple of a warp
    # or a block; dx = 33 is no multiple of 32)
    "ragged": (7, 130, 33),
    "n1024-y": (4, 1024, 64),
    "n1024-x": (4, 64, 1024),
    "n1-y": (5, 1, 40),
    "n1-x": (5, 40, 1),
}


def _envelope_grids(kind, device):
    """int32 g (MISS = no site) and payloads; small values make many ties."""
    rng = np.random.default_rng(5)
    shape = ENVELOPE_SHAPES.get(kind, (6, 64, 40))
    g = rng.integers(0, 40, shape).astype(np.int32)
    if kind == "ties":
        g[:] = 0
        g[:, ::4, :] = edt_envelope.MISS
    elif kind == "empty":
        g[:] = edt_envelope.MISS
    elif kind == "dense-zero":  # every position a site, all at offset 0: the stack reaches depth n
        g[:] = 0
    elif kind not in ("dense", "n1-y", "n1-x"):  # those: every position a site
        g[rng.random(shape) < 0.9] = edt_envelope.MISS
    pay = rng.integers(0, 2**30, shape).astype(np.int32)
    return torch.tensor(g, device=device), torch.tensor(pay, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "empty", "ragged", "dense", "dense-zero", "n1024-y", "n1024-x",
                                  "n1-y", "n1-x"])
def test_k5_matches_plain_on_card(cuda_device, kind):
    """K5 equals the plain envelope on distances and payloads, along Y and X."""
    g, pay = _envelope_grids(kind, cuda_device)
    before = edt_cuda.launches["envelope_pass"]
    for axis in (1, 2):
        d, p = edt_cuda.envelope_pass(g, pay, axis)
        ref_d, ref_p = edt_cuda.envelope_pass_plain(g, pay, axis)
        assert d.dtype == torch.int32 and torch.equal(d, ref_d) and torch.equal(p, ref_p), axis
    torch.cuda.synchronize()
    assert edt_cuda.launches["envelope_pass"] == before + 2


@pytest.mark.cuda
def test_k5_holds_16_warps_per_sm(cuda_device):
    """Both arms of K5 at every stack size keep at least 16 warps on an SM."""
    for n in (256, 512, 1024):
        for c in (n, 1):
            occ = edt_cuda.envelope_occupancy(n, c)
            assert occ["warps_per_sm"] >= 16 and occ["local_bytes"] >= 8 * n, (n, c, occ)
            assert (occ["shared_bytes"] == 0) == (c != 1), (n, c, occ)


@pytest.mark.cuda
def test_k5_k6_raise_on_inputs_they_do_not_take(cuda_device):
    g = torch.zeros((4, 4, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        edt_cuda.envelope_pass(g, g.to(torch.int64))
    with pytest.raises(ValueError):
        edt_cuda.envelope_pass(g, g.cpu())
    with pytest.raises(ValueError):
        edt_cuda.envelope_pass(g, g, 0)
    with pytest.raises(ValueError):
        edt_cuda.envelope_pass(g.transpose(1, 2), g)
    with pytest.raises(ValueError):
        edt_cuda.envelope_pass(g[0], g[0])
    depth = torch.ones((4, 4), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError):
        raycast_cuda.projective_free_space_pooled(depth, torch.eye(4), 1.0, 1.0, 2.0, 2.0, 1.0, (4, 4, 4), pool=0)
    with pytest.raises(ValueError):
        raycast_cuda.projective_free_space_pooled(depth.double(), torch.eye(4), 1.0, 1.0, 2.0, 2.0, 1.0, (4, 4, 4))


def test_port_imports_no_jax():
    """Every module of the port, the octree tiers and the IO / visualization
    modules included, imports without JAX or the JAX package (the card's
    machine has neither)."""
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys, gpu_voxels_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'gpu_voxels_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'gpu_voxels_tpu.'))]\n"
            "assert not bad and {'gpu_voxels_tpu_torch.maps.paged', 'gpu_voxels_tpu_torch.vis.extract',\n"
            "                    'gpu_voxels_tpu_torch.robot.urdf', 'gpu_voxels_tpu_torch.compat',\n"
            "                    'gpu_voxels_tpu_torch.parallel.paged_world',\n"
            "                    'gpu_voxels_tpu_torch.parallel.sharded_edt_exact'} <= set(sys.modules), bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=str(kernels.BUILD_DIR.parent.parent))


def _fusion_sensor():
    from gpu_voxels_tpu_torch.sensors import Sensor

    return Sensor(position=np.asarray([3.2, 3.1, 0.05], np.float32),
                  orientation_rpy=np.asarray([0.05, -0.03, 0.02], np.float32), data_width=64, data_height=48,
                  fx=52.0, fy=52.0, cx=32.0, cy=24.0)


@pytest.mark.cuda
@pytest.mark.parametrize("pool", [1, 8])
@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_hierarchical_fusion_runs_k3_k6_and_matches_plain(cuda_device, monkeypatch, kind, pool):
    """Both dense tiers' insert_depth_image on the card: K3 (carve_pool 1) or
    K6 (carve_pool 8) launches once a frame, and the pyramid equals the same
    frames through the plain carves on the card and on the CPU."""
    from gpu_voxels_tpu_torch.maps import hierarchical

    cls = hierarchical.HierarchicalBitMap if kind == "bit" else hierarchical.HierarchicalProbMap
    sensor = _fusion_sensor()
    rng = np.random.default_rng(3)
    frames = [rng.uniform(1.0, 6.0, (48, 64)).astype(np.float32) for _ in range(2)]
    frames[1][5:9, 7:20] = 0.0

    def fuse(device):
        m = cls.create((80, 72, 66), 0.1, device=device)
        for f in frames:
            m = m.insert_depth_image(f, sensor, carve_pool=pool)
        return m

    name = "projective_free_space_exact" if pool == 1 else "projective_free_space_pooled"
    before = raycast_cuda.launches[name]
    card = fuse(cuda_device)
    torch.cuda.synchronize()
    assert raycast_cuda.launches[name] == before + 2
    cpu = fuse("cpu")
    monkeypatch.setattr(raycast_cuda, "projective_free_space_exact", raycast_cuda.projective_free_space_plain)
    monkeypatch.setattr(raycast_cuda, "projective_free_space_pooled", raycast_cuda.projective_free_space_pooled_plain)
    plain = fuse(cuda_device)
    for a, b, c in zip(card.pyramid, plain.pyramid, cpu.pyramid, strict=True):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
    assert card.check_tree() and int(hierarchical.decode_status_flags(card.pyramid[0])[2].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("prob", [False, True])
def test_paged_tier_and_checker_on_card_match_cpu(cuda_device, prob):
    """The paged tier on the card against the same calls on the CPU: the
    whole state after allocating inserts and a ray-carved frame, probes at
    every level band, and the hierarchical checker's counts."""
    from gpu_voxels_tpu_torch import interop
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.maps.paged import PagedHierarchicalMap
    from gpu_voxels_tpu_torch.planning import HierarchicalValidityChecker

    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 4096, (3000, 3)).astype(np.float32)
    rays = (np.array([2000.37, 2001.61, 1999.83], np.float32) + rng.uniform(-60, 60, (257, 3))).astype(np.float32)
    maps = {}
    for dev in (cuda_device, torch.device("cpu")):
        m = PagedHierarchicalMap((4096,) * 3, 1.0, probabilistic=prob, device=dev)
        m.insert_point_cloud(pts)
        m.insert_point_cloud(pts[:1000] * 0.5, 0)
        m.insert_point_cloud_with_free_space(rays, (2000.37, 2001.61, 1999.83), max_steps=128)
        maps[dev.type] = m
    card, cpu = (interop.to_numpy(maps[k]) for k in ("cuda", "cpu"))
    for key, value in cpu.items():
        got = card[key]
        assert (np.array_equal(got, value) if isinstance(value, np.ndarray) else
                all(np.array_equal(a, b) for a, b in zip(got, value)) if isinstance(value, list) else got == value), key
    q = np.floor(np.concatenate([pts[:500], rays[:200]])).astype(np.int32)
    for lvl in (0, 1, 3, 6, maps["cpu"].fine_levels):
        assert torch.equal(maps["cuda"].probe_status(q, lvl).cpu(), maps["cpu"].probe_status(q, lvl))
    cloud = MetaPointCloud.from_clouds([rng.uniform(-3, 3, (400, 3)).astype(np.float32)], device="cpu")

    class Translated:
        def __init__(self, dev):
            self.c = cloud.points.to(dev)

        def transformed_clouds_for(self, cfg):
            from dataclasses import replace

            return replace(cloud, points=self.c + torch.as_tensor(cfg, device=self.c.device)[..., None, :])

    states = np.floor(pts[:64]).astype(np.float32) + 0.37
    counts = [HierarchicalValidityChecker(maps[k], Translated(maps[k].device)).batch_colliding_voxels(states)
              for k in ("cuda", "cpu")]
    assert np.array_equal(*counts) and counts[0].sum() > 0


@pytest.mark.cuda
def test_compaction_and_extraction_on_the_card(cuda_device):
    """The device compaction and extract_cubes (a bit map with meanings on
    bit 31 of a plane, a prob map, the dense pyramid's multi-level cubes) on
    the card equal the same calls on the CPU."""
    from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
    from gpu_voxels_tpu_torch.ops.compact import compacted_nonzero
    from gpu_voxels_tpu_torch.vis.extract import extract_cubes, extract_multilevel_cubes

    rng = np.random.default_rng(12)
    mask = rng.random(1 << 22) < 0.01
    for cap in (None, 5, 1 << 20):
        got = compacted_nonzero(torch.from_numpy(mask).to(cuda_device), capacity=cap)
        assert np.array_equal(got, np.flatnonzero(mask)[:cap])
    dims = (96, 80, 64)
    pts = (np.floor(rng.uniform(0, 1, (20000, 3)) * np.asarray(dims)) + 0.5).astype(np.float32)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        b = BitVectorVoxelMap.create(dims, 0.5, device=dev)
        for k, meaning in enumerate((31, 63, 255, 7)):
            b = b.insert_point_cloud(pts[k * 5000:(k + 1) * 5000] * 0.5, meaning)
        p = ProbVoxelMap.create(dims, 0.5, device=dev).insert_point_cloud(pts * 0.5)
        h = HierarchicalBitMap.create((64, 64, 64), device=dev).insert_point_cloud(pts[:3000] % 64)
        out[dev.type] = [extract_cubes(b), extract_cubes(p, 0.5, max_cubes=1000), extract_multilevel_cubes(h)]
    for a, b in zip(out["cuda"], out["cpu"], strict=True):
        for x, y in zip(a, b, strict=True):
            assert np.array_equal(x, y)
    assert {31, 63, 255, 7} <= set(out["cuda"][0][1].tolist())


@pytest.mark.cuda
def test_facade_round_trip_on_the_card(cuda_device, tmp_path):
    """save_map on the card writes the CPU copy's file byte for byte, and
    load_map brings it back to the card equal; visualize_map publishes the
    same layer file as the CPU's."""
    from gpu_voxels_tpu_torch.api import GpuVoxels
    from gpu_voxels_tpu_torch.constants import MapType
    from gpu_voxels_tpu_torch.vis.provider import VisProvider

    pts = np.random.default_rng(13).uniform(0.5, 63.5, (5000, 3)).astype(np.float32)
    files = {}
    for dev in (cuda_device, torch.device("cpu")):
        g = GpuVoxels()
        g.initialize(64, 64, 64, 1.0, device=dev)
        for mt in (MapType.MT_BITVECTOR_VOXELMAP, MapType.MT_PROBAB_MORTON_VOXELLIST, MapType.MT_PROBAB_OCTREE):
            g.add_map(mt, mt.name)
            g.insert_point_cloud_into_map(pts, mt.name)
            path = tmp_path / f"{dev.type}_{mt.name}.bin"
            g.save_map(mt.name, path)
            files.setdefault(mt.name, []).append(path.read_bytes())
            g.load_map("back", path)
            back = tmp_path / f"{dev.type}_{mt.name}_back.bin"
            g.save_map("back", back)
            assert back.read_bytes() == path.read_bytes() and g.get_map("back").device.type == dev.type
            assert VisProvider(mt.name, tmp_path / dev.type).visualize(g.get_map(mt.name))
    for name, (card, cpu) in files.items():
        assert card == cpu, name
    for f in (tmp_path / "cpu").glob("*.cubes.json"):
        assert (tmp_path / "cuda" / f.name).read_bytes() == f.read_bytes(), f.name


def _hier_pose() -> np.ndarray:
    """A camera at the centre of the 5.12 m cube's z = 0 face, tilted, looking +z."""
    from gpu_voxels_tpu_torch.sensors import Sensor

    return Sensor(position=np.asarray([2.5612, 2.5587, 0.0213], np.float32),
                  orientation_rpy=np.asarray([0.031, -0.027, 0.013], np.float32)).pose()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bit", "prob"])
def test_sharded_hierarchy_fusion_runs_k3_k6_per_slab(cuda_device, kind):
    """A 640x480 frame into a sharded 512^3 hierarchy (8 slabs on the card):
    K3 once a slab at carve_pool 1; at 8, K6's pool once a frame and its
    carve once a slab; every level (and the occupancy) equals the
    single-device fusion on the card, and check_tree holds."""
    from gpu_voxels_tpu_torch.maps import hierarchical
    from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh, shard_map_value

    class Posed:
        fx, fy, cx, cy, invalid_value = 525.0, 525.0, 320.0, 240.0, 0.0

        def pose(self):
            return _hier_pose()

    cls = hierarchical.HierarchicalBitMap if kind == "bit" else hierarchical.HierarchicalProbMap
    mesh = make_grid_mesh(8)
    rng = np.random.default_rng(12)
    frame = rng.uniform(0.8, 4.5, (480, 640)).astype(np.float32)
    frame[100:140, 200:260] = 0.0
    single = cls.create((512, 512, 512), 0.01, device=cuda_device)
    sharded = shard_map_value(single, mesh)
    for pool, want_launches in ((1, {"projective_free_space_exact": 8}),
                                (8, {"projective_free_space_pooled": 8, "min_pool_depth": 1})):
        before = dict(raycast_cuda.launches)
        got = sharded.insert_depth_image(frame, Posed(), carve_pool=pool)
        ran = {name: n - before[name] for name, n in raycast_cuda.launches.items() if n != before[name]}
        assert ran == want_launches, (pool, ran)
        want = single.insert_depth_image(frame, Posed(), carve_pool=pool)
        assert_sharded(got, mesh)
        g = got.gather()
        assert all(torch.equal(a, b) for a, b in zip(g.pyramid, want.pyramid, strict=True)), pool
        assert kind == "bit" or torch.equal(g.occupancy, want.occupancy)
        assert got.check_tree() and int(hierarchical.decode_status_flags(want.pyramid[0])[2].sum()) > 0


@pytest.mark.cuda
def test_sharded_pyramid_build_at_1024_on_card(cuda_device):
    """BASELINE #5's environment (200,000 uniform obstacles at 1024^3, 1.0 m)
    built on a sharded pyramid, with and without the free box: every level
    equals the single-device build, and a 400-point robot's colliding
    voxels over 315 states equal the single-device checker's."""
    from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
    from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap
    from gpu_voxels_tpu_torch.parallel import assert_sharded, make_grid_mesh, shard_map_value
    from gpu_voxels_tpu_torch.planning import HierarchicalValidityChecker

    class Translated:
        def __init__(self, cloud):
            self.cloud = MetaPointCloud.from_clouds([cloud], device=cuda_device)

        def transformed_clouds_for(self, cfg):
            from dataclasses import replace

            cfg = torch.as_tensor(cfg, dtype=torch.float32, device=cuda_device)
            return replace(self.cloud, points=self.cloud.points + cfg[..., None, :])

    rng = np.random.default_rng(5)
    env = torch.tensor(rng.uniform(0, 1024, (200000, 3)).astype(np.float32), device=cuda_device)
    robot = Translated(rng.uniform(-2, 2, (400, 3)).astype(np.float32))
    states = rng.uniform(100.0, 900.0, (315, 3)).astype(np.float32)
    mesh = make_grid_mesh(8)
    single = HierarchicalBitMap.create((1024, 1024, 1024), 1.0, device=cuda_device)
    sharded = shard_map_value(single, mesh)
    for box in (False, True):
        got, want = sharded.build(env, box), single.build(env, box)
        assert_sharded(got, mesh)
        g = got.gather()
        assert all(torch.equal(a, b) for a, b in zip(g.pyramid, want.pyramid, strict=True)), box
        del g
        counts = HierarchicalValidityChecker(got, robot).batch_colliding_voxels(states)
        assert np.array_equal(counts, HierarchicalValidityChecker(want, robot).batch_colliding_voxels(states))
        assert counts.sum() > 0
