"""K4's occupancy gating and its list form, the maps' summaries, and the
live publisher's writer process.

* The reference's hazard fixtures (tests/test_collide_pallas.py:91-127): the
  same numpy maps at densities 0, 0.002 and 0.2, with a voxel of `a` that
  holds only eBVM_FREE (summary 0) where `b` holds SV bit 6, at margins 0,
  3, 4 and 8, with and without a mark. The port's
  `collide_types_bit_bit(..., occ_a, occ_b)` equals the reference's gated
  Pallas kernel (interpret mode on the CPU); the plain version over only
  `k4_live_mask`'s voxels gives the count and meanings it gives over all of
  them; the mask holds every hit voxel.
* The voxel lists' bit check hands K4 the match mask (`b_valid`) and the
  gathered partner payload as it is, and counts what the reference counts.
* A fuzz over the bit map's methods: after each one the summary holds every
  voxel whose planes are !noneButEmpty (a conservative summary is allowed,
  a missing voxel would lose its hits under gating).
* AsyncVisPublisher's writer process writes the same bytes as the
  in-process writers, surfaces a failure on flush() / stop(), and stop()
  leaves no child behind. The child is started once for the module.
"""
import filecmp
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps import voxellist as JL
from gpu_voxels_tpu.ops import collide_pallas as cp

from gpu_voxels_tpu_torch import bitops, interop
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import collide_cuda
from gpu_voxels_tpu_torch.vis import provider as tvp

HAZARD_N = 5000


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


def _occ_np(p: np.ndarray) -> np.ndarray:
    """!noneButEmpty of uint32[8, N] planes: eBVM_FREE left out."""
    return ((p[0] & np.uint32(0xFFFFFFFE)) | np.bitwise_or.reduce(p[1:], axis=0)) != 0


def _hazard_maps():
    """The reference test's maps in its order (one rng for the three
    densities): {density: (a, b)} as uint32[8, 5000]."""
    rng = np.random.default_rng(11)
    n = HAZARD_N
    out = {}
    for density in (0.0, 0.002, 0.2):
        a = np.zeros((8, n), np.uint32)
        b = np.zeros((8, n), np.uint32)
        k = max(1, int(n * density))
        ia, ib = rng.choice(n, k, replace=False), rng.choice(n, k, replace=False)
        a[rng.integers(0, 8, k), ia] = np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32)
        b[rng.integers(0, 8, k), ib] = np.uint32(1) << rng.integers(0, 32, k).astype(np.uint32)
        a[0, 5] = 1  # bit-0-only voxel: summary 0
        b[0, 5] = 1 << 6  # SV bit 6 at the same index
        out[density] = a, b
    return out


HAZARD = _hazard_maps()


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("margin", [0, 3, 4, 8])
@pytest.mark.parametrize("density", [0.0, 0.002, 0.2])
def test_gated_k4_matches_the_reference_gated_kernel(monkeypatch, density, margin):
    monkeypatch.setattr(cp, "TYPES_TILE_ROWS", 8)  # many small tiles, as the reference's test
    a, b = HAZARD[density]
    oa, ob = _occ_np(a).astype(np.uint8), _occ_np(b).astype(np.uint8)
    ta, tb, toa, tob = _t(a), _t(b), torch.from_numpy(oa), torch.from_numpy(ob)
    live = collide_cuda.k4_live_mask(ta, toa, tob, margin)
    for mark in (True, False):
        cnt, meanings, new = collide_cuda.collide_types_bit_bit(ta, tb, margin, mark, toa, tob)
        jc, jm, jn = cp.collide_types_bit_bit(jnp.asarray(a), jnp.asarray(b), margin, mark=mark,
                                              occ_a=jnp.asarray(oa), occ_b=jnp.asarray(ob))
        assert int(cnt) == int(jc), (density, margin, mark)
        np.testing.assert_array_equal(meanings.numpy().view(np.uint32), np.asarray(jm))
        np.testing.assert_array_equal(new.numpy().view(np.uint32), np.asarray(jn))
        # the plain version on the live voxels alone: the same count and meanings
        lc, lm, _ = collide_cuda.collide_types_bit_bit_plain(ta[:, live].contiguous(), tb[:, live].contiguous(),
                                                              margin, mark)
        assert int(lc) == int(cnt) and torch.equal(lm, meanings)
    hit, _ = bitops.bit_margin_collision_check_packed(ta, tb, margin)
    assert not bool((hit & ~live).any()), "a hit voxel outside the live mask"
    # from margin 4 the bit-0-only voxel is live; at 8 the window of b's
    # bit 6 reaches a's bit 0, and the voxel is a hit
    assert bool(live[5]) or margin < 4
    assert bool(hit[5]) or margin < 8


def test_live_mask_of_conservative_and_dead_summaries():
    """A summary of ones (conservative) keeps every voxel of b's side live;
    an all-zero summary kills every voxel below margin 4, and from margin 4
    keeps exactly a's eBVM_FREE voxels."""
    a, b = HAZARD[0.2]
    ta = _t(a)
    ones, zeros = torch.ones(HAZARD_N, dtype=torch.uint8), torch.zeros(HAZARD_N, dtype=torch.uint8)
    assert bool(collide_cuda.k4_live_mask(ta, ones, ones, 0).all())
    assert not bool(collide_cuda.k4_live_mask(ta, zeros, ones, 3).any())
    assert torch.equal(collide_cuda.k4_live_mask(ta, zeros, ones, 4), (ta[0] & 1) != 0)
    assert not bool(collide_cuda.k4_live_mask(ta, ones, zeros, 8).any())


def _list_pair(ids: np.ndarray, payload: np.ndarray, dims):
    """The same list in the port (CPU) and in the reference."""
    zeros = np.zeros_like(ids)
    t = interop.voxel_list_from_numpy(ids, zeros, payload, ids.size, dims, 1.0, "bit", device="cpu")
    j = JL.VoxelList(jnp.asarray(ids), jnp.asarray(zeros), jnp.asarray(payload), jnp.asarray(ids.size, jnp.int32),
                     dims, 1.0, "bit", "linear", t.map_type)
    return t, j


def test_list_bit_check_passes_the_mask_and_builds_no_partner(monkeypatch):
    """collide_with_bitcheck hands K4 the gathered partner payload as it is
    (unmatched columns not zeroed) with the match mask as b_valid, and
    counts what the reference's collide_with_bitcheck counts."""
    rng = np.random.default_rng(4)
    dims = (32, 32, 16)
    n = dims[0] * dims[1] * dims[2]
    mine = np.sort(rng.choice(n, 900, replace=False)).astype(np.uint32)
    theirs = np.sort(np.concatenate([mine[::3], rng.choice(np.setdiff1d(np.arange(n), mine), 200, replace=False)
                                     ])).astype(np.uint32)

    def payload(c):
        words = rng.integers(0, 2**32, (8, c), dtype=np.uint64).astype(np.uint32)
        return words * (rng.random(c) < 0.6).astype(np.uint32)

    a, ja = _list_pair(mine, payload(mine.size), dims)
    b, jb = _list_pair(theirs, payload(theirs.size), dims)
    seen = []
    real = collide_cuda.collide_types_bit_bit

    def spy(x, y, margin, mark, occ_a=None, occ_b=None, *, b_valid=None):
        seen.append((y, b_valid))
        return real(x, y, margin, mark, occ_a, occ_b, b_valid=b_valid)

    monkeypatch.setattr(collide_cuda, "collide_types_bit_bit", spy)
    mask, otherp = a.find_matching(b)
    assert bool((otherp[:, ~mask] != 0).any())  # unmatched columns hold other voxels' words
    for margin in (0, 1, 4, 24):
        got = int(a.collide_with_bitcheck(b, margin))
        assert got == int(ja.collide_with_bitcheck(jb, margin)) > 0, margin
        y, valid = seen.pop()
        assert torch.equal(valid, mask) and torch.equal(y, otherp)


# -- the summaries ---------------------------------------------------------------
FUZZ_DIMS = (16, 12, 8)


def _assert_summary_covers(m: BitVectorVoxelMap, step: str) -> None:
    fold = bitops.occupied(m.data)
    assert m.occ is not None, step
    assert not bool((fold & (m.occ == 0)).any()), f"{step}: the summary misses a voxel with a set bit"


def _points(rng, k):
    return ((rng.integers(0, FUZZ_DIMS, (k, 3)) + 0.5) * 0.1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_map_methods_keep_the_summary_a_superset_of_the_planes(seed):
    """Inserts (eBVM_FREE, occupied, collision and SV meanings; meta clouds
    with per-cloud meanings), clears, merges (plain and re-meaning), marking
    collides and swept-id shifts in a seeded random order: the summary always
    holds the fold."""
    rng = np.random.default_rng(seed)
    sv = int(BitVoxelMeaning.eBVM_SWEPT_VOLUME_START)

    def fresh():
        m = BitVectorVoxelMap.create(FUZZ_DIMS, 0.1, device="cpu")
        return m.insert_point_cloud(_points(rng, 40), int(rng.choice([1, sv, sv + 30, 200])))

    m = fresh()
    steps = {
        "insert free": lambda m: m.insert_point_cloud(_points(rng, 30), BitVoxelMeaning.eBVM_FREE),
        "insert sv": lambda m: m.insert_point_cloud(_points(rng, 30), int(rng.integers(sv, 255))),
        "insert collision": lambda m: m.insert_point_cloud(_points(rng, 10), BitVoxelMeaning.eBVM_COLLISION),
        "meta insert": lambda m: m.insert_meta_point_cloud(
            MetaPointCloud.from_clouds([_points(rng, 12), _points(rng, 9)], device="cpu"),
            [0, int(rng.integers(sv, 255))]),
        "clear bit": lambda m: m.clear_bit(int(rng.choice([0, 1, sv, sv + 3]))),
        "clear bits": lambda m: m.clear_bits([1, int(rng.integers(sv, 255))]),
        "clear collision flags": lambda m: m.clear_collision_flags(),
        "merge": lambda m: m.merge(fresh()),
        "merge re-meaning": lambda m: m.merge(fresh(), int(rng.choice([0, 1, sv + 7]))),
        "mark": lambda m: m.collide_with_types(fresh(), 1.0, int(rng.integers(0, 9)))[2],
        "shift": lambda m: m.shift_left_swept_volume_ids(int(rng.integers(1, 20))),
        "clear map": lambda m: m.clear_map() if rng.random() < 0.3 else m,
    }
    names = list(steps)
    for k in rng.permutation(np.tile(np.arange(len(names)), 3)):
        m = steps[names[k]](m)
        _assert_summary_covers(m, names[k])
    _assert_summary_covers(BitVectorVoxelMap.from_planes(m.data, FUZZ_DIMS, 0.1), "from_planes")


# -- the writer process ------------------------------------------------------------
def _snapshot_maps():
    rng = np.random.default_rng(9)
    pts = ((rng.integers(0, 16, (200, 3)) + 0.5) * 0.25).astype(np.float32)
    prob = ProbVoxelMap.create((16, 16, 16), 0.25, device="cpu").insert_point_cloud(pts)
    bits = BitVectorVoxelMap.create((16, 16, 16), 0.25, device="cpu").insert_point_cloud(pts[:80], 77)
    dist = DistanceVoxelMap.create((16, 16, 16), 0.25, device="cpu").insert_point_cloud(pts[:40])
    return {"prob": prob, "bits": bits, "dist": dist.jump_flood()}


def _same_dirs(x, y) -> None:
    names = sorted(os.listdir(x))
    assert names == sorted(os.listdir(y)) and names
    match, mismatch, errors = filecmp.cmpfiles(x, y, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


@pytest.fixture(scope="module")
def publisher(tmp_path_factory):
    pub = tvp.AsyncVisPublisher("live", out_dir=str(tmp_path_factory.mktemp("published")))
    yield pub
    if pub._writer.alive():
        try:
            pub.stop()
        except Exception:
            pass


def test_writer_process_writes_the_in_process_bytes(publisher, tmp_path):
    """One snapshot of each map through write_snapshot in this process and
    through the publisher's writer process: the same files, byte for byte
    (manifests included: the snapshot carries its time stamp)."""
    for name, m in _snapshot_maps().items():
        job = tvp.VisProvider(name, str(tmp_path / "here")).snapshot(m)
        tvp.write_snapshot(job)
        publisher._writer.write(dict(job, out_dir=str(tmp_path / "child")))
    assert {"dist.distance.cubes.json", "bits.ply", "prob.html"} <= set(os.listdir(tmp_path / "child"))
    _same_dirs(tmp_path / "here", tmp_path / "child")


def test_published_files_equal_visualize(publisher, tmp_path):
    """publish() -> flush(): the files VisProvider.visualize writes in the
    caller's process (the manifest's wall-clock stamp aside)."""
    m = _snapshot_maps()["bits"]
    publisher.provider.out_dir = tmp_path / "child"
    publisher.provider.name = "bits"
    before = publisher.frames_painted
    publisher.publish(m)
    assert publisher.flush(60.0) and publisher.frames_painted == before + 1
    assert tvp.VisProvider("bits", str(tmp_path / "here")).visualize(m)
    for d in ("here", "child"):
        manifest = json.loads((tmp_path / d / "manifest.json").read_text())
        assert manifest.pop("ts") and manifest == {"maps": ["bits"]}
        (tmp_path / d / "manifest.json").unlink()
    _same_dirs(tmp_path / "here", tmp_path / "child")


def test_writer_failure_surfaces_and_stop_leaves_no_child(publisher, tmp_path):
    """A snapshot the child cannot write (its directory is a file): flush()
    and stop() raise the child's error, and stop() ends the child."""
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    publisher.provider.out_dir = blocker
    publisher.publish(_snapshot_maps()["prob"])
    with pytest.raises(OSError):
        publisher.flush(60.0)
    with pytest.warns(RuntimeWarning, match="worker died"):
        publisher.publish(_snapshot_maps()["prob"])
    with pytest.raises(OSError):
        publisher.stop(60.0)
    assert not publisher._writer.alive() and publisher._writer.process.returncode == 0
