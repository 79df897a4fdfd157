"""Port conformance: the octree files, the facade's octree routing and the
hierarchical validity checker (BASELINE config #5's checker).

Files are a contract: a file the port writes equals, byte for byte, the one
gpu_voxels_tpu (JAX, the reference) writes from the same content, binary
and ascii, for the dense hierarchy and the paged tier in both their
instantiations, and each package reads the other's files back to the same
content. The checker's per-state counts must equal the reference's on
dense and paged environments, except where the reference's uint32
distinct-voxel key wraps (worlds past 2^32 voxels, F15): there the port
counts exactly, as a numpy set oracle does.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from gpu_voxels_tpu.api import GpuVoxels as JGvl
from gpu_voxels_tpu.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
from gpu_voxels_tpu.maps import hierarchical as JH
from gpu_voxels_tpu.maps import paged as JP
from gpu_voxels_tpu.planning.validity import HierarchicalValidityChecker as JChecker
from gpu_voxels_tpu.utils import io as jio
from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
from gpu_voxels_tpu_torch.maps import hierarchical as TH
from gpu_voxels_tpu_torch.maps import paged as TP
from gpu_voxels_tpu_torch.maps.voxellist import bit_vector_voxel_list
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.planning import HierarchicalValidityChecker, MotionValidator
from gpu_voxels_tpu_torch.utils import io as tio


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


HDIMS, SIDE = (40, 36, 33), 0.1


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _same_hier(t, j):
    occ, pyramid = interop.to_numpy(t)
    assert type(t).__name__ == type(j).__name__ and (t.dims, t.levels) == (j.dims, j.levels)
    assert np.float32(t.side_length) == np.float32(j.side_length)  # the header holds an f32
    for got, want in zip(pyramid, j.pyramid, strict=True):
        np.testing.assert_array_equal(got, np.asarray(want))
    if occ is not None:
        np.testing.assert_array_equal(occ, np.asarray(j.occupancy))


def _same_paged(t, j):
    n = t.n_tiles()
    assert (t.dims, t.probabilistic, n) == (j.dims, j.probabilistic, j.n_tiles())
    assert np.float32(t.side_length) == np.float32(j.side_length)
    state = interop.to_numpy(t)
    for name in interop.PAGED_ARRAYS:
        want = getattr(j, name)
        assert (state[name] is None) if want is None else np.array_equal(state[name], np.asarray(want)), name
    assert state["page_of"] == j._page_of and state["slot_of"] == j._slot_of and t.memory_usage() == j.memory_usage()


@pytest.mark.parametrize("ascii", [False, True], ids=["binary", "ascii"])
@pytest.mark.parametrize("kind", ["Bit", "Prob"])
def test_hierarchical_files_byte_equal_both_ways(tmp_path, kind, ascii):
    pts = (np.random.default_rng(0).uniform(0, 1, (96, 3)) * np.array(HDIMS) * SIDE).astype(np.float32)
    j = getattr(JH, f"Hierarchical{kind}Map").create(HDIMS, SIDE).insert_point_cloud(pts)
    t = getattr(TH, f"Hierarchical{kind}Map").create(HDIMS, SIDE, device="cpu").insert_point_cloud(pts)
    j = j.insert_point_cloud(pts[:40], BitVoxelMeaning.eBVM_FREE)
    t = t.insert_point_cloud(pts[:40], BitVoxelMeaning.eBVM_FREE)
    jp, tp = tmp_path / "j.bin", tmp_path / "t.bin"
    jio.write_hierarchical_map(j, jp, ascii=ascii)
    tio.write_hierarchical_map(t, tp, ascii=ascii)
    assert _bytes(tp) == _bytes(jp)
    _same_hier(tio.read_hierarchical_map(jp, device="cpu"), j)
    _same_hier(t, jio.read_hierarchical_map(tp))
    if not ascii:
        _same_hier(t.read_from_disk(jp), jio.read_map(tp))
    else:  # F16: the reference's read_map takes "GPU_" for a MapType; the port's reads the file
        with pytest.raises(ValueError):
            jio.read_map(jp)
        _same_hier(tio.read_map(jp, device="cpu"), j)
        _same_hier(t.read_from_disk(jp), j)


def _paged_pair(prob, dims=(4096,) * 3, side=0.5):
    return JP.PagedHierarchicalMap(dims, side, probabilistic=prob), TP.PagedHierarchicalMap(
        dims, side, probabilistic=prob, device="cpu")


@pytest.mark.parametrize("prob", [False, True], ids=["det", "prob"])
def test_paged_files_byte_equal_both_ways(tmp_path, prob):
    """Tiles are written in slot order, so the files are equal only if the
    port allocates slots as the reference does: inserts in three frames
    that each allocate, a free-space frame, both formats both ways."""
    rng = np.random.default_rng(1)
    j, t = _paged_pair(prob)
    frames = [rng.uniform(0, 2048, (24, 3)).astype(np.float32) for _ in range(3)]
    for k, pts in enumerate(frames):
        j.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE if k == 1 else BitVoxelMeaning.eBVM_OCCUPIED)
        t.insert_point_cloud(pts, BitVoxelMeaning.eBVM_FREE if k == 1 else BitVoxelMeaning.eBVM_OCCUPIED)
    origin = (1000.37, 1001.61, 999.83)
    rays = np.array([[1010.81, 1003.29, 998.37], [990.13, 1000.77, 1012.41], [1001.33, 1020.57, 1001.19]],
                    np.float32)
    j.insert_point_cloud_with_free_space(rays, origin, max_steps=32)
    t.insert_point_cloud_with_free_space(rays, origin, max_steps=32)
    _same_paged(t, j)
    for ascii in (False, True):
        jp, tp = tmp_path / f"j{ascii}.bin", tmp_path / f"t{ascii}.bin"
        jio.write_paged_map(j, jp, ascii=ascii)
        tio.write_paged_map(t, tp, ascii=ascii)
        assert _bytes(tp) == _bytes(jp)
        # a read allocates every block at once: its capacities are its own,
        # so the two packages' reads of one file are compared
        back = tio.read_hierarchical_map(jp, device="cpu")
        _same_paged(back, jio.read_hierarchical_map(tp))
        n = t.n_tiles()
        assert back.n_tiles() == n and torch.equal(back.pool[:n], t.pool[:n])
        assert torch.equal(back.slot_block[:n], t.slot_block[:n])
    assert t.read_from_disk(tmp_path / "jFalse.bin").n_tiles() == t.n_tiles()
    empty_j, empty_t = _paged_pair(prob)
    jio.write_paged_map(empty_j, tmp_path / "ej.bin", ascii=True)
    tio.write_paged_map(empty_t, tmp_path / "et.bin", ascii=True)
    assert _bytes(tmp_path / "et.bin") == _bytes(tmp_path / "ej.bin")
    assert tio.read_hierarchical_map(tmp_path / "ej.bin", device="cpu").n_tiles() == 0


def test_write_map_and_read_map_dispatch(tmp_path):
    """write_map / read_map over every tier; read_from_disk refuses another
    MapType; the multi-device world raises naming its ROADMAP item."""
    pts = np.array([[0.55, 0.65, 0.75], [1.05, 0.25, 0.35]], np.float32)
    maps = {
        "bit octree": TH.HierarchicalBitMap.create((16, 16, 16), SIDE, device="cpu").insert_point_cloud(pts),
        "prob octree": TH.HierarchicalProbMap.create((16, 16, 16), SIDE, device="cpu").insert_point_cloud(pts),
        "paged": TP.PagedHierarchicalMap((128, 128, 128), SIDE, device="cpu").insert_point_cloud(pts),
        "list": bit_vector_voxel_list((16, 16, 16), SIDE, device="cpu").insert_point_cloud(pts),
        "prob map": ProbVoxelMap.create((16, 16, 16), SIDE, device="cpu").insert_point_cloud(pts),
    }
    for name, m in maps.items():
        path = tmp_path / f"{name}.bin"
        assert m.write_to_disk(path)
        back = tio.read_map(path, device="cpu")
        assert type(back) is type(m) and int(back.map_type) == int(m.map_type)
        tio.write_map(back, tmp_path / "again.bin")
        assert _bytes(tmp_path / "again.bin") == _bytes(path), name
    with pytest.raises(ValueError, match="MT_BITVECTOR_OCTREE"):
        maps["prob octree"].read_from_disk(tmp_path / "bit octree.bin")
    paged_as_dense = maps["bit octree"].read_from_disk(tmp_path / "paged.bin")  # either body of the MapType
    assert isinstance(paged_as_dense, TP.PagedHierarchicalMap)

    # a sharded paged world writes the single-device paged format (its
    # slabs gathered), which reads back as a PagedHierarchicalMap
    from gpu_voxels_tpu_torch.parallel import ShardedPagedWorld

    world = ShardedPagedWorld.from_paged_map(maps["paged"], ["cpu"] * 2)
    tio.write_map(world, tmp_path / "x.bin")
    assert _bytes(tmp_path / "x.bin") == _bytes(tmp_path / "paged.bin")
    assert isinstance(tio.read_map(tmp_path / "x.bin", device="cpu"), TP.PagedHierarchicalMap)


@pytest.mark.parametrize("dims", [(1024, 8, 8), (1030, 8, 8), (1088, 64, 64), (4096, 4096, 4096)])
@pytest.mark.parametrize("map_type", [MapType.MT_BITVECTOR_OCTREE, MapType.MT_PROBAB_OCTREE])
def test_facade_routes_octrees_like_the_reference(dims, map_type):
    """add_map: the dense pyramid up to 1024 per axis, the paged tier past it
    when every dim is a multiple of 64 (gpu_voxels_tpu/api.py:97-123)."""
    JGvl._instance = None
    jg, tg = JGvl.get_instance(), TGvl()
    jg.initialize(*dims, 0.5)
    tg.initialize(*dims, 0.5, device="cpu")
    jm, tm = jg.add_map(map_type, "o"), tg.add_map(map_type, "o")
    JGvl._instance = None
    assert type(tm).__name__ == type(jm).__name__ and int(tm.map_type) == int(jm.map_type)
    assert tm.device.type == "cpu" and tm.memory_usage() == jm.memory_usage()
    assert isinstance(tm, TP.PagedHierarchicalMap) == (max(dims) > 1024 and all(d % 64 == 0 for d in dims))
    tg.insert_point_cloud_into_map(np.array([[3.25, 1.25, 1.75]], np.float32), "o")
    assert int(tg.get_map("o").probe(np.array([[6, 2, 3]], np.int32))[0][0]) == 1
    tg.clear_map("o")
    assert int(tg.get_map("o").probe(np.array([[6, 2, 3]], np.int32))[1][0]) == 1


def _robots(cloud):
    """A point robot translated by its 3-d configuration, in both packages
    (the port's takes a batch [T, 3] as well)."""
    jmeta, tmeta = JMeta.from_clouds([cloud], names=("body",)), TMeta.from_clouds([cloud], names=("body",), device="cpu")

    class JTranslated:
        def transformed_clouds_for(self, cfg):
            return replace(jmeta, points=jmeta.points + cfg)

    class TTranslated:
        def transformed_clouds_for(self, cfg):
            cfg = torch.as_tensor(cfg, dtype=torch.float32)
            return replace(tmeta, points=tmeta.points + cfg[..., None, :])

    return JTranslated(), TTranslated()


def test_validity_checker_dense_and_paged_match_reference():
    """HierarchicalValidityChecker on a dense hierarchy and on a paged map of
    the same points: per-state counts equal the reference's (and each
    other); a paged env is snapshotted and refresh() takes the new state;
    min_level probes coarser; MotionValidator works with it unchanged
    (tests/test_paged.py:219)."""
    rng = np.random.default_rng(7)
    env_pts = rng.uniform(0, 128, (4000, 3)).astype(np.float32)
    jdense = JH.HierarchicalBitMap.create((128,) * 3).insert_point_cloud(env_pts)
    tdense = TH.HierarchicalBitMap.create((128,) * 3, device="cpu").insert_point_cloud(env_pts)
    jpaged, tpaged = _paged_pair(False, (128,) * 3, 1.0)
    jpaged.insert_point_cloud(env_pts)
    tpaged.insert_point_cloud(env_pts)
    jr, tr = _robots(rng.uniform(-2, 2, (60, 3)).astype(np.float32))
    states = rng.uniform(8.0, 120.0, (17, 3)).astype(np.float32)
    want = JChecker(jdense, jr).batch_colliding_voxels(states)
    tchecker = HierarchicalValidityChecker(tpaged, tr)
    for checker in (HierarchicalValidityChecker(tdense, tr), tchecker):
        got = checker.batch_colliding_voxels(states)
        np.testing.assert_array_equal(got, want)
        assert checker.host_reads == 1 and int(got.sum()) > 0
    np.testing.assert_array_equal(HierarchicalValidityChecker(tpaged, tr, min_level=7).batch_colliding_voxels(states),
                                  JChecker(jpaged, jr, min_level=7).batch_colliding_voxels(states))
    free0 = states[int(np.flatnonzero(want == 0)[0])]
    blob = (free0[None, :] + rng.uniform(-2, 2, (60, 3))).astype(np.float32)
    tpaged.insert_point_cloud(blob)
    assert tchecker.colliding_voxels(free0) == 0  # the snapshot it holds
    tchecker.refresh()
    assert tchecker.colliding_voxels(free0) > 0 and tchecker.host_reads == 3
    jpaged.insert_point_cloud(blob)
    jchecker = JChecker(jpaged, jr)
    after = tchecker.batch_colliding_voxels(states)
    np.testing.assert_array_equal(after, jchecker.batch_colliding_voxels(states))
    mv = MotionValidator(tchecker, resolution=2.0)
    ok, n = mv.check_motion(free0 + 40.0, free0)
    assert not ok and n > 1 and tchecker.host_reads == 5
    still_free = states[int(np.flatnonzero(after == 0)[0])]
    assert mv.check_motion(still_free, still_free)[0]


def test_distinct_voxel_key_past_2_32_voxels():
    """F15: the reference keys a state's distinct colliding voxels by
    z * (dx * dy) + y * dx + x in uint32, which wraps past 2^32 voxels. In a
    32768^3 world, voxels (x, y, z) and (x, y, z + 4) share a key, so a
    robot covering both counts 1 there; the port's int64 key counts 2, as
    the numpy set oracle does. In a world of 2^30 voxels both count 2."""
    cells = np.array([[100, 200, 300], [100, 200, 304]], np.int64)
    pts = (cells + 0.5).astype(np.float32)
    oracle = len({tuple(c) for c in cells})
    for dims, ref_count in (((32768,) * 3, 1), ((1024,) * 3, 2)):
        jm, tm = _paged_pair(False, dims, 1.0)
        jm.insert_point_cloud(pts)
        tm.insert_point_cloud(pts)
        jr, tr = _robots(pts)
        zero = np.zeros(3, np.float32)
        dx, dy, _ = dims
        lin = cells[:, 2] * dx * dy + cells[:, 1] * dx + cells[:, 0]
        assert len(set((lin % 2**32).tolist())) == ref_count  # what the uint32 key sees
        assert JChecker(jm, jr).colliding_voxels(zero) == ref_count
        assert HierarchicalValidityChecker(tm, tr).colliding_voxels(zero) == oracle == 2
