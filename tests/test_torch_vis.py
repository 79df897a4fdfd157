"""Port conformance of the visualization side: the device compaction, the
cube extraction over every tier, the multi-level extraction, distance
slices, the PLY / HTML / layer files and the publishers.

The same scenes, made from a numpy seed (points at voxel centres), are
held by gpu_voxels_tpu (JAX, the reference) and gpu_voxels_tpu_torch on the
CPU: the dense maps are inserted by the reference and copied into the port
(`interop`); the octree tiers, the lists and the distance map are built by
the port and copied into the reference (`ref_of`), so the reference's
inserts, tested by the other files, do not cost their compiles here. Compaction indices, coordinates,
types and multi-level cubes must be equal in value and in order, and every
written file byte for byte (a file is only byte-equal when the cube order
is the reference's).
"""
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import providers as jprov
from gpu_voxels_tpu.maps import hierarchical as JH
from gpu_voxels_tpu.maps import paged as JP
from gpu_voxels_tpu.maps import voxellist as JL
from gpu_voxels_tpu.maps.distance_map import DistanceVoxelMap as JDist
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import CountingVoxelMap as JCount
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import compact as jcompact
from gpu_voxels_tpu.primitive_array import PrimitiveArray as JPrim
from gpu_voxels_tpu.vis import config as jconfig
from gpu_voxels_tpu.vis import export as jexport
from gpu_voxels_tpu.vis import extract as jextract
from gpu_voxels_tpu.vis import provider as jvp
from gpu_voxels_tpu.vis import serve as jserve

from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch import providers as tprov
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning
from gpu_voxels_tpu_torch.maps import hierarchical as TH
from gpu_voxels_tpu_torch.maps import paged as TP
from gpu_voxels_tpu_torch.maps import voxellist as TL
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap as TDist
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import CountingVoxelMap as TCount
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import compact as tcompact
from gpu_voxels_tpu_torch.primitive_array import PrimitiveType
from gpu_voxels_tpu_torch.vis import config as tconfig
from gpu_voxels_tpu_torch.vis import export as texport
from gpu_voxels_tpu_torch.vis import extract as textract
from gpu_voxels_tpu_torch.vis import provider as tvp
from gpu_voxels_tpu_torch.vis import serve as tserve

DIMS = (24, 20, 16)
HDIMS = (32, 32, 32)
PDIMS = (128, 128, 128)


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


def centres(seed, n, dims, side=1.0):
    """n points at voxel centres inside dims (with repeats)."""
    rng = np.random.default_rng(seed)
    v = np.stack([rng.integers(0, d, n) for d in dims], axis=1)
    return ((v + 0.5) * side).astype(np.float32)


def box(lo, hi):
    g = np.meshgrid(*[np.arange(lo[i], hi[i]) + 0.5 for i in range(3)], indexing="ij")
    return np.stack(g, axis=-1).reshape(-1, 3).astype(np.float32)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def ref_of(t):
    """The reference's map over a copy of the port map's arrays: the same
    content without the reference's inserts (their conformance is tested
    elsewhere; only the extraction is under test here)."""
    if isinstance(t, TP.PagedHierarchicalMap):
        j = JP.PagedHierarchicalMap(t.dims, t.side_length, probabilistic=t.probabilistic)
        state = interop.to_numpy(t)
        for name in interop.PAGED_ARRAYS:
            setattr(j, name, None if state[name] is None else jnp.asarray(state[name]))
        j.pyramid = tuple(jnp.asarray(a) for a in state["pyramid"])
        j._n_pages, j._n_slots, j._page_of, j._slot_of = (state[k] for k in ("n_pages", "n_slots", "page_of", "slot_of"))
        return j
    if isinstance(t, TL.VoxelList):
        ids, ids_hi, payload, count = interop.to_numpy(t)
        return JL.VoxelList(jnp.asarray(ids), jnp.asarray(ids_hi), jnp.asarray(payload), jnp.asarray(count, jnp.int32),
                            t.dims, t.side_length, t.kind, t.id_mode, t.map_type)
    if isinstance(t, TDist):
        return JDist(jnp.asarray(interop.to_numpy(t)), t.dims, t.side_length)
    occ, pyramid = interop.to_numpy(t)
    pyramid = tuple(jnp.asarray(a) for a in pyramid)
    if occ is None:
        return JH.HierarchicalBitMap(pyramid, t.dims, t.side_length, t.levels)
    return JH.HierarchicalProbMap(jnp.asarray(occ), pyramid, t.dims, t.side_length, t.levels)


def dense_pairs(side=0.5):
    """(name, port map, reference map) for every dense map kind; the bit
    map holds meanings on bit 31 of planes 1 and 7 (H1), a voxel whose only
    meaning is eBVM_FREE (not occupied) and several meanings per voxel."""
    pts = centres(0, 300, DIMS, side)
    p = JProb.create(DIMS, side).insert_point_cloud(pts)
    p = p.insert_point_cloud(pts[:60], BitVoxelMeaning.eBVM_FREE)
    b = JBit.create(DIMS, side)
    for k, meaning in enumerate((1, 63, 255, 40, 9, 0)):
        b = b.insert_point_cloud(pts[k * 40:(k + 1) * 40 + 20], meaning)
    c = JCount.create(DIMS, side).insert_point_cloud(np.concatenate([pts, pts[:50]]))
    d = TDist.create(DIMS, side, device="cpu").insert_point_cloud(pts[:30]).parallel_banding()
    return [
        ("prob", interop.prob_map_from_numpy(np.asarray(p.data), DIMS, side, "cpu"), p),
        ("bit", interop.bit_map_from_numpy(np.asarray(b.data), np.asarray(b.occ), DIMS, side, "cpu"), b),
        ("bit_raw", interop.bit_map_from_numpy(np.asarray(b.data), None, DIMS, side, "cpu"), JBit(b.data, DIMS, side)),
        ("count", interop.counting_map_from_numpy(np.asarray(c.data), DIMS, side, "cpu"), c),
        ("dist", d, ref_of(d)),
    ]


def list_pairs():
    pts = centres(1, 200, DIMS)
    out = []
    for kind, mode in (("bit", "linear"), ("prob", "linear"), ("count", "linear"), ("bit", "morton")):
        t = TL.VoxelList.create(DIMS, 1.0, kind=kind, capacity=64, id_mode=mode, device="cpu").insert_point_cloud(pts, 20)
        out.append((f"{kind}_{mode}_list", t, ref_of(t)))
    far = np.array([[2000.5, 1030.5, 3000.5], [5.5, 1500.5, 7.5]], np.float32)
    t = TL.VoxelList.create((4096, 4096, 4096), 1.0, "bit", 8, "morton", device="cpu").insert_point_cloud(far)
    out.append(("morton_far", t, ref_of(t)))
    return out


def hier_pairs():
    occupied = np.concatenate([box((3, 3, 3), (11, 9, 7)), centres(2, 150, HDIMS)])
    free = box((16, 16, 16), (32, 32, 32))
    out = []
    for cls, name in ((TH.HierarchicalBitMap, "hbit"), (TH.HierarchicalProbMap, "hprob")):
        t = cls.create(HDIMS, device="cpu").insert_point_cloud(occupied).insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE)
        out.append((name, t, ref_of(t)))
    return out


def paged_pair():
    t = TP.PagedHierarchicalMap(PDIMS, 1.0, device="cpu")
    t.insert_point_cloud(np.concatenate([box((5, 64, 64), (13, 72, 72)), box((100, 100, 100), (101, 104, 109))]))
    t.insert_point_cloud(box((64, 0, 0), (128, 64, 64)), meaning=BitVoxelMeaning.eBVM_FREE)
    return "paged", t, ref_of(t)


@pytest.fixture(scope="module")
def scenes():
    """Every tier's (name, port map, reference map), built once a module."""
    return {"dense": dense_pairs(), "lists": list_pairs(), "hier": hier_pairs(), "paged": paged_pair()}


def test_compaction_equals_flatnonzero():
    """compacted_nonzero equals np.flatnonzero (int64, ascending) with and
    without a capacity, and the reference's compaction; the total count
    survives truncation. H2: every overflowing position writes the dropped
    slot `capacity`, so a full mask keeps exactly its first `capacity`
    indices and the entries past the count stay 0."""
    rng = np.random.default_rng(11)
    mask = rng.random(50_000) < 0.02
    t = torch.from_numpy(mask)
    got = tcompact.compacted_nonzero(t)
    assert got.dtype == np.int64
    _same(got, np.flatnonzero(mask))
    _same(got, jcompact.compacted_nonzero(jnp.asarray(mask)).astype(np.int64))
    for cap in (0, 1, 7, int(mask.sum()), 60_000):
        _same(tcompact.compacted_nonzero(t, capacity=cap), np.flatnonzero(mask)[:cap])
    count, idx = tcompact.compact_indices(t, 7)
    assert int(count) == int(mask.sum()) and idx.shape == (7,)
    full = torch.ones(100, dtype=torch.bool)
    count, idx = tcompact.compact_indices(full, 10)
    assert int(count) == 100 and idx.tolist() == list(range(10))
    count, idx = tcompact.compact_indices(torch.tensor([False, True, False, True]), 6)
    assert int(count) == 2 and idx.tolist() == [1, 3, 0, 0, 0, 0]
    assert tcompact.compacted_nonzero(torch.zeros(256, dtype=torch.bool)).size == 0
    assert tcompact.compacted_nonzero(torch.zeros(0, dtype=torch.bool)).size == 0
    # a 3-d mask compacts in its flat (z, y, x) order
    cube = torch.from_numpy(mask[:4096].reshape(16, 16, 16))
    _same(tcompact.compacted_nonzero(cube), np.flatnonzero(mask[:4096]))


def test_occupied_coords_and_cubes_every_tier(scenes):
    """occupied_coords and extract_cubes over every tier, thresholds and
    max_cubes included: equal to the reference in value and order. The bit
    map's types are the lowest set meaning with plane 0's bit 0 skipped,
    bit 31 of a plane included (H1)."""
    pairs = scenes["dense"] + scenes["lists"] + scenes["hier"] + [scenes["paged"]]
    for name, t, j in pairs:
        for thr, cap in ((0.5, None), (0.0, None), (0.5, 17)):
            _same(textract.occupied_coords(t, thr, max_cubes=cap), jextract.occupied_coords(j, thr, max_cubes=cap))
            for a, b in zip(textract.extract_cubes(t, thr, max_cubes=cap), jextract.extract_cubes(j, thr, max_cubes=cap),
                            strict=True):
                _same(a, b)
    types = dict((n, textract.extract_cubes(t)[1]) for n, t, _ in pairs)
    assert {63, 255, 40, 9, 1} <= set(types["bit"].tolist()) and 0 not in set(types["bit"].tolist())
    _same(types["bit"], types["bit_raw"])
    far = next(t for n, t, _ in pairs if n == "morton_far")
    _same(textract.occupied_coords(far), np.array([[5, 1500, 7], [2000, 1030, 3000]], np.int32))
    with pytest.raises(TypeError):
        textract.occupied_coords(object())


def test_bit31_meaning_alone():
    """A voxel whose only meaning sits on bit 31 of plane 7 (meaning 255)
    and one on bit 31 of plane 0 (meaning 31): types 255 and 31."""
    pts = np.array([[1.5, 1.5, 1.5], [2.5, 1.5, 1.5]], np.float32)
    m = TBit.create((4, 4, 4), device="cpu").insert_point_cloud(pts[:1], 255).insert_point_cloud(pts[1:], 31)
    centres_, types = textract.extract_cubes(m)
    assert types.tolist() == [255, 31]
    np.testing.assert_array_equal(centres_, pts)
    assert textract._lowest_meanings(np.array([[1], [0], [0], [0], [0], [0], [0], [1 << 31]], np.uint32)).tolist() == [255]


def test_multilevel_extraction_cube_for_cube(scenes):
    """extract_multilevel_cubes of both dense tiers and the paged tier at
    several min_levels, the selection filters and max_cubes: the cubes of
    the reference, in its order."""
    hiers = scenes["hier"]
    _, pt, pj = scenes["paged"]
    for name, t, j in hiers:
        for lvl in (0, 1, 2, t.levels):
            for a, b in zip(textextract(t, lvl), jextract.extract_multilevel_cubes(j, min_level=lvl), strict=True):
                _same(a, b)
        with pytest.raises(ValueError):
            textract.extract_multilevel_cubes(t, min_level=t.levels + 1)
    for lvl in (0, 2, 3, 4, 6, 7, pt.fine_levels):
        for a, b in zip(textextract(pt, lvl), jextract.extract_multilevel_cubes(pj, min_level=lvl), strict=True):
            _same(a, b)
    with pytest.raises(ValueError):
        textract.extract_multilevel_cubes(pt, min_level=pt.fine_levels + 1)
    for kw in (dict(free=False, unknown=False), dict(occupied=False), dict(max_cubes=4), dict(max_cubes=0)):
        for t, j in ((hiers[0][1], hiers[0][2]), (pt, pj)):
            for a, b in zip(textract.extract_multilevel_cubes(t, **kw), jextract.extract_multilevel_cubes(j, **kw),
                            strict=True):
                _same(a, b)
    with pytest.raises(TypeError):
        textract.extract_multilevel_cubes(TProb.create((8, 8, 8), device="cpu"))
    empty = textract.extract_multilevel_cubes(TP.PagedHierarchicalMap(PDIMS, device="cpu"))
    for a, b in zip(empty, jextract.extract_multilevel_cubes(JP.PagedHierarchicalMap(PDIMS)), strict=True):
        _same(a, b)
    assert empty[2].tolist() == [int(BitVoxelMeaning.eBVM_UNKNOWN)]


def textextract(m, lvl):
    return textract.extract_multilevel_cubes(m, min_level=lvl)


def test_distance_slices_equal_reference(scenes):
    name, t, j = scenes["dense"][-1]
    for axis in ("x", "y", "z"):
        for index in (None, 0, 3):
            for a, b in zip(textract.extract_distance_slice(t, axis, index), jextract.extract_distance_slice(j, axis, index),
                            strict=True):
                _same(a, b)
    with pytest.raises(ValueError):
        textract.extract_distance_slice(t, "z", DIMS[2])


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.name != "manifest.json"}


def test_published_files_byte_equal(tmp_path, scenes):
    """VisProvider.visualize of every tier (dense maps with the distance
    layer, lists, both dense octree tiers, the paged tier) writes the .ply,
    .html and .cubes.json files of the reference byte for byte; so do the
    exporters called directly, the primitive layers and the vis config."""
    dense = scenes["dense"]
    pairs = dense + scenes["lists"][:2] + scenes["hier"] + [scenes["paged"]]
    for name, t, j in pairs:
        assert tvp.VisProvider(name, tmp_path / "port").visualize(t)
        assert jvp.VisProvider(name, tmp_path / "ref").visualize(j)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "ref")
    assert set(port) == set(ref) and "dist.distance.cubes.json" in port and len(port) == 3 * len(pairs) + 1
    for fname in ref:
        assert port[fname] == ref[fname], fname
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["maps"] == json.loads((tmp_path / "ref" / "manifest.json").read_text())["maps"]

    name, t, j = dense[1]
    assert texport.write_ply(tmp_path / "a.ply", t) == jexport.write_ply(tmp_path / "b.ply", j) > 0
    texport.write_html(tmp_path / "a.html", {"m": t, "n": t}, title="scene")
    jexport.write_html(tmp_path / "b.html", {"m": j, "n": j}, title="scene")
    tserve.publish_cubes(tmp_path / "pa", "m", t, 0.5)
    jserve.publish_cubes(tmp_path / "pb", "m", j, 0.5)
    tserve.publish_distance_layer(tmp_path / "pa", "d", dense[-1][1], axis="y", index=2)
    jserve.publish_distance_layer(tmp_path / "pb", "d", dense[-1][2], axis="y", index=2)
    pd = np.array([[1, 2, 3, 0.5], [4, 5, 6, 0.25]], np.float32)
    for kind in (PrimitiveType.ePRIM_SPHERE, PrimitiveType.ePRIM_CUBOID):
        tserve.publish_primitives(tmp_path / "pa", f"prim{int(kind)}", interop.primitive_array_from_numpy(pd, kind, "cpu"))
        jserve.publish_primitives(tmp_path / "pb", f"prim{int(kind)}", JPrim(jnp.asarray(pd), int(kind)))
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    assert (tmp_path / "a.html").read_bytes() == (tmp_path / "b.html").read_bytes()
    assert _files(tmp_path / "pa") == _files(tmp_path / "pb")
    assert tserve.INDEX == jserve.INDEX
    dist = np.array([0.0, 1.0, np.inf, 3.5, 7.0], np.float32)
    _same(texport.distance_colors(dist), jexport.distance_colors(dist))
    assert [texport._color_for(t) for t in range(256)] == [jexport._color_for(t) for t in range(256)]

    xml = tmp_path / "vis.xml"
    xml.write_text("<visconfig><camera name='top'><position>0 0 100</position><target>32 32 0</target></camera>"
                   "<meaning id='10'><color>255 0 0</color></meaning><meaning id='4'><visible>false</visible></meaning>"
                   "<slice axis='z' min='0' max='16'/><background>0 0 0</background></visconfig>")
    tc, jc = tconfig.VisConfig.from_xml(xml), jconfig.VisConfig.from_xml(xml)
    assert tc.to_dict() == jc.to_dict() and tc.visible(4) is False and tc.slice_keep((5, 5, 10))
    assert not tc.slice_keep((5, 5, 20)) and tc.color_for(10, (0, 0, 0)) == (255, 0, 0)
    assert tc.publish(tmp_path / "ca").read_bytes() == jc.publish(tmp_path / "cb").read_bytes()


def test_default_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / "v"))
    assert tserve.default_dir() == tmp_path / "v" and tvp.VisProvider("m").out_dir == tmp_path / "v"
    monkeypatch.delenv("GPU_VOXELS_VIS_DIR")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert tserve.default_dir() == tmp_path / "gpu_voxels_tpu_vis"


def test_vis_provider_change_detection(tmp_path):
    """force_repaint=False skips unchanged content, repaints on a change
    (a list's ids included, with the same payload bytes) and max_cubes
    bounds the dense extraction."""
    m = TProb.create((8, 8, 8), device="cpu").insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    vp = tvp.VisProvider("env", tmp_path)
    assert vp.visualize(m, force_repaint=False)
    assert not vp.visualize(m, force_repaint=False)
    assert vp.visualize(m, force_repaint=True)
    assert vp.visualize(m, force_repaint=False, threshold=0.9)  # a new threshold is new content
    l1 = TL.VoxelList.create((64, 64, 64), 1.0, "bit", 4, device="cpu").insert_point_cloud(
        np.array([[1.5, 1.5, 1.5]], np.float32), grow=False)
    l2 = TL.VoxelList.create((64, 64, 64), 1.0, "bit", 4, device="cpu").insert_point_cloud(
        np.array([[2.5, 1.5, 1.5]], np.float32), grow=False)
    lp = tvp.VisProvider("lst", tmp_path)
    assert lp.visualize(l1, force_repaint=False)
    assert lp.visualize(l2, force_repaint=False)
    assert not lp.visualize(l2, force_repaint=False)
    big = TProb.create((8, 8, 8), device="cpu").insert_point_cloud(centres(5, 40, (8, 8, 8)))
    capped = tvp.VisProvider("capped", tmp_path, max_cubes=3)
    assert capped.visualize(big)
    assert len(json.loads((tmp_path / "capped.cubes.json").read_text())["centers"]) == 3


def test_async_vis_publisher(tmp_path):
    """publish() is non-blocking and latest-wins; flush drains; the newest
    map is what lands on disk, byte-equal to the reference publisher's."""
    m1 = TProb.create((8, 8, 8), device="cpu").insert_point_cloud(np.array([[1.5, 1.5, 1.5]], np.float32))
    m2 = m1.insert_point_cloud(np.array([[4.5, 4.5, 4.5]], np.float32))
    pub = tvp.AsyncVisPublisher("live", out_dir=tmp_path / "port")
    for _ in range(5):
        pub.publish(m1)
    pub.publish(m2)
    assert pub.flush(timeout_s=30.0)
    pub.stop()
    assert not pub._thread.is_alive() and 1 <= pub.frames_painted <= 6
    j2 = JProb.create((8, 8, 8), 1.0).insert_point_cloud(np.array([[1.5, 1.5, 1.5], [4.5, 4.5, 4.5]], np.float32))
    ref = jvp.AsyncVisPublisher("live", out_dir=tmp_path / "ref")
    ref.publish(j2)
    assert ref.flush(timeout_s=30.0)
    ref.stop()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")


def test_async_vis_publisher_warns_when_worker_dies(tmp_path):
    """The first publish() after the worker died warns once; flush()
    re-raises the worker's exception."""
    m = TProb.create((8, 8, 8), device="cpu")
    pub = tvp.AsyncVisPublisher("dies", out_dir=tmp_path)
    boom = RuntimeError("paint failed")

    def exploding(_m, force_repaint=False):
        raise boom

    pub.provider.visualize = exploding
    pub.publish(m)
    pub._thread.join(30.0)
    assert not pub._thread.is_alive() and pub._error is boom
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pub.publish(m)
        pub.publish(m)
    msgs = [w for w in caught if issubclass(w.category, RuntimeWarning)]
    assert len(msgs) == 1 and "worker died" in str(msgs[0].message)
    with pytest.raises(RuntimeError, match="paint failed"):
        pub.flush(timeout_s=5.0)
    with pytest.raises(RuntimeError, match="paint failed"):
        pub.stop(timeout_s=5.0)


def test_provider_live_vis(tmp_path, monkeypatch):
    """Provider(live_vis=True): visualize() hands the map to the worker and
    finish_visualization drains it; the files equal the reference
    provider's. A plain Provider paints synchronously; vis_max_cubes bounds
    its extraction."""
    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / "port"))
    pts = centres(7, 30, (16, 16, 16))
    env = tprov.Provider("env_live", live_vis=True)
    env.init(TProb.create((16, 16, 16), 1.0, device="cpu").insert_point_cloud(pts))
    robot = tprov.Provider("robot_live", vis_max_cubes=5)
    robot.init(TBit.create((16, 16, 16), 1.0, device="cpu").insert_point_cloud(pts[:10]))
    robot.set_collide_with(env, coll_threshold=0.7)
    assert robot.collide() == int(robot.collide_async()) > 0
    assert env.visualize()
    assert env.finish_visualization() >= 1
    assert robot.visualize() and robot.finish_visualization() == 0
    assert len(json.loads((tmp_path / "port" / "robot_live.cubes.json").read_text())["centers"]) == 5
    monkeypatch.setenv("GPU_VOXELS_VIS_DIR", str(tmp_path / "ref"))
    jenv = jprov.Provider("env_live", live_vis=True)
    jenv.init(JProb.create((16, 16, 16), 1.0).insert_point_cloud(pts))
    jenv.visualize()
    assert jenv.finish_visualization() >= 1
    jrobot = jprov.Provider("robot_live", vis_max_cubes=5)
    jrobot.init(JBit.create((16, 16, 16), 1.0).insert_point_cloud(pts[:10]))
    jrobot.visualize()
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    env._vis_async.stop()
    jenv._vis_async.stop()
    assert not env._vis_async._thread.is_alive()


def test_host_reads_per_call(tmp_path, monkeypatch):
    """H10: compacted_nonzero reads the device twice (the count, then the
    index prefix), a dense map's publish reads it only through that
    compaction, print_voxel_map_data once; each read is counted as a
    tensor.cpu() or an int() of a tensor."""
    calls = []
    cpu, to_int = torch.Tensor.cpu, torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: calls.append(self.numel()) or cpu(self, *a, **k))
    monkeypatch.setattr(torch.Tensor, "__int__", lambda self: calls.append(1) or to_int(self))
    m = TProb.create((16, 16, 16), device="cpu").insert_point_cloud(centres(9, 50, (16, 16, 16)))
    k = int(m.occupied_mask(0.5).sum())
    calls.clear()
    assert tcompact.compacted_nonzero(m.occupied_mask(0.5)).size == k
    assert calls == [1, k]
    calls.clear()
    assert tvp.VisProvider("m", tmp_path).visualize(m)
    assert calls == [1, k]
    calls.clear()
    m.print_voxel_map_data()
    assert calls == [16 ** 3]
