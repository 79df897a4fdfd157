"""Port conformance of the disk formats (utils/io.py): dense maps and voxel
lists.

Files are a contract: a file the port writes equals, byte for byte, the one
gpu_voxels_tpu (JAX, the reference) writes from the same content, and each
package reads the other's files back to the same content. The port's maps
are built from the reference's through `interop`, so both sides hold the
same content by construction.
"""
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import morton as jmorton
from gpu_voxels_tpu.constants import MapType
from gpu_voxels_tpu.maps import voxellist as J
from gpu_voxels_tpu.maps.distance_map import DistanceVoxelMap as JDist
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import CountingVoxelMap as JCount
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.utils import io as jio
import jax.numpy as jnp

from gpu_voxels_tpu_torch import interop
from gpu_voxels_tpu_torch import morton as tmorton
from gpu_voxels_tpu_torch.maps import voxellist as T
from gpu_voxels_tpu_torch.maps.voxelmap import CountingVoxelMap as TCount
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
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


DIMS = (12, 10, 8)
SIDE = 0.25


def _points(seed, n=40):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (n, 3)) * np.array(DIMS) * SIDE).astype(np.float32)


def _dense_pairs():
    """(name, reference map, port map) over one content per map kind."""
    pts = _points(0)
    jp = JProb.create(DIMS, SIDE).insert_point_cloud(pts).insert_point_cloud(pts[:10], 0)
    jb = JBit.create(DIMS, SIDE).insert_point_cloud(pts, 77).insert_point_cloud(pts[:7], 255)
    jc = JCount.create(DIMS, SIDE).insert_point_cloud(np.concatenate([pts, pts[:5]]))
    jd = JDist.create(DIMS, SIDE).insert_point_cloud(pts[:6]).parallel_banding()
    planes, occ = np.asarray(jb.data), np.asarray(jb.occ)
    return [
        ("prob", jp, interop.prob_map_from_numpy(np.asarray(jp.data), DIMS, SIDE, device="cpu")),
        ("bit", jb, interop.bit_map_from_numpy(planes, occ, DIMS, SIDE, device="cpu")),
        ("bit raw planes", JBit(jb.data, DIMS, SIDE, occ=None), interop.bit_map_from_numpy(planes, None, DIMS, SIDE,
                                                                                            device="cpu")),
        ("count", jc, interop.counting_map_from_numpy(np.asarray(jc.data), DIMS, SIDE, device="cpu")),
        ("distance", jd, interop.distance_map_from_numpy(np.asarray(jd.data), DIMS, SIDE, device="cpu")),
    ]


def _same_dense(t, j):
    assert type(t).__name__ == type(j).__name__ and t.dims == j.dims and t.side_length == j.side_length
    got = interop.to_numpy(t)
    if isinstance(got, tuple):  # bit map: planes, and the summary the reader computes
        np.testing.assert_array_equal(got[0], np.asarray(j.data))
        np.testing.assert_array_equal(got[1], np.asarray(j.occ))
    else:
        np.testing.assert_array_equal(got, np.asarray(j.data))


def test_dense_map_files_are_byte_equal_and_read_both_ways(tmp_path):
    for name, j, t in _dense_pairs():
        jf, tf = tmp_path / f"{name}.ref", tmp_path / f"{name}.port"
        jio.write_voxel_map(j, jf)
        tio.write_voxel_map(t, tf)
        assert tf.read_bytes() == jf.read_bytes(), name
        # each package reads either file to the same map, with the content written
        for f in (jf, tf):
            _same_dense(tio.read_voxel_map(f, device="cpu"), jio.read_voxel_map(f))
        np.testing.assert_array_equal(np.asarray(jio.read_voxel_map(tf).data), np.asarray(j.data))


def test_dense_map_header_is_reference_binary(tmp_path):
    m = TProb.create((4, 4, 4), 0.25, device="cpu").insert_point_cloud(np.array([[0.1, 0.1, 0.1]], np.float32))
    f = tmp_path / "m.bin"
    tio.write_voxel_map(m, f)
    raw = f.read_bytes()
    assert len(raw) == 4 + 4 + 12 + 64
    assert np.frombuffer(raw[:4], "<i4")[0] == int(MapType.MT_PROBAB_VOXELMAP)
    assert np.frombuffer(raw[4:8], "<f4")[0] == np.float32(0.25)
    assert np.frombuffer(raw[8:20], "<u4").tolist() == [4, 4, 4]
    assert np.frombuffer(raw[20:], "i1")[0] == 127


def _list_pairs():
    """(name, reference list, port list): every list kind, a morton list
    beyond coordinate 1024, and an empty one."""
    pts = _points(1)
    big = np.array([[2000.5, 1500.5, 1030.5], [3.5, 4.5, 5.5], [976.5 + 1024, 476.5, 6.5]], np.float32)
    lists = {
        "bit": J.bit_vector_voxel_list(DIMS, SIDE).insert_point_cloud(pts, 50).insert_point_cloud(pts[:9], 200),
        "morton bit": J.bit_vector_morton_voxel_list((4096,) * 3).insert_point_cloud(big, 50),
        "prob": J.prob_voxel_list(DIMS, SIDE).insert_point_cloud(pts).insert_point_cloud(pts[:12], 0),
        "morton prob": J.VoxelList.create(DIMS, SIDE, "prob", 0, "morton").insert_point_cloud(pts),
        "count": J.counting_voxel_list(DIMS, SIDE).insert_point_cloud(np.concatenate([pts, pts[:8]])),
        "empty": J.bit_vector_voxel_list(DIMS, SIDE, capacity=5),
    }
    out = []
    for name, j in lists.items():
        t = interop.voxel_list_from_numpy(np.asarray(j.ids), np.asarray(j.ids_hi), np.asarray(j.payload),
                                          int(j.count), j.dims, j.side_length, j.kind, j.id_mode, j.map_type,
                                          device="cpu")
        out.append((name, j, t))
    return out


def _same_list(t, j):
    """Equal live entries (files hold `count` entries: capacity = count)."""
    lo, hi, payload, count = interop.to_numpy(t)
    assert count == int(j.count) and (t.dims, t.side_length, t.kind, t.id_mode) == (
        j.dims, j.side_length, j.kind, j.id_mode)
    np.testing.assert_array_equal(lo[:count], np.asarray(j.ids)[:count])
    np.testing.assert_array_equal(hi[:count], np.asarray(j.ids_hi)[:count])
    np.testing.assert_array_equal(payload[..., :count], np.asarray(j.payload)[..., :count])


def test_list_files_are_byte_equal_and_read_both_ways(tmp_path):
    pairs = _list_pairs()
    for name, j, t in pairs:
        jf, tf = tmp_path / f"{name}.ref", tmp_path / f"{name}.port"
        jio.write_voxel_list(j, jf)
        tio.write_voxel_list(t, tf)
        assert tf.read_bytes() == jf.read_bytes(), name
        back = tio.read_voxel_list(jf, device="cpu")
        _same_list(back, j)
        assert back.capacity == int(j.count)
        _same_list(t, jio.read_voxel_list(tf))
    # morton entries beyond 1024 keep their coordinates and membership
    _, j, t = pairs[1]
    back = tio.read_voxel_list(tmp_path / "morton bit.ref", device="cpu")
    assert torch.equal(back.entry_coords(), t.entry_coords()[:3]) and int(back.collide_with(t)) == 3


def test_disk_io_methods_and_map_type_guard(tmp_path):
    """write_to_disk / read_from_disk on the maps themselves; a file of
    another MapType raises, as the reference does."""
    pts = np.array([[1.5, 2.5, 3.5], [4.5, 5.5, 6.5]], np.float32)
    m = TProb.create((8, 8, 8), device="cpu").insert_point_cloud(pts)
    assert m.write_to_disk(tmp_path / "p.bin")
    back = TProb.create((8, 8, 8), device="cpu").read_from_disk(tmp_path / "p.bin")
    assert torch.equal(back.data, m.data) and back.device.type == "cpu"
    lst = T.bit_vector_voxel_list((8, 8, 8), device="cpu").insert_point_cloud(pts, 50)
    assert lst.write_to_disk(tmp_path / "l.bin")
    assert int(T.bit_vector_voxel_list((8, 8, 8), device="cpu").read_from_disk(tmp_path / "l.bin").collide_with(lst)) == 2
    with pytest.raises(ValueError):
        TProb.create((8, 8, 8), device="cpu").read_from_disk(tmp_path / "l.bin")
    with pytest.raises(ValueError):
        T.counting_voxel_list((8, 8, 8), device="cpu").read_from_disk(tmp_path / "l.bin")
    # the reference rejects the mismatch too
    with pytest.raises(ValueError):
        JProb.create((8, 8, 8)).read_from_disk(tmp_path / "l.bin")


def test_counting_map_reads_its_own_file(tmp_path):
    """F14: a CountingVoxelMap's MapType is MT_COUNTING_VOXELLIST, so the
    reference's read_from_disk, which dispatches on the file's MapType,
    hands the dense file to the list reader and fails; the port reads each
    map with its own tier's reader. The bytes are the reference's."""
    pts = np.array([[1.5, 2.5, 3.5], [1.5, 2.5, 3.5], [4.5, 5.5, 6.5]], np.float32)
    j = JCount.create((8, 8, 8)).insert_point_cloud(pts)
    t = TCount.create((8, 8, 8), device="cpu").insert_point_cloud(pts)
    assert j.write_to_disk(tmp_path / "c.ref") and t.write_to_disk(tmp_path / "c.port")
    assert (tmp_path / "c.port").read_bytes() == (tmp_path / "c.ref").read_bytes()
    with pytest.raises(ValueError):
        j.read_from_disk(tmp_path / "c.ref")
    back = t.read_from_disk(tmp_path / "c.ref")
    assert isinstance(back, TCount) and torch.equal(back.data, t.data)


# -- 60-bit Morton ids: the uint64 keys that morton list files carry ---------
def test_morton_codes_match_reference():
    rng = np.random.default_rng(0)
    xyz = rng.integers(0, 1 << 20, (3, 500)).astype(np.int64)
    xyz[:, :4] = [[0, 1023, 1024, (1 << 20) - 1]] * 3
    hi, lo = tmorton.morton_code60(*(torch.tensor(v) for v in xyz))
    jhi, jlo = jmorton.morton_code60(*(jnp.asarray(v, jnp.uint32) for v in xyz))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tmorton.morton_key60(*(torch.tensor(v) for v in xyz)).numpy(),
                                  (np.asarray(jhi).astype(np.int64) << 30) | np.asarray(jlo))
    back = tmorton.inv_morton_code60(hi, lo)
    for got, want in zip(back, xyz):
        np.testing.assert_array_equal(got.numpy(), want)
    # wrapped coordinates (negative, past 2^20) and raw 32-bit codes: the
    # reference's uint32 arithmetic bit for bit
    odd = np.array([-1, -1024, 1 << 21, 2**31 - 1], np.int64)
    for got, want in zip(tmorton.morton_code60(*(torch.tensor(odd),) * 3),
                         jmorton.morton_code60(*(jnp.asarray(odd.astype(np.int32)).astype(jnp.uint32),) * 3)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    codes = rng.integers(0, 2**32, 300, dtype=np.uint64)
    for got, want in zip(tmorton.inv_morton_code30(torch.tensor(codes.astype(np.int64))),
                         jmorton.inv_morton_code30(jnp.asarray(codes.astype(np.uint32)))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _morton_pair(dims, pts, meaning=50):
    """A reference and a port morton bit list of `pts`, equal field for field."""
    j = J.bit_vector_morton_voxel_list(dims).insert_point_cloud(pts, meaning)
    t = T.bit_vector_morton_voxel_list(dims, device="cpu").insert_point_cloud(pts, meaning)
    _same_list(t, j)
    return j, t


def _same_files(tmp_path, j, t, name):
    jio.write_voxel_list(j, tmp_path / f"{name}.ref")
    tio.write_voxel_list(t, tmp_path / f"{name}.port")
    assert (tmp_path / f"{name}.port").read_bytes() == (tmp_path / f"{name}.ref").read_bytes()


def test_morton60_coords_beyond_1024(tmp_path):
    """Coordinates past 1,024 keep distinct ids (the high word) and round-trip,
    in memory and through a file, and membership respects the high word."""
    big = (4096, 4096, 4096)
    pts = np.array([[2000.5, 1500.5, 1030.5], [2000.5, 1500.5, 1030.5], [5.5, 6.5, 7.5],
                    [976.5, 476.5, 6.5], [976.5 + 1024, 476.5, 6.5]], np.float32)
    j, t = _morton_pair(big, pts)
    assert sorted(t.entry_coords()[:4].tolist()) == [[5, 6, 7], [976, 476, 6], [2000, 476, 6], [2000, 1500, 1030]]
    assert t.screendump() == j.screendump()
    _same_files(tmp_path, j, t, "big")
    back = tio.read_voxel_list(tmp_path / "big.ref", device="cpu")
    assert torch.equal(back.entry_coords(), t.entry_coords()[:4])
    for probe, want in ((pts[3:4], 1), (np.array([[976.5, 1500.5, 6.5]], np.float32), 0)):
        jp, tp = _morton_pair(big, probe, 60)
        assert int(t.collide_with(tp)) == int(j.collide_with(jp)) == want


def test_lists_beyond_2_32_voxels(tmp_path):
    """Linear ids are uint32: both packages refuse a linear list past 2^32
    voxels. A morton list at 2048^3 holds points beyond coordinate 1024,
    collides with a linear list across id modes and writes the reference's
    file."""
    dims = (2048, 2048, 2048)
    for factory in (J.bit_vector_voxel_list, T.bit_vector_voxel_list):
        with pytest.raises(ValueError, match="morton"):
            factory(dims)
    pts = np.array([[3.5, 4.5, 5.5], [7.5, 7.5, 7.5], [1.5, 2.5, 3.5]], np.float32)
    near = (J.bit_vector_voxel_list((16, 16, 16)).insert_point_cloud(pts, 50),
            T.bit_vector_voxel_list((16, 16, 16), device="cpu").insert_point_cloud(pts, 50))
    _same_list(near[1], near[0])
    far = _morton_pair(dims, pts + 1030.0)
    for x, y, off, want in ((near, far, (1030,) * 3, 3), (far, near, (-1030,) * 3, 3), (near, far, (0, 0, 0), 0)):
        assert int(x[1].collide_with(y[1], offset=off)) == int(x[0].collide_with(y[0], offset=off)) == want
    assert far[1].entry_coords()[:3].min() >= 1030
    _same_files(tmp_path, *far, "far")
