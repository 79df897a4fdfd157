"""Port conformance: the per-ray DDA sensor insert, counting maps, the
streaming and socket depth sources and the Provider contract.

The same numpy rays and points go through gpu_voxels_tpu (JAX, the
reference) and gpu_voxels_tpu_torch; crossing counts, int8 maps and masks
must be equal. The DDA is held against the reference's functions called op
by op (`raycast.insert_sensor_data`, `raycast.ray_crossing_counts`): its
loop body is compiled by XLA even then, which may fuse `start + step * k`
into one rounding, so every fixture keeps every ray sample and every
endpoint at least 1e-3 voxel from a cell boundary (asserted), where neither
that nor the transform's summation order can move a sample.
"""
import socket
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import providers as jprov
from gpu_voxels_tpu import sensors as jsens
from gpu_voxels_tpu.geometry import transforms as jtf
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import CountingVoxelMap as JCount
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import insert as jins
from gpu_voxels_tpu.ops import raycast as jrc
from gpu_voxels_tpu_torch import interop, providers as tprov, sensors as tsens
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import CountingVoxelMap as TCount
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import insert as tins
from gpu_voxels_tpu_torch.ops import raycast as trc


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


DIMS, SIDE = (24, 20, 16), 0.1
N = DIMS[0] * DIMS[1] * DIMS[2]
MARGIN = 1e-3  # voxels


def _sample_margin(origin, points, side=SIDE, max_steps=256):
    """Per ray, the least distance (in voxels) of any of its DDA samples and
    of its endpoint from a cell boundary, computed in float64 from the
    reference's formula; NaN rays have no sample (inf)."""
    recip = float(np.float32(1.0 / side))
    start = np.asarray(origin, np.float64) * recip
    end = np.asarray(points, np.float64) * recip
    out = np.full(len(end), np.inf)
    for i, e in enumerate(end):
        if not np.isfinite(e).all():
            continue
        delta = e - start
        steps = int(np.ceil(np.abs(delta).max()))
        k = np.arange(min(steps, max_steps))[:, None]
        pos = np.concatenate([start + delta / max(steps, 1) * k, e[None]])
        out[i] = np.abs(pos - np.round(pos)).min()
    return out


def _rays(seed, origin, count=260, spill=0.25):
    """Endpoints in and (by `spill` of the extent) around the map, a few NaN
    rows, with every ray whose samples come near a cell boundary dropped."""
    rng = np.random.default_rng(seed)
    ext = np.asarray(DIMS, np.float32) * SIDE
    pts = (rng.uniform(-spill, 1 + spill, (count, 3)) * ext).astype(np.float32)
    pts[::37] = np.nan
    pts[5, 1] = np.inf
    pts = pts[_sample_margin(origin, pts) >= 2 * MARGIN]
    assert len(pts) > count // 3 and np.isnan(pts).any()
    assert (_sample_margin(origin, pts) >= MARGIN).all()
    inside = np.isfinite(pts).all(1) & ((pts >= 0) & (pts < ext)).all(1)
    assert inside.any() and (~inside & np.isfinite(pts).all(1)).any()  # in-map, out-of-map and NaN endpoints
    return pts


ORIGINS = {"inside": (1.23, 0.87, 0.31), "outside": (-0.37, 2.44, 0.73)}


@pytest.mark.parametrize("max_steps", [256, 12])
@pytest.mark.parametrize("where", ["inside", "outside"])
def test_ray_crossing_counts_match_reference(where, max_steps):
    origin = ORIGINS[where]
    pts = _rays(1, origin)
    ref = np.asarray(jrc.ray_crossing_counts(jnp.asarray(origin, jnp.float32), jnp.asarray(pts), SIDE, DIMS, max_steps))
    got = trc.ray_crossing_counts(origin, torch.tensor(pts), SIDE, DIMS, max_steps)
    assert got.dtype == torch.int32 and got.shape == (N,) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() > 0 and ref.max() > 1  # cells crossed by several rays keep their multiplicity
    if max_steps == 12:  # a ray longer than max_steps stops early
        full = trc.ray_crossing_counts(origin, torch.tensor(pts), SIDE, DIMS, 256)
        assert int(full.sum()) > int(got.sum())


def _prior(seed):
    """A map with history: unknown, free and occupied voxels."""
    rng = np.random.default_rng(seed)
    data = np.full(N, -128, np.int8)
    some = rng.random(N) < 0.3
    data[some] = rng.integers(-127, 128, some.sum()).astype(np.int8)
    return data


@pytest.mark.parametrize("case", ["raycast", "hits_only", "cut_robot_mask", "cut_robot_map", "short_rays"])
def test_insert_sensor_data_matches_reference(case):
    origin = ORIGINS["inside"]
    pts = _rays(2, origin)
    prior = _prior(3)
    kw = dict(enable_raycasting=case != "hits_only", max_steps=20 if case == "short_rays" else 256)
    jkw, tkw = dict(kw), dict(kw)
    tmap = interop.prob_map_from_numpy(prior, DIMS, SIDE, "cpu")
    if case.startswith("cut_robot"):
        robot_pts = pts[np.isfinite(pts).all(1)][::2]
        jrobot = JBit.create(DIMS, SIDE).insert_point_cloud(robot_pts)
        trobot = TBit.create(DIMS, SIDE, device="cpu").insert_point_cloud(robot_pts)
        assert int(trobot.occ.sum()) > 0
        jkw.update(cut_real_robot=True, robot_occupied_mask=jrobot.occupied_mask())
        tkw.update(cut_real_robot=True, robot_map=trobot if case == "cut_robot_map" else trobot.occupied_mask())
    ref = np.asarray(jrc.insert_sensor_data(jnp.asarray(prior), origin, jnp.asarray(pts), SIDE, DIMS, **jkw))
    got = tmap.insert_sensor_data(pts, sensor_origin=origin, **tkw)
    assert isinstance(got, TProb) and got.data.dtype == torch.int8
    np.testing.assert_array_equal(interop.to_numpy(got), ref)
    np.testing.assert_array_equal(interop.to_numpy(tmap), prior)  # the input map is untouched
    assert (ref != prior).any()
    if case == "raycast":
        # the reference's map method (one compiled program) agrees on these fixtures
        jgot = JProb(jnp.asarray(prior), DIMS, SIDE).insert_sensor_data(pts, sensor_origin=origin)
        np.testing.assert_array_equal(np.asarray(jgot.data), ref)
        # the ops-level entry point, and a frame of NaN rays only changes nothing
        ops = trc.insert_sensor_data(torch.tensor(prior), origin, torch.tensor(pts), SIDE, DIMS)
        np.testing.assert_array_equal(ops.numpy(), ref)
        nan = tmap.insert_sensor_data(np.full((4, 3), np.nan, np.float32), sensor_origin=origin)
        np.testing.assert_array_equal(interop.to_numpy(nan), prior)
    if case == "cut_robot_mask":
        uncut = tmap.insert_sensor_data(pts, sensor_origin=origin)
        assert (interop.to_numpy(uncut) != ref).any()


def test_stored_sensor_flow_matches_reference():
    """init_sensor_settings / update_sensor_pose: sensor-frame points are
    moved by the stored pose, and the sensor rides on every derived map."""
    kw = dict(position=np.asarray([1.23, 0.87, 0.31], np.float32),
              orientation_rpy=np.asarray([0.2, -0.1, 0.5], np.float32))
    jsensor, tsensor = jsens.Sensor(**kw), tsens.Sensor(**kw)
    world = _rays(4, tuple(kw["position"]))
    world = world[np.isfinite(world).all(1)]
    pose = tsensor.pose().astype(np.float64)
    local = ((world.astype(np.float64) - pose[:3, 3]) @ pose[:3, :3]).astype(np.float32)
    jworld = np.asarray(jtf.transform_points(jnp.asarray(jsensor.pose()), jnp.asarray(local)))
    assert (_sample_margin(kw["position"], jworld) >= MARGIN).all()

    tmap = TProb.create(DIMS, SIDE, device="cpu")
    with pytest.raises(RuntimeError, match="Initialize Sensor first"):
        tmap.update_sensor_pose(tsensor)
    # without a stored sensor the origin is 0 and the points are world-frame
    plain = tmap.insert_sensor_data(world)
    ref0 = jrc.insert_sensor_data(JProb.create(DIMS, SIDE).data, (0.0, 0.0, 0.0), jnp.asarray(world), SIDE, DIMS)
    np.testing.assert_array_equal(interop.to_numpy(plain), np.asarray(ref0))

    tmap.init_sensor_settings(tsensor)
    ref = jrc.insert_sensor_data(JProb.create(DIMS, SIDE).data, tuple(float(v) for v in kw["position"]),
                                 jnp.asarray(jworld), SIDE, DIMS)
    got = tmap.insert_sensor_data(local)
    np.testing.assert_array_equal(interop.to_numpy(got), np.asarray(ref))
    jmap = JProb.create(DIMS, SIDE)
    jmap.init_sensor_settings(jsensor)
    np.testing.assert_array_equal(np.asarray(jmap.insert_sensor_data(local).data), np.asarray(ref))
    # carried by every derived map: a second frame, a clear, a point insert
    for derived in (got, got.clear_map(), got.insert_point_cloud(world[:3]), got.clone()):
        assert derived._sensor is tsensor
    again = got.clear_map().insert_sensor_data(local)
    np.testing.assert_array_equal(interop.to_numpy(again), np.asarray(ref))
    # a moved sensor: the stored one is refreshed in place
    moved = tsens.Sensor(position=np.asarray([0.4, 0.4, 0.4], np.float32))
    got.update_sensor_pose(moved)
    np.testing.assert_array_equal(tsensor.position, moved.position)
    np.testing.assert_array_equal(tsensor.orientation_rpy, np.zeros(3, np.float32))


def test_insert_count_wraps_like_the_reference():
    rng = np.random.default_rng(6)
    ext = np.asarray(DIMS, np.float32) * SIDE
    pts = (rng.uniform(-0.1, 1.1, (3000, 3)) * ext).astype(np.float32)
    pts = np.concatenate([pts, np.tile(np.asarray([[0.05, 0.05, 0.05]], np.float32), (300, 1))])
    data = rng.integers(-128, 128, N).astype(np.int8)
    data[0] = 0
    ref, ref_out = jins.insert_count(jnp.asarray(data), jnp.asarray(pts), SIDE, DIMS)
    got, out = tins.insert_count(torch.tensor(data), torch.tensor(pts), SIDE, DIMS)
    assert got.dtype == torch.int8 and bool(out) == bool(ref_out) is True
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the raw int8 counter wraps: 127 + 1 -> -128, 255 -> -1, 256 -> 0
    one = torch.tensor([[0.05, 0.05, 0.05]])
    for start, extra, expect in ((127, 1, -128), (0, 255, -1), (0, 256, 0), (-1, 1, 0)):
        cell = torch.full((N,), start, dtype=torch.int8)
        new, _ = tins.insert_count(cell, one.repeat(extra, 1), SIDE, DIMS)
        assert int(new[0]) == expect and int(new[1]) == start
        if extra == 1:  # the reference wraps alike (one compiled shape)
            jnew, _ = jins.insert_count(jnp.full((N,), start, jnp.int8), jnp.asarray(one.numpy()), SIDE, DIMS)
            assert int(jnew[0]) == expect


def test_counting_voxel_map_matches_reference():
    rng = np.random.default_rng(7)
    ext = np.asarray(DIMS, np.float32) * SIDE
    pts = (rng.uniform(0, 1, (4000, 3)) ** 2 * ext).astype(np.float32)  # dense near the origin
    jm, tm = JCount.create(DIMS, SIDE), TCount.create(DIMS, SIDE, device="cpu")
    assert tm.data.dtype == torch.int8 and tm.map_type == jm.map_type and tm.device.type == "cpu"
    for chunk in (pts[:2500], pts[2500:]):
        jm, tm = jm.insert_point_cloud(chunk), tm.insert_point_cloud(chunk, meaning=17)
    np.testing.assert_array_equal(interop.to_numpy(tm), np.asarray(jm.data))
    for threshold in (1, 3, 10):
        np.testing.assert_array_equal(tm.occupied_mask(threshold).numpy(), np.asarray(jm.occupied_mask(threshold)))
    assert int(tm.occupied_mask(3).sum()) > 0
    assert tm.memory_usage() == jm.memory_usage() == N
    carried = interop.counting_map_from_numpy(np.asarray(jm.data), DIMS, SIDE, "cpu")
    assert isinstance(carried, TCount) and torch.equal(carried.data, tm.data)
    assert not tm.clear_map().data.any() and not np.asarray(jm.clear_map().data).any()
    with pytest.raises(ValueError):
        interop.counting_map_from_numpy(np.zeros(N, np.int16), DIMS, SIDE, "cpu")


def test_streaming_depth_source_cadence():
    """tests/test_aux.py:55, shortened: frames come due at the cadence, an
    early poll gives None, a slow consumer drops what it missed, and a
    source that does not loop runs out. Frames pass through untouched."""
    frames = [np.full((2, 2), float(i), np.float32) for i in range(100)]
    for cls in (tsens.StreamingDepthSource, jsens.StreamingDepthSource):
        src = cls(frames, hz=200.0)
        f0 = src.get_frame()
        assert f0 is frames[0]
        assert src.get_frame() is None  # polled again at once: not due yet
        f1 = src.wait_for_frame(timeout_s=0.3)
        assert f1 is not None and float(f1[0, 0]) >= 1.0
        time.sleep(5.5 / 200.0)  # past ~5 frames: dropped
        fn = src.get_frame()
        assert fn is not None and float(fn[0, 0]) >= float(f1[0, 0]) + 4
        short = cls(frames[:2], hz=1000.0, loop=False)
        assert short.wait_for_frame(0.1) is not None
        time.sleep(3.0 / 1000.0)
        assert short.get_frame() is None and short.wait_for_frame(0.01) is None
    tensor_frame = torch.ones(2, 2)
    assert tsens.StreamingDepthSource(lambda: tensor_frame, hz=500.0).get_frame() is tensor_frame


def test_socket_depth_source_roundtrip():
    """tests/test_aux.py:81: length-prefixed float32 frames over TCP land in
    the latest-wins buffer; get_frame() hands each new frame out once."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    server.settimeout(5.0)
    port = server.getsockname()[1]
    sent = [np.arange(6, dtype=np.float32).reshape(2, 3) + i for i in range(3)]

    def producer():
        conn, _ = server.accept()
        for f in sent:
            jsens.SocketDepthSource.send_frame(conn, f)  # the reference's wire format
        conn.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    src = tsens.SocketDepthSource("127.0.0.1", port)
    try:
        got = []
        deadline = time.monotonic() + 5.0
        while not any(np.array_equal(f, sent[-1]) for f in got) and time.monotonic() < deadline:
            f = src.get_frame()
            if f is not None:
                got.append(f)
            time.sleep(0.005)
        t.join(5.0)
        assert not t.is_alive()
        assert got and got[-1].shape == (2, 3) and got[-1].dtype == np.float32
        np.testing.assert_array_equal(got[-1], sent[-1])
        assert src.get_frame() is None  # nothing new since the last poll
    finally:
        src.close()
        server.close()


def test_provider_contract(tmp_path):
    """tests/test_aux.py:267 through both packages, plus the async count,
    the pooled carve and a map without insert_depth_image."""
    kw = dict(position=np.array([8.0, 8.0, 0.2], np.float32), data_width=16, data_height=12,
              fx=10.0, fy=10.0, cx=8.0, cy=6.0)
    jsensor, tsensor = jsens.Sensor(**kw), tsens.Sensor(**kw)
    dims = (16, 16, 16)
    robot_pts = np.array([[8.5, 8.5, 4.5], [8.5, 8.5, 3.5]], np.float32)
    frame = jsens.SyntheticDepthSource(jsensor).get_frame()

    def scene(prov_cls, prob, bit, src, sensor, **mk):
        env = prov_cls("env")
        env.init(prob.create(dims, 1.0, **mk))
        robot = prov_cls("robot")
        robot.init(bit.create(dims, 1.0, **mk).insert_point_cloud(robot_pts))
        robot.set_collide_with(env, coll_threshold=0.6)
        assert robot.collide() == 0 and prov_cls("lonely").collide() == 0
        assert env.wait_for_new_data(src, sensor)
        return env, robot

    jenv, jrobot = scene(jprov.Provider, JProb, JBit, jsens.ReplayDepthSource(frame[None]), jsensor)
    tenv, trobot = scene(tprov.Provider, TProb, TBit, tsens.ReplayDepthSource(frame[None]), tsensor, device="cpu")
    ref = np.asarray(jrc.insert_depth_image(JProb.create(dims, 1.0).data, jnp.asarray(frame), jnp.asarray(jsensor.pose()),
                                            10.0, 10.0, 8.0, 6.0, 1.0, dims))
    np.testing.assert_array_equal(interop.to_numpy(tenv.map), ref)
    assert trobot.collide() == jrobot.collide() >= 0
    count = trobot.collide_async()
    assert isinstance(count, torch.Tensor) and count.dtype == torch.int64 and int(count) == trobot.collide()
    assert tprov.Provider("lonely").collide_async() is None
    assert trobot._collide_kwargs() == {"coll_threshold": 0.6}

    # a source that never delivers: the wait gives up
    class Never(tsens.DepthSource):
        def get_frame(self):
            return None

    assert not tenv.wait_for_new_data(Never(), tsensor, timeout_s=0.02)
    # cadenced sources are waited for
    streamed = tprov.Provider("streamed", carve_pool=4)
    streamed.init(TProb.create(dims, 1.0, device="cpu"))
    assert streamed.wait_for_new_data(tsens.StreamingDepthSource([frame], hz=500.0), tsensor, timeout_s=0.3)
    pooled = TProb.create(dims, 1.0, device="cpu").insert_depth_image(frame, tsensor, carve_pool=4)
    assert torch.equal(streamed.map.data, pooled.data)
    # a map without insert_depth_image takes the frame as a point cloud
    bits = tprov.Provider("bits")
    bits.init(TBit.create(dims, 1.0, device="cpu"))
    bits.new_sensor_data(frame, tsensor)
    jbits = jprov.Provider("bits")
    jbits.init(JBit.create(dims, 1.0))
    jbits.new_sensor_data(frame, jsensor)
    np.testing.assert_array_equal(interop.to_numpy(bits.map)[1], np.asarray(jbits.map.occ))
    # the visualisation side (item 12): the fused map's files equal the
    # reference provider's, synchronously and through the live publisher
    for name, prov, live in (("port", tenv, tprov.Provider("env", live_vis=True, vis_max_cubes=10)),
                             ("ref", jenv, jprov.Provider("env", live_vis=True, vis_max_cubes=10))):
        prov._vis.out_dir = live._vis.out_dir = tmp_path / name
        assert prov.visualize() and prov.finish_visualization() == 0
        live.init(prov.map)
        assert live.visualize() and live.finish_visualization() >= 1
        live._vis_async.stop()
    for fname in ("env.ply", "env.html", "env.cubes.json"):
        assert (tmp_path / "port" / fname).read_bytes() == (tmp_path / "ref" / fname).read_bytes(), fname
