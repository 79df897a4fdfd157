"""Port conformance of the distance-field slice: camera -> distance field.

The pooled depth carve (kernel K6's spec), depth frames fused with
carve_pool > 1, DistanceVoxelMap's methods, the converters, the facade's
distance map and distance-map interop, each run through gpu_voxels_tpu (JAX,
the reference) and gpu_voxels_tpu_torch with the same numpy inputs and held
to exact equality. The reference's pooled carve runs its XLA spec here: the
fixtures' dx is not a multiple of 128, so `projective_free_space_tpu` takes
`projective_free_space_pooled` (gpu_voxels_tpu/ops/raycast_pallas.py:546-550);
fused maps are held against the reference's frame update run op by op (F4),
with every measured point >= 1e-3 voxel from a cell boundary. Reference map
methods run jitted; they share one grid size so each compiles once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_voxels_tpu import converters as jconv
from gpu_voxels_tpu import sensors as jsens
from gpu_voxels_tpu.api import GpuVoxels as JGvl
from gpu_voxels_tpu.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu.geometry.pointcloud import MetaPointCloud as JMeta
from gpu_voxels_tpu.maps.distance_map import DistanceVoxelMap as JDist
from gpu_voxels_tpu.maps.voxelmap import BitVectorVoxelMap as JBit
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import raycast as jrc
from gpu_voxels_tpu.ops import raycast_pallas as jrp
from gpu_voxels_tpu_torch import converters as tconv
from gpu_voxels_tpu_torch import interop, sensors as tsens
from gpu_voxels_tpu_torch.api import GpuVoxels as TGvl
from gpu_voxels_tpu_torch.constants import PBA_UNINITIALISED_PACKED
from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud as TMeta
from gpu_voxels_tpu_torch.maps import DistanceVoxelMap as TDist
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap as TBit
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap as TProb
from gpu_voxels_tpu_torch.ops import edt as tedt
from gpu_voxels_tpu_torch.ops import raycast as trc
from gpu_voxels_tpu_torch.ops import raycast_cuda
from tests.test_torch_raycast import DIMS as CARVE_DIMS
from tests.test_torch_raycast import INTR, _boundary_safe, _min_boundary_distance, _scenes


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


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def same(tmap, jmap):
    np.testing.assert_array_equal(tmap.data.numpy().view(np.asarray(jmap.data).dtype), np.asarray(jmap.data))


@pytest.mark.parametrize("pool", [1, 4, 5, 8])
@pytest.mark.parametrize("scene", ["step_axis", "noise_tilted", "invalid_beam"])
def test_pooled_carve_matches_reference(scene, pool):
    """The port's pooled carve (K6's spec) equals the reference's
    `projective_free_space_pooled` bit for bit (P = 5 pads the image's
    edge tiles), is a subset of the exact carve, and equals it at P = 1."""
    depth, pose = _scenes()[scene]
    got = raycast_cuda.projective_free_space_pooled(torch.tensor(depth), torch.tensor(pose), *INTR, 1.0,
                                                    CARVE_DIMS, pool=pool)
    ref = jrp.projective_free_space_pooled(jnp.asarray(depth), jnp.asarray(pose), *INTR, 1.0, CARVE_DIMS, pool=pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    exact = trc.projective_free_space(torch.tensor(depth), torch.tensor(pose), *INTR, 1.0, CARVE_DIMS)
    assert got.sum() > 0 and not bool((got & ~exact).any())
    if pool == 1:
        assert torch.equal(got, exact)
    pm = trc.min_pool_depth(torch.tensor(depth), pool)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jrp.min_pool_depth(jnp.asarray(depth), pool)))


def _camera():
    kw = dict(position=np.asarray([1.2, 1.0, 0.02], np.float32), orientation_rpy=np.asarray([0.04, -0.03, 0.02], np.float32),
              data_width=64, data_height=48, fx=52.0, fy=52.0, cx=32.0, cy=24.0)
    return jsens.Sensor(**kw), tsens.Sensor(**kw)


def _frame(rng, k, pose):
    depth = np.full((48, 64), 1.45 + 0.02 * k, np.float32)
    depth[12:30, 18:40] = 0.85  # a box in front of the wall
    depth[38:44, 4:12] = 0.0  # invalid patch
    depth += rng.normal(0, 0.01, depth.shape).astype(np.float32)
    return _boundary_safe(depth, pose, SIDE, INTR)


def test_camera_to_distance_field_matches_reference():
    """The slice's path at a small size: three frames fused with the pooled
    carve (carve_pool = 8), merge_occupied into a DistanceVoxelMap, the
    EDT, proximity queries and the clearance bit map."""
    jsensor, tsensor = _camera()
    rng = np.random.default_rng(12)
    jdata, tprob = JProb.create(DIMS, SIDE).data, TProb.create(DIMS, SIDE, device="cpu")
    for k in range(3):
        depth = _frame(rng, k, tsensor.pose())
        assert _min_boundary_distance(np.asarray(jsensor.process_depth_image(depth)), SIDE) >= 1e-3
        jdata = jrc.insert_depth_image(jdata, jnp.asarray(depth), jnp.asarray(jsensor.pose()), *INTR, SIDE, DIMS,
                                       carve_pool=8)
        tprob = tprob.insert_depth_image(depth, tsensor, carve_pool=8)
        np.testing.assert_array_equal(tprob.data.numpy(), np.asarray(jdata), err_msg=f"frame {k}")
    exact = TProb.create(DIMS, SIDE, device="cpu").insert_depth_image(depth, tsensor)
    assert ((tprob.data > 0).sum() > 50) and ((tprob.data < 0) & (tprob.data > -128)).sum() > 100
    assert not torch.equal(exact.data, TProb.create(DIMS, SIDE, device="cpu").insert_depth_image(depth, tsensor, 8).data)

    jdm = JDist.create(DIMS, SIDE).merge_occupied(JProb(jdata, DIMS, SIDE)).jump_flood()
    tdm = TDist.create(DIMS, SIDE, device="cpu").merge_occupied(tprob).jump_flood()
    same(tdm, jdm)
    np.testing.assert_array_equal(tdm.squared_distances().numpy(), np.asarray(jdm.squared_distances()))
    # a robot between the camera and the box
    pts = np.random.default_rng(3).uniform((0.8, 0.6, 0.1), (1.6, 1.4, 0.5), (200, 3)).astype(np.float32)
    assert float(tdm.min_distance_to(pts)) == float(jdm.min_distance_to(pts)) > 0
    tbits, jbits = tconv.distance_map_to_bit_map(tdm, clearance=0.25), jconv.distance_map_to_bit_map(jdm, clearance=0.25)
    np.testing.assert_array_equal(u32(tbits.data), np.asarray(jbits.data))
    np.testing.assert_array_equal(tbits.occ.numpy(), np.asarray(jbits.occ))


def _obstacles():
    rng = np.random.default_rng(4)
    pts = rng.uniform(0, 1, (40, 3)).astype(np.float32) * np.asarray(DIMS, np.float32) * SIDE
    pts[:2] = [[-0.5, 0.3, 0.3], [0.35, 0.35, 9.0]]  # outside the map
    return pts


def test_distance_map_methods_match_reference():
    pts = _obstacles()
    jm, tm = JDist.create(DIMS, SIDE), TDist.create(DIMS, SIDE, device="cpu")
    same(tm, jm)
    assert tm.data.dtype == torch.int32 and tm.memory_usage() == jm.memory_usage()
    jm, tm = jm.insert_point_cloud(pts), tm.insert_point_cloud(pts)
    same(tm, jm)
    jprob = JProb.create(DIMS, SIDE).insert_point_cloud(pts[5:20] + 0.05)
    tprob = TProb.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts[5:20] + 0.05)
    jm, tm = jm.merge_occupied(jprob, 0.6), tm.merge_occupied(tprob, 0.6)
    same(tm, jm)

    for name in ("jump_flood", "parallel_banding", "exact_separable"):
        same(getattr(tm, name)(), getattr(jm, name)())
    obs = np.argwhere(np.asarray(jm.obstacle_mask()).reshape(DIMS[::-1]))[:, ::-1].astype(np.int32)
    same(tm.exact_distances(obs), jm.exact_distances(obs))

    jd, td = jm.parallel_banding(), tm.parallel_banding()
    np.testing.assert_array_equal(td.squared_distances().numpy(), np.asarray(jd.squared_distances()))
    for xyz in ((3, 4, 5), (0, 0, 0), (23, 19, 15)):
        assert int(td.get_squared_obstacle_distance(*xyz)) == int(jd.get_squared_obstacle_distance(*xyz))
        assert float(td.get_obstacle_distance(*xyz)) == float(jd.get_obstacle_distance(*xyz))
    q = pts + 0.13
    assert float(td.min_distance_to(q)) == float(jd.min_distance_to(q))
    for radius in (0, 1):
        np.testing.assert_array_equal(td.extract_distances(radius).numpy(), np.asarray(jd.extract_distances(radius)))
    np.testing.assert_array_equal(td.init_floodfill().numpy(), np.asarray(jd.init_floodfill()))
    np.testing.assert_array_equal(td.obstacle_mask().numpy(), np.asarray(jd.obstacle_mask()))
    assert int(td.differences(tm)) == int(jd.differences(jm)) > 0
    assert int(td.differences(td.clone())) == 0

    link = np.asarray([[0.55, 0.55, 0.55]], np.float32)
    for clouds in ([link, link + 0.3], [link, link]):
        jr, jok = jm.insert_robot_configuration(JMeta.from_clouds(clouds), with_self_collision_test=True)
        tr, tok = tm.insert_robot_configuration(TMeta.from_clouds(clouds, device="cpu"), with_self_collision_test=True)
        same(tr, jr)
        assert bool(tok) == bool(jok)
    same(tm.clear_voxel_meaning(BitVoxelMeaning.eBVM_COLLISION), jm.clear_voxel_meaning(BitVoxelMeaning.eBVM_COLLISION))
    same(tm.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED), jm.clear_voxel_meaning(BitVoxelMeaning.eBVM_OCCUPIED))
    assert (u32(tm.fill_pba_uninit().data) == PBA_UNINITIALISED_PACKED).all()
    # printVoxelMapData (item 12): the packed coordinates print as the reference's uint32
    assert tm.print_voxel_map_data() == jm.print_voxel_map_data()


def test_jump_flood_routes_like_reference(monkeypatch):
    """A CPU map takes the reference's CPU routes: the multiresolution JFA
    for large divisible grids, the flat JFA otherwise (and for
    extra_rounds > 1); the envelope route (K5) is the CUDA map's."""
    calls = []
    monkeypatch.setattr(tedt, "jump_flood_multires", lambda data, dims: calls.append(("multires", dims)) or data)
    monkeypatch.setattr(tedt, "jump_flood", lambda data, dims, extra: calls.append(("flat", dims, extra)) or data)
    for dims, extra in (((128, 128, 128), 1), ((128, 132, 128), 1), ((128, 128, 130), 1), ((128, 64, 128), 1),
                        ((128, 128, 128), 2)):
        TDist.create(dims, device="cpu").jump_flood(extra)
    assert calls == [("multires", (128, 128, 128)), ("multires", (128, 132, 128)), ("flat", (128, 128, 130), 1),
                     ("flat", (128, 64, 128), 1), ("flat", (128, 128, 128), 2)]


def test_cpu_jump_flood_repair_stops_at_its_cap():
    """The CPU route's multiresolution JFA (and the flat one) stop the
    step-1 repair at 64 rounds, as the reference's do; only the CUDA route
    (K5) is exact. Two sites share a coarse block; the one nearer the block
    centre seeds the whole coarse grid, so the other's cell (x >= 3 along
    128 voxels) is repaired one voxel a round: the cap binds and the result
    differs from the exact EDT; run to its fixpoint the repair takes 108
    rounds and is exact."""
    dims = (128, 4, 32)
    m = TDist.create(dims, device="cpu").insert_point_cloud(np.array([[1.5, 0.5, 0.5], [3.5, 0.5, 0.5]], np.float32))
    exact = m.parallel_banding().squared_distances()
    capped, rounds = tedt.jump_flood_multires_with_stats(m.data, dims)
    assert rounds == 64
    assert not torch.equal(tedt.squared_distance_grid(capped, dims), exact)
    assert int((tedt.squared_distance_grid(capped, dims) < exact).sum()) == 0  # never nearer than the nearest
    fixpoint, rounds = tedt.jump_flood_multires_with_stats(m.data, dims, max_iters=1000)
    assert rounds == 108 and torch.equal(tedt.squared_distance_grid(fixpoint, dims), exact)


def test_converters_match_reference():
    pts = _obstacles()
    jd = JDist.create(DIMS, SIDE).insert_point_cloud(pts).parallel_banding()
    td = TDist.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts).parallel_banding()
    for clearance in (0.0, 0.15, 0.3):
        same(tconv.distance_map_to_prob_map(td, clearance), jconv.distance_map_to_prob_map(jd, clearance))
        tb, jb = tconv.distance_map_to_bit_map(td, clearance, 40), jconv.distance_map_to_bit_map(jd, clearance, 40)
        np.testing.assert_array_equal(u32(tb.data), np.asarray(jb.data))
        np.testing.assert_array_equal(tb.occ.numpy(), np.asarray(jb.occ))
    jprob = JProb.create(DIMS, SIDE).insert_point_cloud(pts).update_occupancy(pts[::2], -60)
    tprob = TProb.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts).update_occupancy(pts[::2], -60)
    for meaning in (0, 1, 77):
        tb, jb = tconv.prob_map_to_bit_map(tprob, 0.55, meaning), jconv.prob_map_to_bit_map(jprob, 0.55, meaning)
        np.testing.assert_array_equal(u32(tb.data), np.asarray(jb.data))
        np.testing.assert_array_equal(tb.occ.numpy(), np.asarray(jb.occ))
    jbit = JBit.create(DIMS, SIDE).insert_point_cloud(pts, 9).insert_point_cloud(pts[::3], 0)
    tbit = TBit.create(DIMS, SIDE, device="cpu").insert_point_cloud(pts, 9).insert_point_cloud(pts[::3], 0)
    same(tconv.bit_map_to_prob_map(tbit), jconv.bit_map_to_prob_map(jbit))


def test_facade_distance_map_and_interop_round_trip():
    """add_map(MT_DISTANCE_VOXELMAP) in both facades; a reference distance
    map continues in the port and comes back equal."""
    pts = _obstacles()
    jg, tg = JGvl(), TGvl()
    jg.initialize(*DIMS, SIDE)
    tg.initialize(*DIMS, SIDE, device="cpu")
    for g in (jg, tg):
        m = g.add_map(MapType.MT_DISTANCE_VOXELMAP, "dist")
        g.insert_point_cloud_into_map(pts, "dist")
        g.update_map("dist", lambda mm: mm.parallel_banding())
    assert isinstance(m, TDist) and m.device.type == "cpu"
    same(tg.get_map("dist"), jg.get_map("dist"))

    jm = JDist.create(DIMS, SIDE).insert_point_cloud(pts)
    tm = interop.distance_map_from_numpy(np.asarray(jm.data), DIMS, SIDE, "cpu")
    back = interop.to_numpy(tm.parallel_banding())
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, np.asarray(jm.parallel_banding().data))
    with pytest.raises(ValueError):
        interop.distance_map_from_numpy(np.zeros(N, np.int32), DIMS, SIDE, "cpu")
