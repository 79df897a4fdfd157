"""The distance monitor's chain on the CPU: depth frames into a ProbVoxelMap
(`insert_depth_image`), its occupied voxels as the obstacles of a
DistanceVoxelMap (`merge_occupied`), the exact EDT (`parallel_banding`) and
a clearance query (`min_distance_to`), held to a brute-force squared EDT
over every pair of voxel and obstacle and to the clearance read from it,
both written here: equal squared distances, equal clearances. Scenes with
seeded frames, with an obstacle on every face of the map, and with none;
queries inside the map, outside it, and both."""
import numpy as np
import pytest
import torch

from gpu_voxels_tpu_torch.constants import MAX_OBSTACLE_DISTANCE, float_to_probability
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.sensors import Sensor


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


DIMS, SIDE, THRESHOLD = (32, 32, 32), 0.08, 0.7  # a 2.56 m cube
H, W = 48, 64


def _sensor() -> Sensor:
    """A 64x48 camera above the cube's centre looking down, tilted."""
    return Sensor(position=np.asarray([1.28, 1.2, 2.5], np.float32),
                  orientation_rpy=np.asarray([3.0, 0.12, 0.3], np.float32),
                  data_width=W, data_height=H, fx=40.0, fy=40.0, cx=31.5, cy=23.5)


def _frames(seed: int, count: int = 3) -> list:
    """A wavy surface 1.2-2.4 m from the camera with seeded noise."""
    g = np.random.default_rng(seed)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    base = 1.8 + 0.3 * np.sin(u / 7.0) * np.cos(v / 5.0)
    return [(base + g.normal(0.0, 0.01, base.shape)).astype(np.float32) for _ in range(count)]


def _environment(scene: str) -> ProbVoxelMap:
    env = ProbVoxelMap.create(DIMS, SIDE, device="cpu")
    if scene == "frames":
        for frame in _frames(20251018):
            env = env.insert_depth_image(frame, _sensor())
    elif scene == "faces":  # one voxel centre on each of the six faces
        last = DIMS[0] - 1
        faces = np.array([[0, 7, 9], [last, 20, 3], [5, 0, 30], [11, last, 14], [26, 2, 0], [17, 23, last]])
        env = env.insert_point_cloud(((faces + 0.5) * SIDE).astype(np.float32))
    else:  # a frame with no valid depth: nothing measured, nothing carved
        env = env.insert_depth_image(np.zeros((H, W), np.float32), _sensor())
    return env


def _brute_d2(obstacles: np.ndarray) -> np.ndarray:
    """int64 [Z, Y, X]: every voxel against every obstacle, INT_MAX with none."""
    occ = np.argwhere(obstacles)
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in obstacles.shape], indexing="ij"), -1).reshape(-1, 3)
    best = np.full(len(grid), MAX_OBSTACLE_DISTANCE, np.int64)
    for s in range(0, len(occ), 256):
        best = np.minimum(best, ((grid[:, None] - occ[None, s:s + 256]) ** 2).sum(-1).min(-1))
    return best.reshape(obstacles.shape)


def _queries(kind: str, seed: int) -> np.ndarray:
    """float32 [n, 3] voxel centres inside the map, points outside it, or both."""
    g = np.random.default_rng(seed)
    inside = ((g.integers(0, DIMS[0], (40, 3)) + 0.5) * SIDE).astype(np.float32)
    outside = np.array([[-0.3, 1.0, 1.0], [1.0, 2.7, 0.4], [0.5, 0.5, -0.04], [3.0, 3.0, 3.0]], np.float32)
    return {"inside": inside, "outside": outside, "mixed": np.concatenate([outside[:2], inside[:10], outside[2:]])}[kind]


def _brute_clearance(d2: np.ndarray, points: np.ndarray) -> float:
    """The least squared distance at the points' voxels (INT_MAX outside
    the map), in metres."""
    cells = np.floor(points / SIDE).astype(np.int64)
    inside = ((cells >= 0) & (cells < np.array(DIMS))).all(-1)
    c = np.clip(cells, 0, DIMS[0] - 1)
    least = np.where(inside, d2[c[:, 2], c[:, 1], c[:, 0]], MAX_OBSTACLE_DISTANCE).min()
    return float(torch.sqrt(torch.tensor(float(least), dtype=torch.float32)) * SIDE)


@pytest.mark.parametrize("query", ["inside", "outside", "mixed"])
@pytest.mark.parametrize("scene", ["frames", "faces", "none"])
def test_the_distance_chain_equals_brute_force(scene, query):
    env = _environment(scene)
    field = DistanceVoxelMap.create(DIMS, SIDE, device="cpu").merge_occupied(env, THRESHOLD).parallel_banding()
    obstacles = (env.data.to(torch.int32) >= float_to_probability(THRESHOLD)).reshape(DIMS[::-1]).numpy()
    want = _brute_d2(obstacles)
    assert np.array_equal(field.squared_distances().numpy(), want)
    points = _queries(query, 7 + len(scene))
    got = field.min_distance_to(points)
    assert got.dtype == torch.float32 and float(got) == _brute_clearance(want, points)
    n = int(obstacles.sum())
    assert {"frames": n > 50, "faces": n == 6, "none": n == 0}[scene]
    if scene == "none" or query == "outside":
        assert float(got) == float(np.sqrt(np.float32(MAX_OBSTACLE_DISTANCE)) * np.float32(SIDE))
