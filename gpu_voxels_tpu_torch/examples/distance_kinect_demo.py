"""Port of examples/DistanceKinectDemo.cpp: live depth frames feed a
probabilistic map, whose occupied voxels become EDT obstacles; proximity
queries then report clearance (e.g. for speed scaling a robot)."""
import numpy as np

from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.sensors import Sensor, SyntheticDepthSource


def main(frames: int = 3, device=None):
    dims = (96, 96, 96)
    sensor = Sensor(
        position=np.array([4.8, 4.8, 0.2], np.float32),
        data_width=64,
        data_height=48,
        fx=40.0,
        fy=40.0,
        cx=32.0,
        cy=24.0,
    )
    source = SyntheticDepthSource(sensor, seed=1)
    env = ProbVoxelMap.create(dims, 0.1, device=device)

    clearance = None
    for i in range(frames):
        depth = source.get_frame()
        env = env.insert_depth_image(depth, sensor)
        dm = DistanceVoxelMap.create(dims, 0.1, device=device).merge_occupied(env, 0.6).parallel_banding()
        robot_points = np.array([[4.8, 4.8, 2.0], [5.0, 4.6, 2.2]], np.float32)
        clearance = float(dm.min_distance_to(robot_points))
        print(f"frame {i}: min obstacle distance = {clearance:.3f} m")
    return clearance


if __name__ == "__main__":
    main()
