"""Port of examples/tfInterface.cpp: publish/lookup transform frames and
re-derive rotations through both toRPY solutions.

The reference loops over ROS tf: lookup world->demo_tf_1, transform a
coordinate-system cloud into a BitVectorVoxelMap, then rebuilds the rotation
from Matrix3f::toRPY(1) and toRPY(2) and republishes both as demo frames
(tfInterface.cpp:85-107). Headless here: TfHelper holds the frame graph (no
ROS), one iteration, and we assert the reference's invariant implicitly
demonstrated by its viewer — both RPY solutions reconstruct the SAME
rotation, so all three transforms place the cloud identically.
"""
import numpy as np

from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.geometry import transforms
from gpu_voxels_tpu_torch.utils import resolve_device
from gpu_voxels_tpu_torch.utils.tf_helper import TfHelper


def coordinate_system_cloud(length=0.1, step=0.005):
    """Stand-in for coordinate_system_100.binvox: points along the 3 axes."""
    t = np.arange(step, length, step, dtype=np.float32)
    z = np.zeros_like(t)
    return np.concatenate([
        np.stack([t, z, z], -1), np.stack([z, t, z], -1), np.stack([z, z, t], -1),
        np.zeros((1, 3), np.float32),
    ])


def main(device=None):
    device = resolve_device(device)
    gvl = GpuVoxels()
    gvl.initialize(200, 200, 200, 0.01, device=device)  # 20x20x20 cm at 1 mm (tfInterface.cpp:67)
    gvl.add_map(MapType.MT_BITVECTOR_VOXELMAP, "myObjectVoxelmap")

    tf = TfHelper()
    # the role of the ROS publisher feeding demo_tf_1:
    demo_pose = transforms.from_rpy_np(np.array([0.3, -0.7, 1.1], np.float32), [0.10, 0.09, 0.11])
    tf.publish(demo_pose, "world", "demo_tf_1")

    trafo = tf.lookup("world", "demo_tf_1")
    cloud = coordinate_system_cloud()
    moved = transforms.transform_points(trafo, cloud, device=device)
    gvl.clear_map("myObjectVoxelmap")
    gvl.insert_point_cloud_into_map(moved, "myObjectVoxelmap",
                                    BitVoxelMeaning.eBVM_OCCUPIED)

    # rebuild the rotation from both toRPY solutions (tfInterface.cpp:93-96)
    t = trafo[:3, 3]
    rpy1 = transforms.to_rpy_np(trafo, solution=1)
    rpy2 = transforms.to_rpy_np(trafo, solution=2)
    tf.publish(transforms.from_rpy_np(rpy1, t), "world", "demo_tf_rpy_1")
    tf.publish(transforms.from_rpy_np(rpy2, t), "world", "demo_tf_rpy_2")

    occupied = int(gvl.get_map("myObjectVoxelmap").occupied_mask().sum())
    for frame in ("demo_tf_rpy_1", "demo_tf_rpy_2"):
        re_derived = tf.lookup("world", frame)
        assert np.allclose(re_derived, trafo, atol=1e-5), frame
    gvl.visualize_map("myObjectVoxelmap")
    print("tf frames agree; occupied voxels:", occupied)
    return occupied


if __name__ == "__main__":
    main()
