"""Port of examples/ShiftVsTransform.cpp: compare shifting a map by a voxel
offset at collide time vs transforming the cloud before insertion."""
from gpu_voxels_tpu_torch.geometry import generation, transforms
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.utils import resolve_device

DIMS = (64, 64, 64)


def main(device=None):
    device = resolve_device(device)
    cloud = generation.create_box_of_points((10.1,) * 3, (14.1,) * 3, 0.5)
    base = ProbVoxelMap.create(DIMS, device=device).insert_point_cloud(cloud)

    # variant A: collide with a voxel offset
    other = ProbVoxelMap.create(DIMS, device=device).insert_point_cloud(cloud)
    with_offset = int(base.collide_with(other, 0.1, offset=(3, 0, 0)))

    # variant B: transform the cloud by the metric equivalent, then insert
    m = transforms.from_translation_np([-3.0, 0.0, 0.0])
    shifted_cloud = transforms.transform_points(m, cloud, device=device)
    other_t = ProbVoxelMap.create(DIMS, device=device).insert_point_cloud(shifted_cloud)
    with_transform = int(base.collide_with(other_t, 0.1))

    print("offset collide   :", with_offset)
    print("transform collide:", with_transform)
    assert with_offset == with_transform
    return with_offset


if __name__ == "__main__":
    main()
