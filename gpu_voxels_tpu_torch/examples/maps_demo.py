"""Port of examples/Maps.cpp: create every map type, insert the same cloud,
report occupancy/collisions per representation."""
from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.geometry import generation


def main(device=None):
    gvl = GpuVoxels.get_instance()
    gvl.initialize(96, 96, 96, 0.1, device=device)
    names = []
    for mt in (
        MapType.MT_PROBAB_VOXELMAP,
        MapType.MT_BITVECTOR_VOXELMAP,
        MapType.MT_BITVECTOR_VOXELLIST,
        MapType.MT_BITVECTOR_MORTON_VOXELLIST,
        MapType.MT_PROBAB_VOXELLIST,
        MapType.MT_COUNTING_VOXELLIST,
        MapType.MT_PROBAB_OCTREE,
        MapType.MT_BITVECTOR_OCTREE,
        MapType.MT_DISTANCE_VOXELMAP,
    ):
        name = mt.name.lower()
        gvl.add_map(mt, name)
        names.append(name)

    cloud = generation.create_sphere_of_points((4.8, 4.8, 4.8), 1.0, 0.08)
    for name in names:
        gvl.insert_point_cloud_into_map(cloud, name, BitVoxelMeaning.eBVM_OCCUPIED)

    probe = gvl.get_map("mt_bitvector_voxellist")
    dense = gvl.get_map("mt_bitvector_voxelmap")
    print("list count:", int(probe.count))
    print("list x dense:", int(probe.collide_with_dense(dense)))
    print("hier x dense:", int(gvl.get_map("mt_probab_octree").collide_with(dense)))
    d = gvl.get_map("mt_distance_voxelmap").jump_flood()
    print("EDT distance from corner:", float(d.get_obstacle_distance(0, 0, 0)))
    return int(probe.count)


if __name__ == "__main__":
    main()
