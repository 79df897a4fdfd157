"""Multi-device scaling: the voxel grid as z-slabs over a grid of devices.

Counterpart of gpu_voxels_tpu/parallel/ (the same 12 names): the builders of
sharded cycles and probes (sharded.py), the sharded exact EDT
(sharded_edt_exact.py) and JFA (sharded_edt.py), slab-sharded map values
(shard_value.py) and the z-slab paged octree (paged_world.py).
"""
from .paged_world import ShardedPagedWorld
from .shard_value import assert_sharded, reshard_like, shard_map_value
from .sharded import (
    GridMesh,
    build_sharded_bit_cycle,
    build_sharded_cycle,
    build_sharded_hier_probe,
    build_sharded_list_collide,
    build_sharded_paged_probe,
    build_sharded_sensor_cycle,
    make_grid_mesh,
    sharded_collide_count,
)

__all__ = [
    "ShardedPagedWorld",
    "assert_sharded",
    "build_sharded_bit_cycle",
    "build_sharded_cycle",
    "build_sharded_hier_probe",
    "build_sharded_list_collide",
    "build_sharded_paged_probe",
    "build_sharded_sensor_cycle",
    "make_grid_mesh",
    "reshard_like",
    "shard_map_value",
    "sharded_collide_count",
]
