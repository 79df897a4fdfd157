"""gpu_voxels_tpu_torch — the voxel-world collision engine in PyTorch and CUDA.

A port of `gpu_voxels_tpu` (JAX/Pallas) to PyTorch, with the Pallas kernels
rewritten by hand in CUDA C++ for Hopper (`csrc/`). Module paths mirror the
JAX package so each module has one counterpart there; the JAX package is the
reference every integer contract is held against.

Seven slices are ported. The engine's core loop on dense maps, sense ->
insert -> collide: `maps.voxelmap.ProbVoxelMap` / `BitVectorVoxelMap`,
point insertion, prob x prob counting and marking collides (CUDA kernels
K1, K2), depth-camera fusion with the exact projective carve (CUDA kernel
K3). And robots with swept volumes, robot -> swept volume -> types collide:
DH kinematic chains and the UR presets (`robot/`), meta point clouds,
swept-volume inserts with per-step meaning bits, and the windowed
swept-volume collide (CUDA kernel K4). And distance fields, camera ->
distance field: `maps.distance_map.DistanceVoxelMap` with the exact EDT
(min-plus envelope passes, CUDA kernel K5), JFA and the brute and
separable oracles, the distance queries and `converters`, fed by the
pooled depth carve (CUDA kernel K6). And trajectory scheduling, `.traj`
file -> swept volumes -> raw-plane collides -> schedule fitter:
`robot.trajectory`, `robot.fitter`, bit maps without an occupancy summary
(`occ=None`) and the bit x bit plane-fold count (CUDA kernel K7). And
voxel lists with planning on dense maps: `maps.voxellist.VoxelList` (bit,
prob and counting lists, linear and 60-bit Morton ids, `morton`), whose
swept-volume bit check runs K4, the dense maps' and the lists' disk files
(`utils.io`, byte-equal to the reference's), and `planning` (the batched
validity checker, the motion validator, RRT-Connect and the path
simplifier). And the octree tiers with BASELINE config #5:
`maps.hierarchical.HierarchicalProbMap` / `HierarchicalBitMap` (the dense
status pyramid, whose depth fusion runs K3 and K6),
`maps.paged.PagedHierarchicalMap` (the paged sparse tier up to 65536^3,
deterministic and probabilistic), their disk files, the facade's octree
map types, `planning.HierarchicalValidityChecker` and the list x octree
collides. The rest of the dense-map tier rides along: the DDA
`insert_sensor_data`, `CountingVoxelMap`, `collide_with_resolution`, the
streaming and socket depth sources and `providers.Provider`. And the IO,
visualization and facade surface: point-cloud, binvox and heightmap files
(`geometry.files`, `geometry.heightmap`), URDF robots (`robot.urdf`),
primitive arrays, the cube extraction over every tier and its exporters and
publishers (`vis`, with the device compaction of `ops.compact`), the
facade's `save_map` / `load_map` / `visualize_map`, the config, logging,
perf-monitor and tf helpers (`utils`) and the camelCase aliases (`compat`).
Around them: the `GpuVoxels` facade and interop with the JAX package. And
multi-device scaling (`parallel`): z-slab grids over a `GridMesh` of
devices (several slabs may share one card), the sharded cycles, probes and
EDTs, slab-sharded map values and the `ShardedPagedWorld`, which the
facade's `mesh` argument builds.

The package imports torch and numpy only. Entry points run on the CUDA
card unless the caller passes `device="cpu"`. Kernels build with nvcc at
first use (`utils/kernels.py`); CPU tensors take each kernel's plain torch
version.
"""
from .constants import BitVoxelMeaning, MapType

__version__ = "0.1.0"

# the top-level surface, resolved on first use (as in the reference package)
_LAZY = {
    "GpuVoxels": "gpu_voxels_tpu_torch.api",
    "ProbVoxelMap": "gpu_voxels_tpu_torch.maps.voxelmap",
    "BitVectorVoxelMap": "gpu_voxels_tpu_torch.maps.voxelmap",
    "CountingVoxelMap": "gpu_voxels_tpu_torch.maps.voxelmap",
    "DistanceVoxelMap": "gpu_voxels_tpu_torch.maps.distance_map",
    "VoxelList": "gpu_voxels_tpu_torch.maps.voxellist",
    "HierarchicalProbMap": "gpu_voxels_tpu_torch.maps.hierarchical",
    "HierarchicalBitMap": "gpu_voxels_tpu_torch.maps.hierarchical",
    "PagedHierarchicalMap": "gpu_voxels_tpu_torch.maps.paged",
    "MetaPointCloud": "gpu_voxels_tpu_torch.geometry.pointcloud",
    "PointCloud": "gpu_voxels_tpu_torch.geometry.pointcloud",
    "Sensor": "gpu_voxels_tpu_torch.sensors",
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = ["BitVoxelMeaning", "MapType", "__version__", *sorted(_LAZY)]
