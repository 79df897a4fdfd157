#!/usr/bin/env python3
"""Two or more builds of the port's CUDA kernels on one NVIDIA GPU, in turns.

    python3 chip_compare.py OTHER_TREE [OTHER_TREE ...]

Each OTHER_TREE is a directory that holds another version of
gpu_voxels_tpu_torch/csrc and gpu_voxels_tpu_torch/utils/kernels.py (for
example a `git archive` of the parent commit unpacked into the git-ignored
gpu_voxels_tpu_torch/_build/). Its kernels are built from its own sources
into its own _build/ and bound through the C interface, which must be this
tree's (the wrappers and everything above them are this tree's). For K5 per
pass at 512^3 (BASELINE #4's obstacles) and 256^3 (the fused camera map), K3
at 256^3, K6 at 256^3 and P = 8 (its pool, its carve alone on a prebuilt
table, and its whole wrapper), BASELINE #4's exact EDT, the 256^3 camera ->
distance field frame and the 256^3 fusion frame, the script checks that
every library gives the same result, then times them with CUDA events in the
order other, this, this, other and prints the mean of each pair (for K6
also the device-busy time from torch.profiler, `chip_smoke.device_ms`).
Needs one CUDA card and nvcc, like chip_smoke.py.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.ops import edt_cuda, edt_envelope, raycast_cuda
from gpu_voxels_tpu_torch.sensors import SyntheticDepthSource
from gpu_voxels_tpu_torch.utils import kernels


def library_of(tree: str):
    """The kernel library of another tree, built by that tree's own utils/kernels.py."""
    path = Path(tree) / "gpu_voxels_tpu_torch" / "utils" / "kernels.py"
    spec = importlib.util.spec_from_file_location(f"kernels_{abs(hash(tree))}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.library()


def use(lib) -> None:
    """Bind this tree's wrappers to `lib`."""
    kernels._lib = lib


def flat(result) -> list:
    """The tensors of a workload's result (a tensor, a tuple of them, or a map)."""
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, tuple):
        return list(result)
    return [result.data]


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    dev, smi = cs.card()
    libs = {"this": kernels.library()}
    for tree in sys.argv[1:]:
        libs[tree] = library_of(tree)

    sensor = cs.kinect_sensor()
    src = SyntheticDepthSource(sensor, seed=0)
    frames = [torch.as_tensor(src.get_frame(), device=dev) for _ in range(5)]
    fresh = ProbVoxelMap.create(cs.FUSION_DIMS, cs.FUSION_SIDE, device=dev)
    env = fresh
    for frame in frames:
        env = env.insert_depth_image(frame, sensor, carve_pool=cs.POOL)
    merged = DistanceVoxelMap.create(cs.FUSION_DIMS, cs.FUSION_SIDE, device=dev).merge_occupied(env)
    obstacles = DistanceVoxelMap.create(cs.EDT_DIMS, 1.0, device=dev).insert_point_cloud(
        (cs.edt_obstacles() + 0.5).astype(np.float32))
    depth = torch.as_tensor(cs.bench_frame(), device=dev)
    pose = torch.as_tensor(cs.carve_poses()["bench"], device=dev)
    carve_args = (depth, pose, *cs.INTR, cs.FUSION_SIDE, cs.FUSION_DIMS)
    pooled = raycast_cuda.min_pool_depth_plain(depth, cs.POOL)  # the carve alone's table

    def camera_frame():
        pooled = fresh.insert_depth_image(frames[0], sensor, carve_pool=cs.POOL)
        return DistanceVoxelMap.create(cs.FUSION_DIMS, cs.FUSION_SIDE, device=dev).merge_occupied(pooled).jump_flood()

    workloads = []  # (name, iterations, function)
    for label, dmap, dims in (("512^3 BASELINE #4", obstacles, cs.EDT_DIMS), ("256^3 camera field", merged, cs.FUSION_DIMS)):
        g1, pay1 = edt_envelope.flood_z(dmap.data, dims)
        d2, pay2 = edt_cuda.envelope_pass(g1, pay1, 1)
        workloads.append((f"K5 Y pass, {label}", 10, lambda g1=g1, pay1=pay1: edt_cuda.envelope_pass(g1, pay1, 1)))
        workloads.append((f"K5 X pass, {label}", 10, lambda d2=d2, pay2=pay2: edt_cuda.envelope_pass(d2, pay2, 2)))
    workloads += [
        ("K3 exact carve, 256^3", 50, lambda: raycast_cuda.projective_free_space_exact(*carve_args)),
        (f"K6 pool P={cs.POOL}, 640x480", 50, lambda: raycast_cuda.min_pool_depth(depth, cs.POOL)),
        (f"K6 carve alone P={cs.POOL}, 256^3", 50,
         lambda: raycast_cuda.carve_against_pooled(pooled, cs.POOL, depth.shape, *carve_args[1:])),
        (f"K6 pooled carve P={cs.POOL}, 256^3 (pool and carve)", 50,
         lambda: raycast_cuda.projective_free_space_pooled(*carve_args, pool=cs.POOL)),
        ("BASELINE #4 exact EDT at 512^3", 5, obstacles.parallel_banding),
        ("256^3 camera -> distance field frame", 10, camera_frame),
        ("256^3 fusion of one frame (exact carve)", 20, lambda: fresh.insert_depth_image(frames[0], sensor)),
    ]

    for name, iters, fn in workloads:
        results = {}
        for key, lib in libs.items():
            use(lib)
            results[key] = flat(fn())
        for key in libs:
            same = all(torch.equal(x, y) for x, y in zip(results[key], results["this"]))
            assert same, f"{name}: the kernels of {key} and of this tree disagree"
        del results
        others = [key for key in libs if key != "this"]
        # K6's pool is microseconds of device work under the wrappers' host
        # time, so its workloads also report the profiler's device time
        clocks = [("", cs.time_ms)] + ([("device ", cs.device_ms)] if name.startswith("K6") else [])
        for label, clock in clocks:
            times = {key: [] for key in libs}
            for key in others + ["this", "this"] + others[::-1]:
                use(libs[key])
                times[key].append(clock(fn, iters))
            use(libs["this"])
            cells = "; ".join(f"{key} {label}{sum(ts) / len(ts):.4f} ms ({', '.join(f'{t:.4f}' for t in ts)})"
                              for key, ts in times.items())
            print(f"{name}: {cells}; results equal  [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
