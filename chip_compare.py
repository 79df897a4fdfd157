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
distance field frame and the 256^3 fusion frame, and K4 at the UR10 sweep
against its environment (256^3, window 5: with a mark and count only), on
dense random 256^3 maps, on the swept list's payload against the
obstacle list's, and the whole list bit check, the script checks that every
library gives the same result, then times them with CUDA events in the
order other, this, this, other and prints the mean of each pair (for K6 and
K4 also the device-busy time from torch.profiler, `chip_smoke.device_ms`).
K4's rows call each tree's own package (imported under a name of its own,
`package_of`): its wrapper, and for the list bit check its
`VoxelList.collide_with_bitcheck`, so each carries its own host work; a
tree whose K4 takes no summaries and no list mask is called without them,
with the mask applied to the partner payload first, as its callers did.
Needs one CUDA card and nvcc, like chip_smoke.py.
"""
from __future__ import annotations

import importlib
import importlib.util
import inspect
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from gpu_voxels_tpu_torch.constants import SV_START
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.ops import edt_cuda, edt_envelope, raycast_cuda
from gpu_voxels_tpu_torch.robot.presets import ur_robot
from gpu_voxels_tpu_torch.sensors import SyntheticDepthSource
from gpu_voxels_tpu_torch.utils import kernels


def package_of(tree: str):
    """Another tree's gpu_voxels_tpu_torch, imported under a name of its own
    (the package imports itself by relative imports only)."""
    init = Path(tree) / "gpu_voxels_tpu_torch" / "__init__.py"
    name = f"gpu_voxels_tpu_torch_{abs(hash(tree))}"
    spec = importlib.util.spec_from_file_location(name, init, submodule_search_locations=[str(init.parent)])
    sys.modules[name] = module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sub(package, name: str):
    """A module of a package imported by package_of (or of this tree's)."""
    return importlib.import_module(f"{package.__name__}.{name}")


def use(lib) -> None:
    """Bind this tree's wrappers to `lib`."""
    kernels._lib = lib


def k4_of(package):
    """K4 through a tree's own wrapper: with the summaries and the list mask
    where it takes them, otherwise without the summaries and with the mask
    applied to the partner payload first, as that tree's callers did."""
    wrapper = sub(package, "ops.collide_cuda").collide_types_bit_bit
    if "occ_a" in inspect.signature(wrapper).parameters:
        return lambda a, b, margin, mark, occ_a=None, occ_b=None, b_valid=None: wrapper(
            a, b, margin, mark, occ_a, occ_b, b_valid=b_valid)

    def earlier(a, b, margin, mark, occ_a=None, occ_b=None, b_valid=None):
        if b_valid is not None:
            b = torch.where(b_valid[None, :], b, 0)
        return wrapper(a, b, margin, mark)
    return earlier


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
    this = sys.modules["gpu_voxels_tpu_torch"]
    packages = {"this": this, **{tree: package_of(tree) for tree in sys.argv[1:]}}
    libs = {key: sub(package, "utils.kernels").library() for key, package in packages.items()}

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

    chain = ur_robot("ur10", cs.SV_SIDE, device=dev)
    scene = cs.sweep_scene(dev, chain)
    sa, sb, oa, ob = scene["sweep"].data, scene["env"].data, scene["sweep"].occ, scene["env"].occ
    g = torch.Generator(device=dev).manual_seed(99)
    n = sa.shape[1]
    da, db = cs.dense_bits(dev, n, g), cs.dense_bits(dev, n, g)
    sweep_pts = scene["placed"].transformed_clouds_for(scene["cfgs"]).points
    lists = {}  # each tree's swept list and path 5's obstacle list, and its match of them
    for key, package in packages.items():
        new_list = sub(package, "maps.voxellist").bit_vector_voxel_list
        swept = new_list(cs.SV_DIMS, cs.SV_SIDE, device=dev).insert_point_cloud_with_meanings(
            sweep_pts.reshape(-1, 3), cs.sweep_meanings(sweep_pts))
        blocks = new_list(cs.SV_DIMS, cs.SV_SIDE, device=dev)
        for k in cs.OBSTACLE_STEPS:
            blocks = blocks.insert_point_cloud(sweep_pts[k, chain.clouds.offsets[-3]::5], SV_START + k)
        lists[key] = (swept, blocks, *swept.find_matching(blocks))
    k4 = {key: k4_of(package) for key, package in packages.items()}
    sv = lists["this"][0]

    def each(fn):
        """One call per tree: fn(that tree's K4, that tree's lists)."""
        return {key: (lambda key=key: fn(k4[key], lists[key])) for key in packages}

    workloads += [
        ("K4 UR10 sweep x environment, window 5, mark", 10, each(lambda k, _: k(sa, sb, 5, True, oa, ob))),
        ("K4 UR10 sweep x environment, window 5, count only", 20, each(lambda k, _: k(sa, sb, 5, False, oa, ob))),
        ("K4 dense random 256^3, window 5, mark", 10, each(lambda k, _: k(da, db, 5, True))),
        ("K4 dense random 256^3, window 5, count only", 10, each(lambda k, _: k(da, db, 5, False))),
        (f"K4 list payload (C = {sv.capacity}), window 5, with the mask", 20,
         each(lambda k, ls: k(ls[0].payload, ls[3], 5, False, b_valid=ls[2]))),
        ("the list bit check, window 5: VoxelList.collide_with_bitcheck", 20,
         each(lambda _, ls: ls[0].collide_with_bitcheck(ls[1], 5))),
    ]

    for name, iters, fn in workloads:
        calls = fn if isinstance(fn, dict) else {key: fn for key in libs}  # each tree's own, or this tree's
        results = {}
        for key, lib in libs.items():
            use(lib)
            results[key] = flat(calls[key]())
        for key in libs:
            same = all(torch.equal(x, y) for x, y in zip(results[key], results["this"]))
            assert same, f"{name}: the kernels of {key} and of this tree disagree"
        del results
        others = [key for key in libs if key != "this"]
        # K6's pool and K4's gated calls are microseconds of device work
        # under the wrappers' host time, so they also report the profiler's
        # device time
        clocks = [("", cs.time_ms)] + ([("device ", cs.device_ms)] if name.startswith(("K6", "K4", "the list")) else [])
        for label, clock in clocks:
            times = {key: [] for key in libs}
            for key in others + ["this", "this"] + others[::-1]:
                use(libs[key])
                times[key].append(clock(calls[key], iters))
            use(libs["this"])
            cells = "; ".join(f"{key} {label}{sum(ts) / len(ts):.4f} ms ({', '.join(f'{t:.4f}' for t in ts)})"
                              for key, ts in times.items())
            print(f"{name}: {cells}; results equal  [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
