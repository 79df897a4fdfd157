#!/usr/bin/env python3
"""Where the time goes on one NVIDIA GPU: the port's end-to-end paths under
torch.profiler.

    python3 chip_profile.py

For each path of chip_smoke.py's phase 3 (the 512^3 insert -> collide cycle,
the 256^3 fusion of one 640x480 frame, the UR10 64-step swept volume with
its types collide, BASELINE #4's exact EDT at 512^3, the 256^3 camera ->
distance field frame, the schedule fitter's ordering search and one
deconflict_slot on the two-UR10 scene at 256^3, one DDA
insert_sensor_data frame, a Kinect frame and the 64-step UR10 sweep into
voxel lists, the lists' bit check (K4), one check_motion of the planning
scene, which reads its counts on the host, BASELINE #5's batch of 315 states
against the 1024^3 dense pyramid and one 640x480 frame fused into a 512^3
HierarchicalBitMap), and for K6 alone at 256^3 and P = 8 (its pool
kernel, then its carve kernel), it prints the time per iteration from CUDA
events (unprofiled), the device-busy time per iteration (the sum of the
device rows of `key_averages()`: kernels, memsets and copies), the device's
idle share, and the device rows that take the most time. Last, for the carve
and envelope kernels (K3, K6 and its pool, K5), what the compiler made of
each: registers per thread (ptxas) and the static count of SASS operations
(cuobjdump, where the toolkit has it). Needs one CUDA card and nvcc, like
chip_smoke.py.
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

import torch

import chip_smoke as cs
from gpu_voxels_tpu_torch.geometry import generation
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.hierarchical import HierarchicalBitMap
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import raycast_cuda
from gpu_voxels_tpu_torch.planning import HierarchicalValidityChecker
from gpu_voxels_tpu_torch.robot.fitter import deconflict_slot, fit_orderings
from gpu_voxels_tpu_torch.robot.swept_volume import insert_swept_volume_batched
from gpu_voxels_tpu_torch.sensors import SyntheticDepthSource
from gpu_voxels_tpu_torch.utils import kernels, to_device

ITERS = 20
TOP = 8


def breakdown(name: str, fn, smi: str, iters: int = ITERS) -> None:
    wall_ms = cs.time_ms(fn, iters)
    rows = sorted(cs.device_rows(fn, iters), key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / iters
    print(f"{name}: {wall_ms:.4f} ms per iteration (CUDA events), device busy {busy_ms:.4f} ms, "
          f"idle share {1.0 - busy_ms / wall_ms:.3f}  [{smi}]", flush=True)
    for e in rows[:TOP]:
        print(f"    {e.self_device_time_total / 1e3 / iters:9.4f} ms  x{e.count / iters:<5.2f} {e.key[:90]}", flush=True)


def static_counts() -> None:
    """Per kernel of csrc/{carve_exact,carve_pooled,edt_envelope}.cu: registers
    per thread and SASS operations in the whole kernel (slow paths of IEEE
    divisions and ragged tails included: a static count, not what a thread
    executes)."""
    nvcc = kernels._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("carve_exact", "carve_pooled", "edt_envelope"):
            obj = os.path.join(tmp, f"{name}.o")
            built = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj,
                                    str(kernels.CSRC_DIR / f"{name}.cu")], capture_output=True, text=True, check=True)
            registers = dict(re.findall(r"entry function '(\S+)'.*?Used (\d+) registers", built.stderr, re.S))
            sass_ops = {}
            if os.path.exists(cuobjdump):
                sass = subprocess.run([cuobjdump, "-sass", obj], capture_output=True, text=True, check=True).stdout
                for body in sass.split("Function : ")[1:]:
                    sass_ops[body.split()[0]] = len(re.findall(r"^\s+/\*[0-9a-f]{4}\*/", body, re.M))
            for fn, regs in registers.items():
                kernel, size = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", fn).groups()
                print(f"{name}.cu {kernel}{f'<{size}>' if size else ''}: {regs} registers, "
                      f"{sass_ops.get(fn, 'not counted (no cuobjdump)')} SASS operations", flush=True)


def main() -> int:
    dev, smi = cs.card()
    kernels.library()

    pts = to_device(generation.create_equidistant_points_in_box(307200, (511, 511, 511), 1.0), torch.float32, dev)

    def cycle():
        m1 = ProbVoxelMap.create(cs.CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts)
        m2 = ProbVoxelMap.create(cs.CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 1.0)
        return m1.collide_with(m2, 0.5)

    sensor = cs.kinect_sensor()
    frame = torch.as_tensor(SyntheticDepthSource(sensor, seed=0).get_frame(), device=dev)
    fresh = ProbVoxelMap.create(cs.FUSION_DIMS, cs.FUSION_SIDE, device=dev)

    robot = cs.robot_path(dev, ProbVoxelMap.create(cs.SV_DIMS, cs.SV_SIDE, device=dev))
    placed, cfgs, env = robot["placed"], robot["cfgs"], robot["env"]

    def trajectory():
        sweep = insert_swept_volume_batched(BitVectorVoxelMap.create(cs.SV_DIMS, cs.SV_SIDE, device=dev), placed, cfgs)
        return sweep.collide_with_types(env, 1.0, 5)

    breakdown("512^3 insert->insert->collide cycle", cycle, smi)
    breakdown("256^3 fusion of one 640x480 frame", lambda: fresh.insert_depth_image(frame, sensor), smi)
    breakdown("UR10 64-step swept volume + types collide at 256^3", trajectory, smi)

    fit = cs.fitter_path(dev, robot["sweep"], robot["env"])
    centers = [fit["robots_raw"][r][1][0][1] for r in (0, 1)]
    breakdown("fit_orderings, 2 UR10s x 2 trajectories at 256^3, raw planes (K7)",
              lambda: fit_orderings(fit["robots_raw"], all_solutions=True), smi)
    breakdown("fit_orderings, the same on occupancy summaries",
              lambda: fit_orderings(fit["robots"], all_solutions=True), smi)
    breakdown("deconflict_slot of the two centre reaches (margin 2, stride 4)",
              lambda: deconflict_slot(centers, margin=cs.FIT_WINDOW, stride=4), smi, iters=5)
    rays = sensor.process_depth_image(frame, device=dev)
    breakdown("256^3 DDA insert_sensor_data of one 640x480 frame (307,200 rays)",
              lambda: fresh.insert_sensor_data(rays, sensor_origin=sensor.position), smi, iters=3)
    sweep_pts = placed.transformed_clouds_for(cfgs).points
    flat, meanings = sweep_pts.reshape(-1, 3), cs.sweep_meanings(sweep_pts)
    breakdown("a Kinect frame (307,200 points) into a 256^3 bit list",
              lambda: cs.bit_vector_voxel_list(cs.FUSION_DIMS, cs.FUSION_SIDE, device=dev).insert_point_cloud(rays), smi)
    sweep_list = cs.bit_vector_voxel_list(cs.SV_DIMS, cs.SV_SIDE, device=dev)
    breakdown("the 64-step UR10 sweep (243,200 points) into a 256^3 bit list",
              lambda: sweep_list.insert_point_cloud_with_meanings(flat, meanings), smi)
    sweep_list = sweep_list.insert_point_cloud_with_meanings(flat, meanings)
    obstacles = cs.bit_vector_voxel_list(cs.SV_DIMS, cs.SV_SIDE, device=dev).insert_point_cloud(
        sweep_pts[cs.OBSTACLE_STEPS[0]], cs.SV_START + cs.OBSTACLE_STEPS[0])
    breakdown("collide_with_bitcheck of the sweep list, margin 5 (K4)",
              lambda: sweep_list.collide_with_bitcheck(obstacles, 5), smi)
    _, _, _, validator = cs.planning_scene(dev)
    breakdown("one check_motion of the planning scene (start -> goal, 34 UR10 states, one host read)",
              lambda: validator.check_motion(cs.PLAN_START, cs.PLAN_GOAL), smi)
    del robot, placed, cfgs, env, fit, centers, rays, sweep_pts, flat, meanings, sweep_list, obstacles, validator

    obstacles = DistanceVoxelMap.create(cs.EDT_DIMS, 1.0, device=dev).insert_point_cloud(
        (cs.edt_obstacles() + 0.5).astype("float32"))

    def camera_frame():
        pooled = fresh.insert_depth_image(frame, sensor, carve_pool=cs.POOL)
        return DistanceVoxelMap.create(cs.FUSION_DIMS, cs.FUSION_SIDE, device=dev).merge_occupied(pooled).jump_flood()

    breakdown("BASELINE #4 exact EDT at 512^3 (20,000 obstacles)", obstacles.parallel_banding, smi)
    breakdown("256^3 camera -> distance field frame (pooled carve, merge, EDT)", camera_frame, smi)
    depth = torch.as_tensor(cs.bench_frame(), device=dev)
    pose = torch.as_tensor(cs.carve_poses()["bench"], device=dev)
    breakdown(f"K6 at 256^3, P = {cs.POOL}: the pool kernel, then the carve kernel",
              lambda: raycast_cuda.projective_free_space_pooled(depth, pose, *cs.INTR, cs.FUSION_SIDE, cs.FUSION_DIMS,
                                                                pool=cs.POOL), smi, iters=50)
    del obstacles

    env_pts, robot_pts, states = cs.config5_scene()
    env_h = HierarchicalBitMap.create(cs.C5_DIMS, 1.0, device=dev).insert_point_cloud(env_pts)
    checker = HierarchicalValidityChecker(env_h, cs.Translated(robot_pts, dev))
    states = to_device(states, torch.float32, dev)
    breakdown(f"BASELINE #5 batch: {len(states)} states x {cs.C5_ROBOT_POINTS} points against the {cs.C5_DIMS[0]}^3 "
              "dense pyramid (device counts, no host read)", lambda: checker.colliding_voxels_device(states), smi)
    del env_h, checker
    hier = HierarchicalBitMap.create(cs.HIER_DIMS, cs.HIER_SIDE, device=dev)
    posed = cs.PosedSensor(cs.carve_poses()["bench"])
    breakdown(f"{cs.HIER_DIMS[0]}^3 fusion of one 640x480 frame into a HierarchicalBitMap (exact carve, K3)",
              lambda: hier.insert_depth_image(depth, posed), smi)
    static_counts()
    return 0


if __name__ == "__main__":
    sys.exit(main())
