#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gpu_voxels_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc); without them it exits
non-zero and prints no result. Phases, each an assert or an exception:

0. the card: name and power limit (nvidia-smi);
1. build: nvcc compiles gpu_voxels_tpu_torch/csrc/*.cu (utils/kernels.py);
2. each CUDA kernel against its plain torch version, on the card, at full
   size, exact equality: K1/K2 (prob x prob count / count-and-mark) on two
   random int8 512^3 maps over thresholds x offsets, incl. misaligned views;
   K3 (exact projective carve) at 256^3 on a 640x480 frame under 3 poses;
3. the main path through the public entry points, on the card: the facade
   linkage scene (count == 8000), Kinect fusion (5 frames of 640x480 into
   256^3), a transformed sphere robot collided with the fused and a box
   environment (counts > 0 and equal to the plain route), and the 512^3
   insert -> collide cycle with a marking collide, with torch's sync debug
   mode set to raise (the path never waits for the device); every kernel's
   launch count must have risen during this phase;
4. times with CUDA events (printed, never asserted): each kernel beside its
   plain version, the 512^3 cycle rate and the 256^3 fusion rate.

Output: progress lines, the card's `name, power.limit` line, one JSON line
{"kernels": [...]}, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from gpu_voxels_tpu_torch.api import GpuVoxels
from gpu_voxels_tpu_torch.constants import BitVoxelMeaning, MapType
from gpu_voxels_tpu_torch.geometry import generation, transforms
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.ops import collide_cuda, raycast_cuda
from gpu_voxels_tpu_torch.sensors import Sensor, SyntheticDepthSource
from gpu_voxels_tpu_torch.utils import kernels, to_device

INTR = (525.0, 525.0, 320.0, 240.0)  # Kinect 640x480 (BASELINE config #2)
FUSION_DIMS, FUSION_SIDE = (256, 256, 256), 0.02
CYCLE_DIMS = (512, 512, 512)
THRESHOLDS = (-120, 0, 100)
OFFSETS = ((0, 0, 0), (-1, 0, -1), (3, -2, 1))

KERNELS = [
    # (wrapper name, module, source, TPU kernel it replaces)
    ("count_prob_prob", collide_cuda, "gpu_voxels_tpu_torch/csrc/collide_prob.cu",
     "gpu_voxels_tpu/ops/collide_pallas.py:52"),
    ("count_and_mark_prob", collide_cuda, "gpu_voxels_tpu_torch/csrc/collide_prob.cu",
     "gpu_voxels_tpu/ops/collide_pallas.py:394"),
    ("projective_free_space_exact", raycast_cuda, "gpu_voxels_tpu_torch/csrc/carve_exact.cu",
     "gpu_voxels_tpu/ops/raycast_pallas.py:189"),
]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 0 ------------------------------------------------------------------
def card() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    smi = res.stdout.strip().splitlines()[0]
    print(smi, flush=True)
    # coordinates feed floor(): full f32 matmuls only (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0), smi


# -- phase 2 ------------------------------------------------------------------
def bench_frame(seed: int = 0) -> np.ndarray:
    """640x480 depth with step edges, an invalid patch and noise (bench.py:288-293)."""
    rng = np.random.default_rng(seed)
    depth = np.full((480, 640), 4.0, np.float32)
    depth[100:300, 200:450] = 2.5
    depth[350:460, 50:250] = 1.8
    depth += rng.normal(0, 0.003, depth.shape).astype(np.float32)
    depth[20:60, 560:620] = 0.0  # invalid patch
    return depth


def carve_poses() -> dict:
    bench = np.eye(4, dtype=np.float32)
    bench[:3, 3] = [2.56, 2.56, 0.1]
    return {
        "bench": bench,
        "tilted": transforms.from_rpy_np([0.3, -0.2, 0.1], [2.0, 2.8, 0.3]),
        # at the grid's centre: half the grid lies behind the camera
        "inside": transforms.from_rpy_np([0.05, 0.1, 0.0], [2.56, 2.56, 2.56]),
    }


def check_kernels(dev: torch.device) -> dict:
    """Every kernel against its plain version at the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(1234)
    n = CYCLE_DIMS[0] * CYCLE_DIMS[1] * CYCLE_DIMS[2]
    a = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    err = {name: 0 for name, *_ in KERNELS}
    cases = [(a, b, t, off, CYCLE_DIMS) for t in THRESHOLDS for off in OFFSETS]
    # views whose byte addresses share a misalignment: the vector path's head and tail
    cases.append((a[7:n - 5], b[7:n - 5], 0, (0, 0, 0), None))
    for x, y, t, off, dims in cases:
        got = collide_cuda.count_prob_prob(x, y, t, 0, dims, off)
        ref = collide_cuda.count_prob_prob_plain(x, y, t, 0, dims, off)
        err["count_prob_prob"] = max(err["count_prob_prob"], abs(int(got) - int(ref)))
        cnt, marked = collide_cuda.count_and_mark_prob(x, y, t, 0, dims, off)
        ref_c, ref_m = collide_cuda.count_and_mark_prob_plain(x, y, t, 0, dims, off)
        map_err = int((marked.to(torch.int16) - ref_m.to(torch.int16)).abs().max())
        err["count_and_mark_prob"] = max(err["count_and_mark_prob"], abs(int(cnt) - int(ref_c)), map_err)
        assert int(got) == int(ref) and int(cnt) == int(ref_c) and torch.equal(marked, ref_m), (t, off)
        log(f"  K1/K2 t1={t:4d} offset={off} view={dims is None}: count {int(got)} == plain, marked map equal")
    del a, b, marked, ref_m

    depth = torch.as_tensor(bench_frame(), device=dev)
    for name, pose in carve_poses().items():
        p = torch.as_tensor(pose, device=dev)
        got = raycast_cuda.projective_free_space_exact(depth, p, *INTR, FUSION_SIDE, FUSION_DIMS)
        ref = raycast_cuda.projective_free_space_plain(depth, p, *INTR, FUSION_SIDE, FUSION_DIMS)
        diff = int((got != ref).sum())
        err["projective_free_space_exact"] = max(err["projective_free_space_exact"], int(diff > 0))
        assert diff == 0 and int(got.sum()) > 0, (name, diff)
        log(f"  K3 pose={name}: {int(got.sum())} free voxels, mask equal to plain bit for bit")
    torch.cuda.synchronize()
    return err


# -- phase 3 ------------------------------------------------------------------
@contextlib.contextmanager
def plain_route():
    """Route the map methods through the plain torch versions (the reference
    run of the main path on the same card)."""
    saved = (collide_cuda.count_prob_prob, collide_cuda.count_and_mark_prob,
             raycast_cuda.projective_free_space_exact)
    collide_cuda.count_prob_prob = collide_cuda.count_prob_prob_plain
    collide_cuda.count_and_mark_prob = collide_cuda.count_and_mark_prob_plain
    raycast_cuda.projective_free_space_exact = raycast_cuda.projective_free_space_plain
    try:
        yield
    finally:
        (collide_cuda.count_prob_prob, collide_cuda.count_and_mark_prob,
         raycast_cuda.projective_free_space_exact) = saved


def kinect_sensor() -> Sensor:
    return Sensor(position=np.asarray([2.56, 2.56, 0.1], np.float32), data_width=640, data_height=480,
                  fx=INTR[0], fy=INTR[1], cx=INTR[2], cy=INTR[3])


def main_path(dev: torch.device) -> dict:
    """The slice's main path through the public entry points."""
    out = {}
    # (a) the facade linkage scene (BASELINE config #1)
    GpuVoxels._instance = None
    gvl = GpuVoxels.get_instance()
    gvl.initialize(128, 128, 128, 0.01, device=dev)
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bA")
    gvl.add_map(MapType.MT_PROBAB_VOXELMAP, "bB")
    gvl.insert_box_into_map((0.4, 0.4, 0.4), (0.8, 0.8, 0.8), "bA", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    gvl.insert_box_into_map((0.2, 0.2, 0.2), (0.6, 0.6, 0.6), "bB", BitVoxelMeaning.eBVM_OCCUPIED, 1)
    out["linkage"] = gvl.get_map("bA").collide_with(gvl.get_map("bB"), 0.1)

    # (b) Kinect fusion: 5 synthetic 640x480 frames into 256^3 (config #2)
    sensor = kinect_sensor()
    src = SyntheticDepthSource(sensor, seed=0)
    env = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    out["frames"] = [src.get_frame() for _ in range(5)]
    for frame in out["frames"]:
        env = env.insert_depth_image(frame, sensor)
    out["env"] = env

    # (c) a sphere robot moved by an RPY pose, against the fused and a box environment
    sphere = to_device(generation.create_sphere_of_points((0.0, 0.0, 0.0), 0.35, FUSION_SIDE), torch.float32, dev)
    pose = transforms.from_rpy([0.1, -0.2, 0.4], [2.56, 2.56, 4.45], device=dev)
    robot_pts = transforms.transform_points(pose, sphere)
    robot_bit = BitVectorVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(robot_pts)
    robot_prob = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(robot_pts)
    box = generation.create_box_of_points((2.3, 2.3, 4.2), (2.8, 2.8, 4.6), FUSION_SIDE)
    box_env = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev).insert_point_cloud(box)
    out["robot"] = robot_pts
    out["robot_counts"] = [
        robot_bit.collide_with(env, 0.55),  # bit x prob (occupancy summary)
        env.collide_with(robot_prob, 0.55),  # prob x prob: K1
        box_env.collide_with(robot_prob, 0.55),  # K1
        box_env.collide_with(robot_bit, 0.55),  # prob x bit
    ]

    # (d) the 512^3 insert -> collide cycle with two 307,200-point clouds
    pts = to_device(generation.create_equidistant_points_in_box(307200, (511, 511, 511), 1.0), torch.float32, dev)
    m1 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts)
    m2 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 1.0)
    m3 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 2.0)
    out["cycle_pts"] = pts
    out["cycle"] = m1.collide_with(m2, 0.5)
    out["cycle_overlap"] = m1.collide_with(m3, 0.5, (2, 0, 0))
    out["mark"] = m1.collide_with_marking(m3, 0.5)
    return out


def drive_main_path(dev: torch.device) -> dict:
    for name, module, *_ in KERNELS:
        module.launches[name] = 0
    # counts stay device tensors: the main path must never make the host
    # wait for the device (a synchronising call raises in this mode)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = main_path(dev)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {name: module.launches[name] for name, module, *_ in KERNELS}
    log(f"  launches on the main path: {launches}")
    for name, count in launches.items():
        assert count > 0, f"kernel {name} was not launched on the main path"

    assert int(out["linkage"]) == 8000, int(out["linkage"])
    log(f"  (a) facade linkage scene: count {int(out['linkage'])} == 8000")
    data = out["env"].data
    assert data.dtype == torch.int8 and data.shape == (FUSION_DIMS[0] * FUSION_DIMS[1] * FUSION_DIMS[2],)
    occupied, free = int((data > 0).sum()), int(((data < 0) & (data > -128)).sum())
    assert occupied > 0 and free > 0
    log(f"  (b) fusion 5 x 640x480 -> 256^3: {occupied} occupied, {free} free voxels")
    counts = [int(c) for c in out["robot_counts"]]
    assert min(counts) > 0, counts
    cnt, marked = out["mark"]
    assert int(out["cycle"]) == 0  # two interleaved checkerboards never share a voxel
    assert int(out["cycle_overlap"]) > 0 and int(cnt) > 0

    # the same scene through the plain route on the card
    with plain_route():
        plain = main_path(dev)
    assert torch.equal(plain["env"].data, data), "fused map differs from the plain route"
    plain_counts = [int(c) for c in plain["robot_counts"]]
    assert counts == plain_counts, (counts, plain_counts)
    log(f"  (c) robot collides {counts} == plain route, > 0")
    assert int(plain["cycle"]) == 0 and int(plain["cycle_overlap"]) == int(out["cycle_overlap"])
    p_cnt, p_marked = plain["mark"]
    assert int(p_cnt) == int(cnt) and torch.equal(p_marked.data, marked.data)
    log(f"  (d) 512^3 cycle: checkerboards collide 0, shifted overlap {int(out['cycle_overlap'])}, "
        f"marking count {int(cnt)} == plain, marked map equal")
    return out


# -- phase 4 ------------------------------------------------------------------
def time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(kernel, plain, iters: int) -> tuple[float, float]:
    """plain, kernel, kernel, plain: the means of each pair."""
    p1 = time_ms(plain, iters)
    k1 = time_ms(kernel, iters)
    k2 = time_ms(kernel, iters)
    p2 = time_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def timings(dev: torch.device, smi: str, out: dict) -> dict:
    g = torch.Generator(device=dev).manual_seed(99)
    n = CYCLE_DIMS[0] * CYCLE_DIMS[1] * CYCLE_DIMS[2]
    a = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    b = torch.randint(-128, 128, (n,), dtype=torch.int8, device=dev, generator=g)
    t = {}
    t["count_prob_prob"] = in_turns(
        lambda: collide_cuda.count_prob_prob(a, b, -120, 0),
        lambda: collide_cuda.count_prob_prob_plain(a, b, -120, 0), 50)
    t["count_and_mark_prob"] = in_turns(
        lambda: collide_cuda.count_and_mark_prob(a, b, -120, 0),
        lambda: collide_cuda.count_and_mark_prob_plain(a, b, -120, 0), 30)
    del a, b
    depth = torch.as_tensor(bench_frame(), device=dev)
    pose = torch.as_tensor(carve_poses()["bench"], device=dev)
    t["projective_free_space_exact"] = in_turns(
        lambda: raycast_cuda.projective_free_space_exact(depth, pose, *INTR, FUSION_SIDE, FUSION_DIMS),
        lambda: raycast_cuda.projective_free_space_plain(depth, pose, *INTR, FUSION_SIDE, FUSION_DIMS), 30)
    for name, (k, p) in t.items():
        log(f"  {name}: kernel {k:.4f} ms, plain torch {p:.4f} ms  [{smi}]")

    pts = out["cycle_pts"]

    def cycle():
        m1 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts)
        m2 = ProbVoxelMap.create(CYCLE_DIMS, 1.0, device=dev).insert_point_cloud(pts + 1.0)
        return m1.collide_with(m2, 0.5)

    cycle_ms = time_ms(cycle, 20)
    log(f"  512^3 insert->insert->collide cycle (2 x 307,200 points): {cycle_ms:.4f} ms = "
        f"{1000.0 / cycle_ms:.2f} Hz  [{smi}]")
    sensor = kinect_sensor()
    frame = torch.as_tensor(out["frames"][0], device=dev)  # pre-staged on the card
    fresh = ProbVoxelMap.create(FUSION_DIMS, FUSION_SIDE, device=dev)
    fuse_ms = time_ms(lambda: fresh.insert_depth_image(frame, sensor), 20)
    log(f"  256^3 fusion of one 640x480 frame (exact carve): {fuse_ms:.4f} ms = "
        f"{1000.0 / fuse_ms:.2f} Hz  [{smi}]")
    return t


def main() -> int:
    dev, smi = card()
    log("phase 1: build")
    t0 = time.perf_counter()
    path = kernels.build()
    kernels.library()
    log(f"  built {path.name} in {time.perf_counter() - t0:.2f} s")
    log("phase 2: kernels against their plain versions (exact)")
    err = check_kernels(dev)
    log("phase 3: main path")
    out = drive_main_path(dev)
    launches = {name: module.launches[name] for name, module, *_ in KERNELS}
    log("phase 4: times (CUDA events)")
    t = timings(dev, smi, out)
    report = {"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": err[name],
         "ms": t[name][0], "plain_ms": t[name][1]}
        for name, _module, source, replaces in KERNELS
    ]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
