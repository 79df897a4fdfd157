"""Port of examples/RobotVsEnvironment.cpp:163-201: the LIVE sensor loop.

A StreamingDepthSource paces Kinect-shaped frames at real sensor cadence
(helpers/Kinect.h:36-70 latest-wins contract); every frame drives the public
API end-to-end through `frame_step` (the reference makes the same calls as
separate kernel launches, RobotVsEnvironment.cpp:163-201):

    source.wait_for_frame      -> frame due at cadence (latest wins)
    frame_step                 -> ProbVoxelMap.insert_depth_image (EXACT
                                  per-pixel carve, reference insertSensorData
                                  semantics) + DH FK + BitVectorVoxelMap
                                  insert + collide count, queued on the
                                  device without a host wait
    counts stacked in batches  -> 0-d count tensors stacked on the device
                                  every `fetch_every` frames and read on the
                                  host once, after the loop
    Provider.visualize         -> AsyncVisPublisher (latest-wins worker
                                  thread = the reference's cheap IPC publish;
                                  vis_max_cubes bounds each snapshot fetch;
                                  a writer process per provider writes the
                                  files, off the loop's interpreter)

On the card the loop runs 640x480 frames into 256^3 at a 60 Hz source
cadence; on the CPU (`device="cpu"`) the scene shrinks (64x48 frames into
64^3) so a CPU run stays fast. Depth frames are staged on the device once, as
a camera's upload would be.

`frame_step` is a plain function of its inputs: a fixed sequence of frames
and joint values replayed through it gives the same maps and counts.
"""
import time

import numpy as np
import torch

from gpu_voxels_tpu_torch.geometry.pointcloud import MetaPointCloud
from gpu_voxels_tpu_torch.maps.voxelmap import BitVectorVoxelMap, ProbVoxelMap
from gpu_voxels_tpu_torch.providers import Provider
from gpu_voxels_tpu_torch.robot.dh import DHParameters, KinematicChain
from gpu_voxels_tpu_torch.sensors import Sensor, StreamingDepthSource
from gpu_voxels_tpu_torch.utils import resolve_device, to_device


def make_robot(reach: float, device=None):
    seg = reach / 2.0
    params = [DHParameters(0, 0, seg, 0), DHParameters(0, 0, seg, 0)]
    clouds = MetaPointCloud.from_clouds(
        [np.linspace([0.05 * seg, 0, 0], [0.95 * seg, 0, 0], 27).astype(np.float32)] * 2,
        names=("link1", "link2"),
        device=device,
    )
    return KinematicChain(["link1", "link2"], params, clouds)


def make_frames(sensor: Sensor, n: int = 8, seed: int = 0, device=None):
    """A short synthetic recording (moving box in front of a wall), staged on
    the device once — the StreamingDepthSource then replays it at cadence."""
    rng = np.random.default_rng(seed)
    h, w = sensor.data_height, sensor.data_width
    frames = []
    for t in range(n):
        d = np.full((h, w), 4.0, np.float32)
        x0 = int((0.2 + 0.05 * t) * w) % (w // 2)
        d[h // 4 : 3 * h // 4, x0 : x0 + w // 3] = 2.5
        d += rng.normal(0, 0.003, (h, w)).astype(np.float32)
        frames.append(to_device(d, torch.float32, device))
    return frames


def scene(device):
    """(dims, side, sensor, default frame count, default cadence in Hz) of
    the loop on `device`: the reference's accelerator scene on the card,
    its CPU scene on the CPU."""
    if device.type == "cuda":
        # RealSense-class 60 Hz source; latest-wins drops what the loop
        # can't keep up with
        return (256, 256, 256), 0.02, Sensor(position=np.array([2.56, 2.56, 0.1], np.float32)), 60, 60.0
    sensor = Sensor(
        position=np.array([1.6, 1.6, 0.1], np.float32),
        data_width=64, data_height=48, fx=52.5, fy=52.5, cx=31.5, cy=23.5,
    )
    return (64, 64, 64), 0.05, sensor, 6, 120.0  # don't let a CPU run sleep at 30 Hz


def frame_step(env_map, depth, joints, sensor, robot, base, dims, side):
    """THE frame: sense -> insert -> FK -> insert -> collide. Returns the
    new environment map, the robot map and the collision count as a 0-d
    device tensor (read on the host only by the caller)."""
    env2 = env_map.insert_depth_image(depth, sensor)
    clouds = robot.transformed_clouds_for(joints)
    rob2 = BitVectorVoxelMap.create(dims, side, device=env_map.device).insert_point_cloud(clouds.points + base)
    return env2, rob2, rob2.collide_with(env2, 0.7)


def main(frames: int = None, hz: float = None, live_vis: bool = False,
         fetch_every: int = 8, device=None):
    device = resolve_device(device)
    dims, side, sensor, default_frames, default_hz = scene(device)
    n_frames = default_frames if frames is None else frames
    hz = default_hz if hz is None else hz

    source = StreamingDepthSource(make_frames(sensor, device=device), hz=hz)

    # publish budget: each viewer snapshot fetch is O(max_cubes), so the
    # worker's readbacks cannot monopolize the host link against the loop
    env = Provider("env", carve_pool=1, live_vis=live_vis, vis_max_cubes=65536)
    env.init(ProbVoxelMap.create(dims, side, device=device))

    extent = dims[0] * side
    robot = make_robot(reach=0.45 * extent, device=device)
    base = to_device(np.full(3, extent / 2, np.float32), torch.float32, device)

    rob = Provider("robot", live_vis=live_vis, vis_max_cubes=65536)
    rob.set_collide_with(env, coll_threshold=0.7)

    def step(env_map, depth, joints):
        return frame_step(env_map, depth, joints, sensor, robot, base, dims, side)

    # warm up outside the timed loop (the kernels build at their first call),
    # including the count-batch stack and the publish path
    e0, r0, c0 = step(env.map, source._frames[0], torch.zeros(2, device=device))
    torch.stack([c0] * fetch_every).cpu()
    env.map, rob.map = e0, r0
    warm = [0, 0]
    if live_vis:
        env.visualize()
        rob.visualize()
        warm = [env.finish_visualization(), rob.finish_visualization()]
    env.init(ProbVoxelMap.create(dims, side, device=device))
    joint_values = to_device(np.array([[i * 0.1, i * 0.05] for i in range(n_frames)], np.float32),
                             torch.float32, device)

    stacks, pending, processed = [], [], 0
    t0 = time.perf_counter()
    for i in range(n_frames):
        depth = source.wait_for_frame(timeout_s=2.0 / hz + 0.5)
        if depth is None:
            continue
        env.map, rob.map, cnt = step(env.map, depth, joint_values[i])
        pending.append(cnt)
        if live_vis:
            # O(1) async publish (latest-wins mailbox); headless runs skip
            # visualization entirely — the sync VisProvider export is the
            # offline/pull path, not a per-frame producer cost
            env.visualize()
            rob.visualize()
        processed += 1
        if len(pending) >= fetch_every:
            stacks.append(torch.stack(pending))  # on the device: no host read
            pending = []
    # wait for the LAST frame before the clock stops: every frame's
    # insert/collide chains on the previous one, so this drains the loop
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    if pending:
        stacks.append(torch.stack(pending))
    counts = torch.cat(stacks).tolist() if stacks else [0]  # the one host read
    sustained = processed / elapsed

    # the snapshots each provider painted during the loop (the warm-up's left out)
    painted = [env.stop_visualization() - warm[0], rob.stop_visualization() - warm[1]] if live_vis else [0, 0]
    print(
        f"{processed}/{n_frames} frames in {elapsed:.2f} s = {sustained:.1f} Hz "
        f"sustained (source cadence {hz:.0f} Hz, exact carve, "
        f"collisions min/max {min(counts)}/{max(counts)}"
        + (f", {sum(painted)} snapshots painted" if live_vis else "")
        + ")"
    )
    return {"sustained_hz": sustained, "processed": processed, "counts": counts, "painted": painted}


if __name__ == "__main__":
    main(live_vis=True)
