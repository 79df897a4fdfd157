"""Port of examples/DistanceVoxelTest.cpp: EDT algorithm comparison and
bench program (jump flood vs exhaustive cross-check + proximity queries)."""
import numpy as np
import torch

from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.utils import resolve_device
from gpu_voxels_tpu_torch.utils.perfmon import PerformanceMonitor


def main(dim: int = 64, n_obstacles: int = 100, device=None):
    device = resolve_device(device)
    dims = (dim, dim, dim)
    rng = np.random.default_rng(0)
    obs = np.unique(rng.integers(0, dim, (n_obstacles, 3)), axis=0)
    pts = (obs + 0.5).astype(np.float32)

    pm = PerformanceMonitor.instance()
    pm.enable("pbatimer")

    def block_until_ready():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    m = DistanceVoxelMap.create(dims, device=device).insert_point_cloud(pts)
    pm.start("t")
    jfa = m.jump_flood()
    block_until_ready()
    pm.measure("t", "jump_flood", "pbatimer")

    pm.start("t")
    pba = m.parallel_banding()
    block_until_ready()
    pm.measure("t", "parallel_banding", "pbatimer")

    exact = DistanceVoxelMap.create(dims, device=device).exact_distances(obs.astype(np.int32))
    diff_je = int(jfa.differences(exact))
    diff_pe = int(pba.differences(exact))
    print(f"differences3D(jfa, exact) = {diff_je}")
    print(f"differences3D(pba, exact) = {diff_pe}")

    q = np.array([[dim / 2 + 0.5] * 3], np.float32)
    print("min distance from center:", float(jfa.min_distance_to(q)))
    print(pm.summary("pbatimer"))
    return diff_je + diff_pe


if __name__ == "__main__":
    raise SystemExit(main())
