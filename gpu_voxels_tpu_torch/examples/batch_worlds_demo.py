"""Batched-world planning: the worlds as a batch axis.

Plans are usually validated against MANY hypothetical worlds (sampled
obstacle predictions, belief particles). A stack of W environments is one
[W, N] tensor, so every world and every candidate path is checked by one
broadcast gather — the multi-device version shards the same axis over the
mesh ('world' in parallel/sharded).
"""
import numpy as np
import torch

from gpu_voxels_tpu_torch.constants import float_to_probability
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.ops.insert import linear_index, map_to_voxels
from gpu_voxels_tpu_torch.utils import resolve_device

DIMS = (64, 64, 64)
W = 16  # worlds


def main(device=None):
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    # W sampled worlds: a wall whose opening position is uncertain
    envs = []
    for w in range(W):
        gap = rng.uniform(8, 56)
        ys = np.arange(0.5, 64, 1.0, dtype=np.float32)
        zs = np.arange(0.5, 64, 1.0, dtype=np.float32)
        yy, zz = np.meshgrid(ys, zs, indexing="ij")
        keep = np.abs(yy - gap) > 4.0  # 8-voxel gap
        wall = np.stack([np.full(keep.sum(), 32.5, np.float32), yy[keep], zz[keep]], axis=1)
        envs.append(ProbVoxelMap.create(DIMS, device=device).insert_point_cloud(wall).data)
    env_stack = torch.stack(envs)  # [W, N]

    # candidate straight-line paths through the wall, one per crossing y
    t = float_to_probability(0.5)
    candidates = torch.arange(4.5, 60.0, 1.0, device=device)  # [C]
    c = candidates.shape[0]
    xs = torch.linspace(2.0, 62.0, 61, device=device)
    pts = torch.stack(
        [xs.expand(c, 61), candidates[:, None].expand(c, 61), torch.full((c, 61), 32.5, device=device)], dim=-1
    )  # [C, 61, 3]
    idx = linear_index(map_to_voxels(pts, 1.0), DIMS)  # [C, 61]

    # all worlds x all candidate crossings in ONE gather: [W, C, 61] -> [W, C]
    blocked = (env_stack[:, idx].to(torch.int32) >= t).any(dim=-1)
    feasible_per_candidate = (~blocked).sum(dim=0).cpu().numpy()
    best = int(np.argmax(feasible_per_candidate))
    print(f"{W} worlds x {c} candidate crossings in one batched gather")
    print(
        f"best crossing y={float(candidates[best]):.1f} is clear in "
        f"{feasible_per_candidate[best]}/{W} worlds"
    )
    assert feasible_per_candidate[best] >= 1
    return int(feasible_per_candidate[best])


if __name__ == "__main__":
    main()
