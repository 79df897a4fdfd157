"""Median time of the distance field's refresh: DistanceVoxelMap.create,
merge_occupied and parallel_banding (PBA phase 1's Z flood and both K5
passes), between CUDA events around the calls, in ms."""
from portbench import stats


def read(ctx):
    v = ctx.window.layers.get("edt")
    return stats.median(v) if v else None
