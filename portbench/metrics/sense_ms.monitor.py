"""Median device-timeline time of the depth insert
(ProbVoxelMap.insert_depth_image: upload, hits, the exact carve K3, the
log-odds update), between CUDA events around the call, in ms."""
from portbench import stats


def read(ctx):
    v = ctx.window.layers.get("sense")
    return stats.median(v) if v else None
