"""Median time of the clearance query: the arm's FK, min_distance_to its
points and the clearance's host read, between a CUDA event before the FK
and one recorded after the read, in ms."""
from portbench import stats


def read(ctx):
    v = ctx.window.layers.get("query")
    return stats.median(v) if v else None
