"""Median time of the robot's insert into a new BitVectorVoxelMap, the
collide_with and the count's host read together, between a CUDA event
before the insert and one recorded after the read, in ms."""
from portbench import stats


def read(ctx):
    v = ctx.window.layers.get("collide")
    return stats.median(v) if v else None
