"""Median time of the arm's FK (KinematicChain.transformed_clouds_for and
the base offset), between CUDA events around the call, in ms."""
from portbench import stats


def read(ctx):
    v = ctx.window.layers.get("fk")
    return stats.median(v) if v else None
