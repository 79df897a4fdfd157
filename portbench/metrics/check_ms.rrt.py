"""Median host-clock time of one MotionValidator.check_motion, its host
read of the counts included, in ms."""
from portbench import stats


def read(ctx):
    v = ctx.window.layers.get("check")
    return stats.median(v) if v else None
