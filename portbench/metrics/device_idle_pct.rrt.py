"""Percent of the profiled slice in which the device runs no operation;
the solves run back to back, so the slice is their span."""
from portbench import stats


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops:
        return None
    return stats.idle_share([t.window], t.busy())
