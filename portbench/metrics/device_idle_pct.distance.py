"""Percent of the union of the update spans (start to answer) in the
profiled slice in which the device runs no operation. Idle between updates
is the sensor's cadence and is not counted."""
from portbench import stats


def read(ctx):
    t = ctx.trace
    if t is None or not t.device_ops or not t.spans.get("update"):
        return None
    return stats.idle_share(t.spans["update"], t.busy())
