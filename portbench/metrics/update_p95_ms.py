"""95th percentile of every update's latency in the window, in ms, timed
from the moment the update was due to its count on the host; a dropped or
failed update counts as missing (it ranks above every answered one)."""
from portbench import stats


def read(ctx):
    v = ctx.window.latencies_ms
    return stats.percentile(v, 95) if v else None
