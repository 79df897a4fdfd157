"""Motion checks completed in the window over the window's length."""
from portbench import stats


def read(ctx):
    return stats.rate(ctx.window.done, ctx.window.window_s)
