"""The solves' wall time outside check_motion per motion check (the
planner's host work: sampling, nearest neighbours, steering, tree
bookkeeping), in ms."""


def read(ctx):
    v = ctx.window.layers.get("planner_host_per_check")
    return v[0] if v else None
