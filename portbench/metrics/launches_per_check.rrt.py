"""Kernel launches (the CUDA runtime's launch calls) made inside the
check_motion spans of the profiled slice, per such check: an exact count."""
import bisect


def read(ctx):
    t = ctx.trace
    checks = t.spans.get("check") if t is not None else None
    if not checks or not t.launches:
        return None
    launches = sorted(t.launches)
    n = sum(bisect.bisect_right(launches, e) - bisect.bisect_left(launches, s) for s, e in checks)
    return n / len(checks)
