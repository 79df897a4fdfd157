"""Kernel launches (the CUDA runtime's launch calls) made inside the edt
spans of the profiled slice, per such span: an exact count of the
distance field's refresh."""
import bisect


def read(ctx):
    t = ctx.trace
    spans = t.spans.get("edt") if t is not None else None
    if not spans or not t.launches:
        return None
    launches = sorted(t.launches)
    n = sum(bisect.bisect_right(launches, e) - bisect.bisect_left(launches, s) for s, e in spans)
    return n / len(spans)
