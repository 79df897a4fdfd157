"""K3's share of its roofline: the least time of one exact carve over the
profiler's mean device time of carve_exact_kernel, in percent. The least
time is the larger of the operations at the f32 peak and the bytes at the
HBM peak; see portbench/roofline.py."""
from portbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    times = [e - s for s, e, n in t.device_ops if "carve_exact_kernel" in n]
    if not times:
        return None
    m, s = ctx.cfg["map"]["dims"], ctx.cfg["sensor"]
    least_s, _ = roofline.k3_least_s(m[0] * m[1] * m[2], s["height"] * s["width"])
    return 100.0 * least_s / (sum(times) / len(times) / 1e6)
