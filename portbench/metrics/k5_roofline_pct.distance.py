"""K5's share of its roofline: the least time of one envelope pass over the
map (16 B a voxel at the HBM peak; portbench/roofline_edt.py) over the
profiler's mean device time of envelope_columns_kernel (the pass along y)
and envelope_rows_kernel (along x) together, in percent."""
from portbench import roofline_edt

KERNELS = ("envelope_columns_kernel", "envelope_rows_kernel")


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    times = [e - s for s, e, n in t.device_ops if any(k in n for k in KERNELS)]
    if not times:
        return None
    m = ctx.cfg["map"]["dims"]
    least_s, _ = roofline_edt.k5_least_s(m[0] * m[1] * m[2])
    return 100.0 * least_s / (sum(times) / len(times) / 1e6)
