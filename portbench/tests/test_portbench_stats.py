"""The metric arithmetic: a tail over every update timed from its due time
with a dropped update missing, rates over the whole window, idle over the
union of spans, and a profiler trace read into spans and device time."""
import math

import pytest

from portbench import stats
from portbench.trace import Trace


def test_p95_counts_every_update_and_a_missing_one_ranks_last():
    lat = [float(v) for v in range(1, 101)]
    assert stats.percentile(lat, 95) == 95.0
    assert stats.percentile(lat[:99] + [None], 95) == 95.0
    assert stats.percentile(lat[:94] + [None] * 6, 95) == math.inf
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_p95_is_timed_from_the_due_time():
    """A stall delays every update queued behind it: with due times every
    10 ms and a 50 ms stall on update 0, updates 1-4 answer late too."""
    period, service = 10.0, 1.0
    done, t, lat = [], 0.0, []
    for i in range(20):
        due = i * period
        start = max(due, t)
        t = start + (50.0 if i == 0 else service)
        lat.append(t - due)
    assert lat[:7] == [50.0, 41.0, 32.0, 23.0, 14.0, 5.0, 1.0]
    assert stats.percentile(lat, 95) == 41.0 and stats.percentile(lat, 75) == 5.0


def test_rate_is_over_the_whole_window():
    assert stats.rate(600, 20.0) == 30.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_idle_is_taken_over_the_union_of_spans():
    spans = [(0, 10), (5, 15), (20, 30)]  # union 25
    busy = [(2, 4), (12, 22), (29, 40)]  # inside the spans: 2 + 3 + 2 + 1 = 8
    assert stats.length(spans) == 25
    assert stats.idle_share(spans, busy) == pytest.approx(100 * (1 - 8 / 25))
    assert stats.idle_share([], busy) is None
    assert stats.gaps([(1, 2), (3, 5)], 0, 6) == [(0, 1), (2, 3), (5, 6)]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_reads_slice_spans_device_time_and_launches():
    events = [
        _x("user_annotation", "pb.slice", 0, 100),
        _x("user_annotation", "pb.check", 10, 20), _x("user_annotation", "pb.check", 50, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1), _x("cuda_runtime", "cudaLaunchKernel", 15, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 40, 1), _x("cuda_runtime", "cudaLaunchKernel", 55, 1),
        _x("kernel", "carve_exact_kernel", 14, 6), _x("kernel", "carve_exact_kernel", 24, 2),
        _x("kernel", "other", 56, 4), _x("gpu_memcpy", "Memcpy", 95, 10),
        _x("cpu_op", "aten::add", 1, 2), {"ph": "i", "name": "marker", "ts": 3},
    ]
    t = Trace.from_events(events)
    assert t.window == (0.0, 100.0) and t.window_s() == 1e-4
    assert t.busy_s() == pytest.approx((6 + 2 + 4 + 5) / 1e6)  # the copy clipped to the slice
    assert len(t.spans["check"]) == 2 and len(t.launches) == 4
    assert t.top_ops()[0] == ["carve_exact_kernel", pytest.approx(8e-6)]
    # idle gaps 0-14, 26-56 and 60-95 fall outside the checks; 20-24 inside one
    idle = dict(t.idle_by_span())
    assert idle == {"outside spans": pytest.approx(79e-6), "check": pytest.approx(4e-6)}
