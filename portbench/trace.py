"""Spans recorded around the benchmark's own calls into each layer, and the
profiled slice of a traced run.

With tracing off, `span` is a shared no-op and no event is recorded, so
the end-to-end numbers are taken as a user would see them. With tracing
on, `event` marks the device's timeline with CUDA events (the host clock
on the CPU) through the window, and a slice of the same traffic after the
window runs under torch.profiler, each span then a `record_function` range
named "pb.<span>" so that the device's operations can be laid against what
the host was doing. The profiler is first started only after the window:
CUPTI, once started, slows every later launch, so the window's spans are
taken as an unprofiled process makes them. The trace is written to a
temporary directory (under TMPDIR), read and deleted.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

from . import stats

_NOOP = contextlib.nullcontext()
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "pb.slice"


class Recorder:
    def __init__(self, device: torch.device, trace: bool):
        self.cuda = device.type == "cuda"
        self.trace = trace
        self.prof = None
        self.profiling = False
        self.slice_range = None

    def span(self, name: str):
        if not self.trace:
            return _NOOP
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        if self.profiling:
            with torch.profiler.record_function("pb." + name):
                yield
        else:
            yield

    def event(self):
        """A mark on the device's timeline (a recorded CUDA event), or the
        host clock on the CPU; None with tracing off."""
        if not self.trace:
            return None
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def elapsed_ms(self, a, b) -> float:
        if not self.cuda:
            return (b - a) * 1e3
        return a.elapsed_time(b)

    def _activities(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start_slice(self) -> None:
        if not self.trace or self.prof is not None:
            return
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self.slice_range = torch.profiler.record_function(SLICE)
        self.slice_range.__enter__()
        self.profiling = True

    def stop_slice(self) -> None:
        if not self.profiling:
            return
        self.slice_range.__exit__(None, None, None)
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.profiling = False

    def read_trace(self) -> "Trace | None":
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.prof = None
        return Trace.from_events(events)


@dataclass
class Trace:
    """A profiled slice, times in microseconds of the profiler's clock."""

    device_ops: list = field(default_factory=list)  # (start, end, name)
    spans: dict = field(default_factory=dict)  # name without "pb." -> [(start, end)]
    launches: list = field(default_factory=list)  # host times of kernel launches
    window: tuple = (0.0, 0.0)  # the pb.slice range

    @staticmethod
    def from_events(events: list) -> "Trace":
        t = Trace()
        spans = defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s = float(e["ts"])
            end = s + float(e["dur"])
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATEGORIES:
                t.device_ops.append((s, end, name))
            elif cat == "user_annotation" and name.startswith("pb."):
                spans[name[3:]].append((s, end))
            elif cat.startswith("cuda_") and "LaunchKernel" in name:  # the runtime's or the CUDA API's launch
                t.launches.append(s)
        t.spans = dict(spans)
        sl = spans.get(SLICE[3:])
        t.window = sl[0] if sl else (0.0, 0.0)
        return t

    def clipped_ops(self) -> list:
        lo, hi = self.window
        return [(max(s, lo), min(e, hi), n) for s, e, n in self.device_ops if e > lo and s < hi]

    def busy(self) -> list:
        return stats.union((s, e) for s, e, _ in self.clipped_ops())

    def busy_s(self) -> float:
        return stats.length(self.busy()) / 1e6

    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds]: the device operations that took most time."""
        by = defaultdict(float)
        for s, e, n in self.clipped_ops():
            by[n[:160]] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_by_span(self, k: int = 10) -> list:
        """[span, seconds]: the device's idle time in the slice, summed by
        the innermost span the host was in (at each gap's midpoint)."""
        lo, hi = self.window
        points = []
        for name, ivs in self.spans.items():
            if name == SLICE[3:]:
                continue
            for s, e in ivs:
                points.append((s, 2, name))
                points.append((e, 0, name))
        for g0, g1 in stats.gaps(self.busy(), lo, hi):
            points.append((0.5 * (g0 + g1), 1, g1 - g0))
        points.sort(key=lambda p: (p[0], p[1]))
        stack, by = [], defaultdict(float)
        for _, kind, val in points:
            if kind == 2:
                stack.append(val)
            elif kind == 0:
                if val in stack:
                    del stack[len(stack) - 1 - stack[::-1].index(val)]
            else:
                by[stack[-1] if stack else "outside spans"] += val / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
