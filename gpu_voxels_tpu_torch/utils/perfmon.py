"""Performance monitor (reference: icl_core_performance_monitor).

Static registry of named timers and data series with prefix-based
enable/disable and summaries (PerformanceMonitor.h:95-106,
PerformanceMonitorMacros.h:47-112). The reference's PERF_MON_* macros map to:

    PERF_MON_INITIALIZE           -> initialize()
    PERF_MON_ENABLE(prefix)       -> enable(prefix)
    PERF_MON_START(timer)         -> start(timer)
    PERF_MON_PRINT_INFO_P         -> measure(timer, description, prefix)
    PERF_MON_SILENT_MEASURE_...   -> measure(..., silent=True) + start()
    PERF_MON_ADD_DATA_P           -> add_data(description, value, prefix)
    PERF_MON_SUMMARY_PREFIX_INFO  -> summary(prefix)

Counterpart of gpu_voxels_tpu/utils/perfmon.py. A measurement covers
completed device work only if the caller synchronizes: pass a tensor, or a
sequence of tensors, as `block_on` and the host waits for the device of
every CUDA tensor among them before reading the clock (CPU tensors need no
wait).

Beside the monitor, the program's spans: `span(name)` marks a step of the
port where the work happens (the sites are listed in README.md). They are
off by default, and each site then costs one shared no-op. Switched on by
`enable_spans(record, annotate)`:

  record    each span appends (name, t0_ns, t1_ns, parent, request) to an
            in-memory buffer, times from time.perf_counter_ns, `parent` the
            buffer index of the enclosing span (-1 for none), `request` the
            id that the innermost `request(rid)` context set (None outside);
            `drain_spans()` returns the buffer and empties it
  annotate  each span also opens torch.profiler.record_function("gv." +
            name), so that inside a profiler window the program's steps lie
            on the profiler's clock beside the device's operations

Spans nest by the order in which they open and close: record from one
thread at a time. A span closes on an exception too. A span still open at
`drain_spans()` is not recorded.
"""
from __future__ import annotations

import statistics
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def _synchronize(block_on) -> None:
    """Wait for the device of every CUDA tensor in `block_on` (a tensor or a
    sequence of tensors)."""
    tensors = [block_on] if isinstance(block_on, torch.Tensor) else list(block_on)
    for device in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(device)


class PerformanceMonitor:
    _instance: Optional["PerformanceMonitor"] = None

    def __init__(self):
        self.enabled_prefixes = set()
        self.all_enabled = False
        self.timers: Dict[str, float] = {}
        self.data: Dict[str, List[float]] = defaultdict(list)
        self.events: List[str] = []

    @classmethod
    def instance(cls) -> "PerformanceMonitor":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    # -- control ---------------------------------------------------------
    @classmethod
    def initialize(cls, num_names: int = 0, num_events: int = 0) -> None:
        cls._instance = cls()

    def enable(self, prefix: str) -> None:
        self.enabled_prefixes.add(prefix)

    def disable(self, prefix: str) -> None:
        self.enabled_prefixes.discard(prefix)

    def enable_all(self, enabled: bool = True) -> None:
        self.all_enabled = enabled

    def _on(self, prefix: str) -> bool:
        return self.all_enabled or prefix in self.enabled_prefixes

    # -- timers ------------------------------------------------------------
    def start(self, timer_name: str) -> None:
        self.timers[timer_name] = time.perf_counter()

    def measure(
        self,
        timer_name: str,
        description: str,
        prefix: str = "",
        silent: bool = True,
        block_on=None,
        reset: bool = True,
    ) -> float:
        """Record elapsed ms under prefix::description; optionally restart."""
        if block_on is not None:
            _synchronize(block_on)
        t0 = self.timers.get(timer_name)
        if t0 is None:
            return 0.0
        ms = (time.perf_counter() - t0) * 1e3
        if self._on(prefix):
            self.data[f"{prefix}::{description}"].append(ms)
            if not silent:
                self.events.append(f"{prefix}::{description}: {ms:.3f} ms")
        if reset:
            self.start(timer_name)
        return ms

    def add_data(self, description: str, value: float, prefix: str = "") -> None:
        if self._on(prefix):
            self.data[f"{prefix}::{description}"].append(float(value))

    # -- summaries -----------------------------------------------------------
    def summary(self, prefix: str = "") -> str:
        lines = []
        for key in sorted(self.data):
            if prefix and not key.startswith(prefix + "::"):
                continue
            vals = self.data[key]
            lines.append(
                f"{key}: n={len(vals)} avg={statistics.fmean(vals):.3f} "
                f"median={statistics.median(vals):.3f} "
                f"min={min(vals):.3f} max={max(vals):.3f}"
            )
        return "\n".join(lines)

    def series(self, description: str, prefix: str = "") -> List[float]:
        """The values under prefix::description; none where nothing was
        recorded (reading inserts no empty series, which `summary` could
        not average)."""
        return list(self.data.get(f"{prefix}::{description}", ()))


# -- program spans -------------------------------------------------------------
SpanRecord = Tuple[str, int, int, int, Optional[object]]  # name, t0_ns, t1_ns, parent, request


class _Noop:
    """The context every span and request is while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _Noop()


class _Spans:
    """The process's span state: the switches, the buffer, the open spans."""

    def __init__(self):
        self.record = False
        self.annotate = False
        self.buffer: list = []  # SpanRecord, or None while the span is open
        self.open: List[int] = []  # buffer indices of the open spans, innermost last
        self.request = None
        self.generation = 0  # bumped by each drain


_spans = _Spans()


class _Span:
    __slots__ = ("name", "index", "generation", "range", "t0")

    def __init__(self, name: str):
        self.name = name
        self.index = -1
        self.range = None

    def __enter__(self):
        if _spans.annotate:
            self.range = torch.profiler.record_function("gv." + self.name)
            self.range.__enter__()
        if _spans.record:
            self.generation = _spans.generation
            self.index = len(_spans.buffer)
            _spans.buffer.append(None)
            _spans.open.append(self.index)
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.index >= 0:
            t1 = time.perf_counter_ns()
            if self.generation == _spans.generation:
                _spans.open.pop()
                parent = _spans.open[-1] if _spans.open else -1
                _spans.buffer[self.index] = (self.name, self.t0, t1, parent, _spans.request)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class _Request:
    __slots__ = ("rid", "outer")

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self):
        self.outer, _spans.request = _spans.request, self.rid
        return self

    def __exit__(self, *exc) -> bool:
        _spans.request = self.outer
        return False


def enable_spans(record: bool, annotate: bool) -> None:
    """Switch span recording and profiler annotation on or off."""
    _spans.record, _spans.annotate = bool(record), bool(annotate)


def span(name: str):
    """A context timing one step of the program; the shared no-op while
    spans are off."""
    if not (_spans.record or _spans.annotate):
        return _NOOP
    return _Span(name)


def request(rid):
    """A context whose recorded spans share the request id `rid`; the
    shared no-op while recording is off."""
    if not _spans.record:
        return _NOOP
    return _Request(rid)


def drain_spans() -> List[SpanRecord]:
    """The closed spans' records in the order they opened, and an empty
    buffer. Parent indices point into the returned list (-1 where the
    parent was still open)."""
    out = _spans.buffer
    _spans.buffer, _spans.open = [], []
    _spans.generation += 1
    if None not in out:
        return out
    index = {}
    for i, r in enumerate(out):
        if r is not None:
            index[i] = len(index)
    return [r[:3] + (index.get(r[3], -1), r[4]) for r in out if r is not None]


def self_ms(records: List[SpanRecord]) -> List[float]:
    """Each record's duration less what its child spans cover, in ms (the
    children of one span run one after another)."""
    own = [r[2] - r[1] for r in records]
    for r in records:
        if r[3] >= 0:
            own[r[3]] -= r[2] - r[1]
    return [v / 1e6 for v in own]
