"""The general loops that run the traffic mixes, one module per kind. A
traffic file names its loop under "loop"; each loop module has

    prepare(cfg, traffic, seed, seconds, device) -> inputs (host arrays)
    build(cfg, traffic, inp, device, control) -> the system under test
    warm(system, inp, traffic) -> None (every shape the window uses)
    run(system, inp, traffic, seconds, rec, t_process, slice_s) -> Window
        (the window; in a traced run, then `slice_s` more under the profiler)
    judge(cfg, traffic, inp, window, outputs, device) -> {check: (value, limit)}
    readings(cfg, traffic, seed, count, device) -> the band's readings
        (portbench/readings.py) over what the mix drives
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field


@dataclass
class Window:
    """What a measured window gives the metric readers."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    done: int  # updates answered, motion checks completed, states validated
    latencies_ms: list = field(default_factory=list)  # per update, None where missing
    layers: dict = field(default_factory=dict)  # span name -> [ms], outside the profiled slice
    notes: dict = field(default_factory=dict)  # printed on the run's earlier lines
    record: dict = field(default_factory=dict)  # what the judge compares


def loop_module(name: str):
    return importlib.import_module(f"{__name__}.{name}")
