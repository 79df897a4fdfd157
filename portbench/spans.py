"""The program's own spans in one run of a cell: the cell run as
`portbench/run.py` runs it, with gpu_voxels_tpu_torch's spans
(`utils/perfmon.span`) recorded from the window's start and, in a traced
run, annotated as "gv." ranges in the profiled slice.

    python -m portbench.spans --workload <cell> --seed <n> --seconds 51 --trace <0|1>

prints run.py's two lines, the last one with more in it: the program-span
metrics of the cell's loop (`METRICS`) among its metrics, the slice's idle
gaps by program span (`breakdown["idle_gaps_program"]`, --trace 1), and in
the notes each span's count, median and median self time in the window
(`program_spans`), and how the slice's "gv." ranges match the records.
`--trace 0` records the spans and annotates nothing: run against run.py's
`--trace 0` on the same seed, it measures what recording costs.

The benchmark's own runs never run it, and without the program's spans
(a checkout older than `perfmon.enable_spans`) it stops with an error.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import os
import sys
import tempfile
from collections import defaultdict

import torch

from . import harness, stats
from .trace import SLICE, Recorder, Trace

PREFIX = "gv."
REQUESTS = ("update", "check")  # the benchmark's spans of one request


class SpanRecorder(Recorder):
    """The harness's recorder with the program's spans: recording switched
    on when the window is about to start (the recorder is made after the
    warm-up), each update's or check's program spans under its request id,
    the window's records drained when the slice starts, and the slice's
    "gv." ranges kept from the profiler's trace."""

    def __init__(self, device: torch.device, trace: bool):
        from gpu_voxels_tpu_torch.utils import perfmon

        super().__init__(device, trace)
        self.perfmon = perfmon
        self.requests = 0
        self.window_records = None  # drained at the slice's start (--trace 1)
        self.slice_records = None
        self.program_ranges = []  # (start, end, name without "gv.") in the slice, by start
        self.slice_trace = None
        perfmon.drain_spans()
        perfmon.enable_spans(True, False)

    def span(self, name: str):
        inner = super().span(name)
        if name not in REQUESTS:
            return inner
        self.requests += 1
        stack = contextlib.ExitStack()
        stack.enter_context(self.perfmon.request(self.requests))
        stack.enter_context(inner)
        return stack

    def start_slice(self) -> None:
        if not self.trace or self.prof is not None:
            return
        self.window_records = self.perfmon.drain_spans()
        self.perfmon.enable_spans(True, True)
        super().start_slice()

    def stop_slice(self) -> None:
        super().stop_slice()
        self.slice_records = self.perfmon.drain_spans()
        self.perfmon.enable_spans(False, False)

    def read_trace(self):
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.prof = None
        self.program_ranges = program_ranges(events)
        self.slice_trace = Trace.from_events(events)
        return self.slice_trace

    def finish(self) -> list:
        """The window's records (drained now in an untraced run), spans off."""
        if self.window_records is None:
            self.window_records = self.perfmon.drain_spans()
        self.perfmon.enable_spans(False, False)
        return self.window_records


def program_ranges(events: list) -> list:
    """[(start, end, name)]: the "gv." ranges of a chrome trace in the
    order their spans opened (by start, the enclosing one first)."""
    out = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][len(PREFIX):]) for e in events
           if e.get("ph") == "X" and "dur" in e and e.get("cat") == "user_annotation"
           and e.get("name", "").startswith(PREFIX)]
    return sorted(out, key=lambda r: (r[0], -r[1]))


def median_ms(records: list, name: str):
    """The median duration of the records named `name`, in ms."""
    v = [(r[2] - r[1]) / 1e6 for r in records if r[0] == name]
    return stats.median(v) if v else None


def launches_per_range(trace, ranges: list, name: str):
    """CUDA launch calls inside the slice's `name` ranges, per range."""
    inside = [(s, e) for s, e, n in ranges if n == name]
    if trace is None or not inside or not trace.launches:
        return None
    launches = sorted(trace.launches)
    return sum(bisect.bisect_right(launches, e) - bisect.bisect_left(launches, s) for s, e in inside) / len(inside)


# name -> (unit, read(window records, trace, slice ranges)); a name's
# suffix is the traffic loop whose cells report it
METRICS = {
    "sense_upload_ms.monitor": ("ms", lambda r, t, g: median_ms(r, "sense.upload")),
    "sense_hits_ms.monitor": ("ms", lambda r, t, g: median_ms(r, "sense.hits")),
    "fk_chain_ms.monitor": ("ms", lambda r, t, g: median_ms(r, "robot.chain")),
    "sense_launches.monitor": ("launches", lambda r, t, g: launches_per_range(t, g, "sense")),
    "fk_launches.monitor": ("launches", lambda r, t, g: launches_per_range(t, g, "robot.fk")),
    "fk_chain_ms.rrt": ("ms", lambda r, t, g: median_ms(r, "robot.chain")),
    "read_wait_ms.rrt": ("ms", lambda r, t, g: median_ms(r, "validity.read")),
    "fk_launches.rrt": ("launches", lambda r, t, g: launches_per_range(t, g, "robot.fk")),
}


def span_table(records: list) -> dict:
    """{name: {count, median_ms, self_median_ms}} over the records."""
    from gpu_voxels_tpu_torch.utils import perfmon

    own = perfmon.self_ms(records)
    by = defaultdict(lambda: ([], []))
    for r, s in zip(records, own):
        by[r[0]][0].append((r[2] - r[1]) / 1e6)
        by[r[0]][1].append(s)
    return {n: {"count": len(d), "median_ms": stats.median(d), "self_median_ms": stats.median(s)}
            for n, (d, s) in sorted(by.items())}


def idle_by_program_span(trace, ranges: list, k: int = 12) -> tuple:
    """([[span, seconds]], share): the slice's idle time by the innermost
    program span the host was in at each gap's midpoint, else by the
    innermost benchmark span ("pb.<name>"), else "outside spans"; and the
    percent of the idle time inside the request spans (update, check) that
    falls to a program span (None where there is none)."""
    lo, hi = trace.window
    points = []
    for name, ivs in trace.spans.items():
        if name != SLICE[3:]:
            points += [p for s, e in ivs for p in ((s, 2, ("pb", name)), (e, 0, ("pb", name)))]
    for s, e, name in ranges:
        points += [(s, 2, ("gv", name)), (e, 0, ("gv", name))]
    for g0, g1 in stats.gaps(trace.busy(), lo, hi):
        points.append((0.5 * (g0 + g1), 1, g1 - g0))
    points.sort(key=lambda p: (p[0], p[1]))
    stacks = {"pb": [], "gv": []}
    by = defaultdict(float)
    in_request = to_program = 0.0
    for _, kind, val in points:
        if kind == 2:
            stacks[val[0]].append(val[1])
        elif kind == 0:
            st = stacks[val[0]]
            if val[1] in st:
                del st[len(st) - 1 - st[::-1].index(val[1])]
        else:
            gv, pb = stacks["gv"], stacks["pb"]
            by[gv[-1] if gv else "pb." + pb[-1] if pb else "outside spans"] += val / 1e6
            if any(n in REQUESTS for n in pb):
                in_request += val
                to_program += val if gv else 0.0
    top = [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
    return top, (100.0 * to_program / in_request if in_request > 0 else None)


def execute(cell: str, seed: int, seconds: float, trace: bool, device: torch.device, t_process: float,
            **kw) -> dict:
    """harness.execute with a SpanRecorder, and what it recorded added to
    the result: the cell's METRICS, `breakdown["idle_gaps_program"]` and
    notes under "program_spans" and "program_slice"."""
    made = []

    def recorder(dev, tr):
        made.append(SpanRecorder(dev, tr))
        return made[-1]

    before = harness.Recorder
    harness.Recorder = recorder
    try:
        result = harness.execute(cell, seed, seconds, trace, device, t_process, **kw)
    finally:
        harness.Recorder = before
        for rec in made:
            records = rec.finish()
    spec = harness.load_spec()
    loop = (kw.get("traffic") or harness.load_traffic(harness.find_cell(spec, cell)["traffic"]))["loop"]
    tr = rec.slice_trace
    for name, (unit, read) in METRICS.items():
        if name.rsplit(".", 1)[1] == loop:
            value = read(records, tr, rec.program_ranges)
            if value is not None:
                result["metrics"][name] = {"value": value, "unit": unit}
    notes = {"program_spans": span_table(records)}
    if tr is not None:
        gaps, share = idle_by_program_span(tr, rec.program_ranges)
        result["breakdown"]["idle_gaps_program"] = gaps
        slice_names = [r[0] for r in rec.slice_records or []]
        notes["program_slice"] = {
            "records": len(slice_names), "ranges": len(rec.program_ranges),
            "ranges_match_records": [n for _, _, n in rec.program_ranges] == slice_names,
            "request_idle_to_program_pct": share,
        }
    result["notes"].update(notes)
    return result


def main(argv=None) -> int:
    from . import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=1)
    a = p.parse_args(argv)
    spec = harness.load_spec()
    device = harness.card(int(harness.find_cell(spec, a.workload)["chips"]))
    harness.steady_process()
    result = execute(a.workload, a.seed, a.seconds, bool(a.trace), device, run.T_PROCESS)
    notes = result.pop("notes")
    print(json.dumps({"card": harness.card_line(), **notes}), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
