"""The harness: finds a cell's configuration, traffic and metrics by the
names in BENCHMARK.json, runs set-up, the measured window and the judge,
reads the metrics and prints the result.

Everything one configuration, traffic mix or metric needs sits in a file
of its own, found by name:

    BENCHMARK.json "configs"[i]["file"]     the configuration's sizes
    portbench/traffic/<traffic>.json        a traffic mix's parameters; its
                                            "loop" names the module in
                                            portbench/loops/ that runs it
    portbench/metrics/<metric>.py           the metric's reader, read(ctx)
                                            -> a number, or None when the
                                            run holds nothing to read
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from . import loops
from .trace import Recorder, Trace

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
SLICE_S = 3.0  # the profiled slice after a traced window
FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_voxels_tpu")


@dataclass
class Context:
    """What a metric reader sees."""

    window: loops.Window
    trace: Optional[Trace]
    cfg: dict
    traffic: dict


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def load_config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise SystemExit(f"portbench: no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    with open(root / "portbench" / "traffic" / f"{name}.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on): those listing the cell, or listing no cells, for a
    per-layer metric where the cell reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m["workloads"] or ("workloads" not in m and m["moves"] in names)]


def reader(name: str, root: Path = ROOT):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card(chips: int) -> torch.device:
    """The card, or an exit with no result where the run cannot have it."""
    if not torch.cuda.is_available():
        raise SystemExit("portbench: no CUDA device (torch.cuda.is_available() is False)")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} devices, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def steady_process() -> None:
    """One torch thread, the process held to two fixed cores: host-bound
    latencies then spread less between runs (the sandbox shares its host)."""
    torch.set_num_threads(1)
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 2:
        os.sched_setaffinity(0, set(cores[-2:]))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell: str, seed: int, seconds: float, trace: bool, device: torch.device, t_process: float,
            control: bool = False, root: Path = ROOT, cfg: Optional[dict] = None,
            traffic: Optional[dict] = None) -> dict:
    """One run: set-up, window, judge, metrics. `cfg` and `traffic`
    replace the cell's files (the CPU tests run tiny sizes)."""
    spec = load_spec(root)
    w = find_cell(spec, cell)
    cfg = cfg or load_config(spec, w["config"], root)
    traffic = traffic or load_traffic(w["traffic"], root)
    loop = loops.loop_module(traffic["loop"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    notes = {"cell": cell, "seed": seed, "seconds": seconds, "trace": int(trace), "control": control}
    if not control and device.type == "cuda":  # build (a checkout's first run) or load the kernel library
        from gpu_voxels_tpu_torch.utils import kernels

        notes["kernels_built_now"] = not kernels.library_path().exists()
        kernels.library()
    inp = loop.prepare(cfg, traffic, seed, seconds, device)
    sut = loop.build(cfg, traffic, inp, device, control)
    loop.warm(sut, inp, traffic)
    rec = Recorder(device, trace)
    _sync(device)
    gc.collect()
    win = loop.run(sut, inp, traffic, seconds, rec, t_process, min(SLICE_S, seconds / 2))
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tr = rec.read_trace()
    out = sut.outputs()
    del sut
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = loop.judge(cfg, traffic, inp, win, out, device)
    notes["judge_s"] = time.perf_counter() - t_judge
    ctx = Context(win, tr, cfg, traffic)
    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        value = reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": win.failed == 0 and all(v <= lim for v, lim in checks.values()),
              "attempted": win.attempted, "failed": win.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s(), tr.window_s()
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_span()}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    result["notes"] = {**notes, **win.notes, "setup_s": win.setup_s,
                       "layer_samples": {k: len(v) for k, v in win.layers.items()}}
    return result


def card_line() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else "nvidia-smi: none"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def main(argv, t_process: float) -> int:
    p = argparse.ArgumentParser(prog="portbench/run.py", description="One run of one benchmark cell on one card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    spec = load_spec()
    device = card(int(find_cell(spec, a.workload)["chips"]))
    steady_process()
    result = execute(a.workload, a.seed, a.seconds, bool(a.trace), device, t_process)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded modules of {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    notes = result.pop("notes")
    print(json.dumps({"card": card_line(), **notes}), flush=True)
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
