#!/usr/bin/env python3
"""The benchmark of gpu_voxels_tpu_torch: one run of one cell on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout holding BENCHMARK.json, portbench/ and the
port. It loads, warms every shape of the cell, measures for --seconds,
judges what the window produced against portbench/reference/, and prints
as its last line one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer metrics and a
breakdown with --trace 1), device, checks. Without a CUDA device it exits
non-zero and prints no result. Caches (the port's kernel library in
gpu_voxels_tpu_torch/_build/, Triton's in .portbench_cache/) stay inside
the checkout.
"""
import os
import sys
import time


def process_start() -> float:
    """The process's start on time.perf_counter()'s clock (Linux: its start
    tick in /proc/self/stat against CLOCK_BOOTTIME; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return now - max(since, 0.0)
    except (OSError, ValueError, IndexError, AttributeError):
        return now


T_PROCESS = process_start()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache", "triton")
sys.path.insert(0, ROOT)


def main() -> int:
    from portbench import harness

    return harness.main(sys.argv[1:], T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
