"""The highest update rate an open-loop monitor cell sustains: its traffic
run as a closed loop (updates due back to back), on the card.

    python -m portbench.knee --workload monitor.kinect30 --seed 5 --updates 2000

prints the updates answered per second over the time from the first
update's start to the last one's answer, and whether the run was correct.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from . import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--updates", type=int, default=2000)
    a = p.parse_args(argv)
    t0 = time.perf_counter()
    harness.steady_process()
    spec = harness.load_spec()
    traffic = harness.load_traffic(harness.find_cell(spec, a.workload)["traffic"])
    rate = 1e5  # due times far closer than any update: each runs when the one before has answered
    r = harness.execute(a.workload, a.seed, a.updates / rate, False, harness.card(1), t0,
                        traffic=dict(traffic, rate_hz=rate))
    n = r["notes"]
    print(json.dumps({"knee": a.workload, "seed": a.seed, "updates": n["answered"],
                      "sustained_hz": n["answered"] / n["last_answer_s"], "correct": r["correct"],
                      "card": harness.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
