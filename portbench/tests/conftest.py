"""The benchmark's CPU tests: python -m pytest portbench/tests -q -p no:cacheprovider

They run the harness, the reference and the control at tiny sizes on the
CPU (the port's kernels take their plain versions there). The repository's
`pytest tests/` does not collect them."""
import copy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small_monitor():
    return _small_monitor


def _small_monitor(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The monitor with a 160x120 frame of the Kinect's field of view
    (the workcell's map as it is), a pool of 4 frames, 8 joint states."""
    cfg, traffic = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg["sensor"].update(width=160, height=120, fx=131.25, fy=131.25, cx=79.5, cy=59.5)
    traffic["frame_pool"] = min(traffic["frame_pool"], 4)
    traffic["trajectory"]["states"] = 8
    return cfg, traffic
