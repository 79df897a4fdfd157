"""The card-only contract tier of the PyTorch port.

`tests/` holds the port against the JAX package on the CPU, where every CUDA
wrapper takes its plain version. This tier re-runs the reference's hardware
contracts (tests_tpu/) on an NVIDIA card, where the hand-written kernels run:
the exact counts at the reference's scale, each kernel against its plain
version on the contract's inputs. Run it on a machine with a card:

    python -m pytest tests_cuda -q

It imports torch and the port only (no JAX, nothing of `tests/`), and the
default `python -m pytest tests/` does not collect it. Every test of this
directory is marked `cuda` and skips where `torch.cuda.is_available()` is
false; a run that collects other directories beside it leaves their items'
marks as they are.
"""
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent


def pytest_collection_modifyitems(config, items):
    for item in items:
        if HERE in Path(str(item.path)).resolve().parents:
            item.add_marker(pytest.mark.cuda)


def pytest_runtest_setup(item):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card-only contract tier")


@pytest.fixture
def card() -> torch.device:
    """The card every map and tensor of a contract lives on."""
    return torch.device("cuda", torch.cuda.current_device())
