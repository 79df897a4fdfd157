"""Example programs on the card: tests_tpu/test_examples_tpu.py's contracts.

tests/test_torch_examples*.py hold every example program against the
reference's on the CPU; this tier re-runs the reference's hardware subset on
the card, at the reference's parameters, so the programs' facade, collide
counts, EDT cross-check and fitter search run through the CUDA kernels.
"""
import importlib.util
from pathlib import Path

from gpu_voxels_tpu_torch.api import GpuVoxels


def _run(name, card, **kwargs):
    """An example program's main on the card, with the facade's singleton
    fresh before and after."""
    import importlib

    GpuVoxels._instance = None
    try:
        return importlib.import_module(f"gpu_voxels_tpu_torch.examples.{name}").main(device=card, **kwargs)
    finally:
        GpuVoxels._instance = None


def test_collisions_on_cuda(card):
    """tests_tpu/test_examples_tpu.py:25. The facade's collide program."""
    assert _run("collisions", card) > 0


def test_distance_voxel_test_on_cuda(card):
    """tests_tpu/test_examples_tpu.py:30. The PBA / JFA / brute cross-check
    (testing_distance.cu oracle): 0 differences."""
    assert _run("distance_voxel_test", card, dim=64, n_obstacles=100) == 0


def test_octree_bench_on_cuda(card):
    """tests_tpu/test_examples_tpu.py:35."""
    assert _run("octree_bench", card, dim=64, n_points=5_000)


def _card_tests():
    """tests/test_torch_cuda.py, which holds the live loop's contract; it
    imports torch and the port only."""
    path = Path(__file__).resolve().parents[1] / "tests" / "test_torch_cuda.py"
    spec = importlib.util.spec_from_file_location("test_torch_cuda_contracts", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_live_streaming_loop_sustains_30hz(card, tmp_path, monkeypatch):
    """tests_tpu/test_examples_tpu.py:39. The live loop sustains >= 30 Hz with
    the publish on: tests/test_torch_cuda.py's contract, called as it is."""
    _card_tests().test_live_streaming_loop_sustains_30hz(card, tmp_path, monkeypatch)


def test_swept_fitter_on_cuda(card):
    """tests_tpu/test_examples_tpu.py:61. The multi-robot deconfliction search
    finds both valid orderings and a nonzero conflict-free start delay."""
    n_solutions, delay = _run("swept_fitter", card, dims=(96, 96, 96), side=0.04, verbose=False)
    assert n_solutions == 2
    assert delay > 0
