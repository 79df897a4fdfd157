"""The example programs of the reference package (`examples/*.py`) on the
PyTorch port: one module per program, of the same name.

Each imports torch, numpy and `gpu_voxels_tpu_torch` only, keeps the
reference program's `main(...)` signature and return value and adds a
`device` argument: the CUDA card unless the caller passes `device="cpu"`.
Nothing runs at import time. Run one as a program with

    python -m gpu_voxels_tpu_torch.examples.<name>

The URDF and binvox models are read in place from the repository's
`examples/models/`.
"""
