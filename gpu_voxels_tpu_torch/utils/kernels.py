"""Build and load the port's CUDA kernels (`csrc/*.cu`).

nvcc compiles every source under csrc/ into one shared library with a plain
C interface, loaded with ctypes. The build runs at first use, from the
package's own sources only, into `_build/` beside this package (listed in
.gitignore), keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one loads at once. The library is written
to a temporary file and renamed into place, so two processes building at
the same time cannot load a half-written file. A failed build raises with
nvcc's output; nothing falls back to the plain torch versions.

    python -c "from gpu_voxels_tpu_torch.utils import kernels; print(kernels.build())"

builds on a machine with the CUDA toolkit and prints the library's path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false: the carve (carve_exact.cu) must round every product and sum
# on its own, as the plain torch version does, to stay bit-identical; IEEE
# division is nvcc's default (no --use_fast_math) and is kept explicit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# C signatures of csrc/*.cu: every function returns a cudaError_t (0 = ok)
SIGNATURES = {
    # (a, b, n, t1, t2, count, stream)
    "gv_count_prob_prob": (_P, _P, _I64, _I32, _I32, _P, _P),
    # (a, b, out, n_total, a_start, len, t1, t2, count, stream)
    "gv_count_and_mark_prob": (_P, _P, _P, _I64, _I64, _I64, _I32, _I32, _P, _P),
    # (depth, h, w, pose, fx, fy, cx, cy, side, eps, invalid, dx, dy, dz, out, stream)
    "gv_carve_exact": (
        _P, _I32, _I32, _P, _F32, _F32, _F32, _F32, _F32, _F32, _F32,
        _I32, _I32, _I32, _P, _P,
    ),
}

_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgvtorch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *[str(s) for s in _sources() if s.suffix == ".cu"]]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")
