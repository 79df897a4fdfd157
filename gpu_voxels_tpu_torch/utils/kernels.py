"""Build and load the port's CUDA kernels (`csrc/*.cu`).

nvcc compiles every source under csrc/ (one nvcc process per source, all
started together) and links the objects into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use, from the
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

# -fmad=false: the carves (carve_projection.cuh) must round every product and sum
# on its own, as the plain torch version does, to stay bit-identical; IEEE
# division is nvcc's default (no --use_fast_math) and is kept explicit.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xcompiler", "-fPIC",
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
    # (a, b, out or NULL, n, margin, occ_a, occ_b, b_valid (each or NULL),
    #  workspace, workspace words, count, meanings, stream)
    "gv_collide_types_bit_bit": (_P, _P, _P, _I64, _I32, _P, _P, _P, _P, _I64, _P, _P, _P),
    # (out: int64 on the host)
    "gv_collide_types_workspace_words": (_P,),
    # (a, b, n, a_start, b_start, len, count, stream)
    "gv_count_bit_bit": (_P, _P, _I64, _I64, _I64, _I64, _P, _P),
    # (depth, h, w, pose, fx, fy, cx, cy, side, eps, invalid, dx, dy, dz, z0, out, stream)
    "gv_carve_exact": (
        _P, _I32, _I32, _P, _F32, _F32, _F32, _F32, _F32, _F32, _F32,
        _I32, _I32, _I32, _I32, _P, _P,
    ),
    # (pm, ph, pw, pool, h, w, pose, fx, fy, cx, cy, side, eps, dx, dy, dz, z0, out, stream)
    "gv_carve_pooled": (
        _P, _I32, _I32, _I32, _I32, _I32, _P, _F32, _F32, _F32, _F32, _F32, _F32,
        _I32, _I32, _I32, _I32, _P, _P,
    ),
    # (depth, h, w, pool, invalid, out, stream)
    "gv_min_pool_depth": (_P, _I32, _I32, _I32, _F32, _P, _P),
    # (g, pay, out_d, out_pay, A, n, C, stream)
    "gv_envelope_pass": (_P, _P, _P, _P, _I64, _I32, _I64, _P),
    # (n, C, out: int[5] on the host)
    "gv_envelope_occupancy": (_I32, _I64, _P),
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


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; wait for all, then raise on the first failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    results = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, results):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = []
        compiles = []
        for src in _sources():
            if src.suffix == ".cu":
                objs.append(str(Path(tmp) / f"{src.stem}.o"))
                compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", objs[-1], str(src)])
        _run_all(compiles)
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
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
