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

Every kernel of the port passes this one seam: its C entry point is declared
in `SIGNATURES`, its wrapper checks its inputs with `check_input` and
launches it with `launch`, which counts it in `launches` under the entry
point's name. A wrapper takes its plain version's signature and returns the
plain version on CPU tensors; the kernels are checked against their plain
versions on the card by the `cuda`-marked tests.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

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
    # (values or NULL, host values (T = 1, on the host) or NULL, params, joint_types,
    #  cloud_link, point_cloud, points, out, T, L, C, P, stream)
    "gv_dh_fk_points": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _P),
    # (values or NULL, host values or NULL, params, joint_types, cloud_link, out, T, L, C, stream)
    "gv_dh_chain": (_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _P),
    # (depth, h, w, pose or NULL, host pose (4 x 4 on the host) or NULL, fx, fy, cx, cy, invalid, recip,
    #  dx, dy, dz, z0, counts, stream)
    "gv_depth_hits": (
        _P, _I32, _I32, _P, _P, _F32, _F32, _F32, _F32, _F32, _F32, _I32, _I32, _I32, _I32, _P, _P,
    ),
    # (data, counts, free, robot mask or NULL, out, n, stream)
    "gv_log_odds_update": (_P, _P, _P, _P, _P, _I64, _P),
    # (packed, g1, pay1, dx, dy, dz, stream)
    "gv_flood_z": (_P, _P, _P, _I32, _I32, _I32, _P),
    # (packed, prob, out, n, dx, dy, z0, threshold, stream)
    "gv_merge_occupied": (_P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P),
    # (points, n, recip, side, packed, dx, dy, dz, out, stream)
    "gv_min_distance_to": (_P, _I64, _F32, _F32, _P, _I32, _I32, _I32, _P, _P),
}

# the entry points that run on the host and take no stream; `launch` calls every other one
HOST_QUERIES = ("gv_collide_types_workspace_words", "gv_envelope_occupancy")
# kernel launches since the last reset, by entry point
launches = {name: 0 for name in SIGNATURES if name not in HOST_QUERIES}

_lib: ctypes.CDLL | None = None
_entries: dict = {}  # entry point -> its bound function, resolved when the library loads


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
            if name in launches:
                _entries[name] = fn
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def launch(name: str, device: torch.device, *args, stream: int | None = None) -> None:
    """Call entry point `name` with `args` and the current stream of `device`
    as its last argument, under a guard of that device; raise on a CUDA
    error, and count the launch. Nothing waits for the device. A caller that
    has read the current stream already (K4 keys its workspace by it) passes
    it as `stream`."""
    if not _entries:
        library()
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _entries[name](*args, stream)
    check(err, name)
    launches[name] += 1


def check_input(t: torch.Tensor, name: str, dtype, shape: tuple, device: torch.device,
                dtype_error: type = ValueError) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` (or of one of a
    tuple of dtypes), of `shape` (an int per dimension, or a name for one of
    any extent), on `device`. Another dtype raises `dtype_error`; anything
    else ValueError."""
    if t.dtype is not dtype and (type(dtype) is not tuple or t.dtype not in dtype):
        raise dtype_error(_wanted(t, name, dtype, shape))
    got = t.shape
    if got != shape:
        if len(got) != len(shape):
            raise ValueError(_wanted(t, name, dtype, shape))
        for want, n in zip(shape, got):
            if type(want) is not str and want != n:
                raise ValueError(_wanted(t, name, dtype, shape))
    if not t.is_contiguous():
        raise ValueError(_wanted(t, name, dtype, shape))
    if t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")


def _wanted(t: torch.Tensor, name: str, dtype, shape: tuple) -> str:
    kind = " or ".join(map(str, dtype)) if type(dtype) is tuple else str(dtype)
    return f"{name} must be a contiguous {kind} [{', '.join(map(str, shape))}] tensor, got {t.dtype} {list(t.shape)}"
