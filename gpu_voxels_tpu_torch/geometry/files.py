"""Point-cloud file IO: .xyz, .pcd, .binvox (+ dispatcher).

Equivalents of helpers/{Xyz,Pcd,Binvox}FileReader.cpp and
helpers/PointcloudFileHandler.cpp. Counterpart of
gpu_voxels_tpu/geometry/files.py: its pure-Python/numpy paths (the
reference's optional C++ fast paths are not ported). Readers return host
float32 numpy arrays; the caller moves them to its device.

Model files resolve against $GPU_VOXELS_MODEL_PATH like the reference
(common_defines.h:276-292).
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

def model_path(prepend_env_path: bool = True) -> Path:
    if prepend_env_path:
        env = os.environ.get("GPU_VOXELS_MODEL_PATH")
        if env is None:
            raise FileNotFoundError(
                "The environment variable 'GPU_VOXELS_MODEL_PATH' could not be "
                "read. Did you set it?"
            )
        return Path(env)
    return Path("")


def read_xyz(path) -> np.ndarray:
    """ASCII x y z triples, whitespace separated (XyzFileReader.cpp)."""
    with open(path, "r") as f:
        data = np.array(f.read().split(), dtype=np.float32)
    n = (data.size // 3) * 3
    return data[:n].reshape(-1, 3)


def read_pcd(path) -> np.ndarray:
    """PCD reader: ASCII and binary encodings, x/y/z fields."""
    fields, sizes, types, counts = [], [], [], []
    width = height = points = None
    encoding = "ascii"
    header_len = 0
    with open(path, "rb") as f:
        while True:
            line = f.readline()
            header_len += len(line)
            text = line.decode("latin1").strip()
            if text.startswith("#") or not text:
                continue
            key, _, rest = text.partition(" ")
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(v) for v in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(v) for v in rest.split()]
            elif key == "WIDTH":
                width = int(rest)
            elif key == "HEIGHT":
                height = int(rest)
            elif key == "POINTS":
                points = int(rest)
            elif key == "DATA":
                encoding = rest.strip()
                break
        if points is None:
            points = (width or 0) * (height or 1)
        if not counts:
            counts = [1] * len(fields)
        if encoding == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=points)
            data = np.atleast_2d(data)
        elif encoding == "binary":
            np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 1): "<i1", ("I", 2): "<i2",
                        ("I", 4): "<i4", ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}
            dt = np.dtype([
                (name if cnt == 1 else f"{name}", np_types[(t, s)], (cnt,) if cnt > 1 else ())
                for name, s, t, cnt in zip(fields, sizes, types, counts)
            ])
            raw = np.frombuffer(f.read(dt.itemsize * points), dtype=dt, count=points)
            cols = [raw[name].astype(np.float32).reshape(points, -1)[:, 0] for name in ("x", "y", "z")]
            return np.stack(cols, axis=1)
        else:
            raise ValueError(f"PCD encoding '{encoding}' not supported")
    idx = [fields.index(k) for k in ("x", "y", "z")]
    # column offsets accounting for COUNT>1 fields
    offs = np.concatenate([[0], np.cumsum(counts)])
    return np.stack([data[:, offs[i]] for i in idx], axis=1).astype(np.float32)


def read_binvox(path) -> np.ndarray:
    """Binvox RLE voxel grid -> cloud of occupied voxel positions.

    Exact port of BinvoxFileReader.cpp:30-140 including its axis convention:
    the grid index order is [x over depth][z over height][y over width] and
    the emitted point is scale*(x, y, z) + translate with scale = scale/width.
    """
    with open(path, "rb") as f:
        blob = f.read()
    nl = blob.index(b"\n")
    first = blob[:nl].split()
    if not first or first[0] != b"#binvox":
        raise ValueError(f"Binvox: first line reads [{first}] instead of [#binvox]")
    pos = nl + 1
    depth = height = width = None
    tx = ty = tz = 0.0
    scale = 1.0
    while True:
        nl = blob.index(b"\n", pos)
        line = blob[pos:nl].split()
        pos = nl + 1
        if not line:
            continue
        if line[0] == b"data":
            break
        if line[0] == b"dim":
            depth, height, width = int(line[1]), int(line[2]), int(line[3])
        elif line[0] == b"translate":
            tx, ty, tz = float(line[1]), float(line[2]), float(line[3])
        elif line[0] == b"scale":
            scale = float(line[1])
    if depth is None:
        raise ValueError("Binvox: missing dimensions in header")
    scale = scale / width  # BinvoxFileReader.cpp:67
    size = width * height * depth
    rle = np.frombuffer(blob[pos:], dtype=np.uint8)
    values = rle[0::2].astype(np.int64)
    counts = rle[1::2].astype(np.int64)
    total = np.cumsum(counts)
    stop = np.searchsorted(total, size, side="left")
    values, counts = values[: stop + 1], counts[: stop + 1]
    if counts.size:
        counts[-1] = size - (total[stop - 1] if stop > 0 else 0)
    voxels = np.repeat(values, counts).astype(np.uint8)
    grid = voxels.reshape(depth, height, width)  # [x][z][y] per reference
    x, z, y = np.nonzero(grid == 1)
    pts = np.stack([x, y, z], axis=1).astype(np.float32)
    return pts * np.float32(scale) + np.array([tx, ty, tz], dtype=np.float32)


def load_point_cloud(
    path,
    use_model_path: bool = False,
    shift_to_zero: bool = False,
    offset_xyz=(0.0, 0.0, 0.0),
    scaling: float = 1.0,
) -> np.ndarray:
    """PointcloudFileHandler::loadPointCloud (PointcloudFileHandler.cpp:55-120).

    Dispatches on the file name containing 'xyz' / 'pcd' / 'binvox' (matching
    the reference's substring test), optionally shifts the cloud minimum to
    zero, then applies `scaling * p + offset_xyz`.
    """
    p = str(path)
    if use_model_path:
        p = str(model_path(True) / p)
    name = p
    if "xyz" in name:
        pts = read_xyz(p)
    elif "pcd" in name:
        pts = read_pcd(p)
    elif "binvox" in name:
        pts = read_binvox(p)
    else:
        raise ValueError(f"{p} has no known file format.")
    if shift_to_zero and len(pts):
        pts = pts - pts.min(axis=0)
    # scaling may be a scalar or a per-axis 3-vector (URDF mesh scales)
    return (np.asarray(scaling, dtype=np.float32) * pts + np.asarray(offset_xyz, dtype=np.float32)).astype(np.float32)


def load_point_clouds(
    paths,
    use_model_path: bool = False,
    shift_to_zero: bool = False,
    offset_xyz=(0.0, 0.0, 0.0),
    scaling=1.0,
    max_workers: int | None = None,
    scalings=None,
    reader=None,
):
    """Threaded batch loader: load_point_cloud over many files in parallel.

    The reference loads robot meshes one .binvox per link serially
    (robot_link.cpp:226); here the batch decodes in a thread pool. Order of the
    returned list matches `paths`. `scaling` applies to every path (scalar or
    per-axis 3-vector); `scalings` instead gives one scale per path (each a
    scalar or 3-vector — URDF links carry individual mesh scales).

    `reader` overrides the format dispatch with an explicit path -> [N,3]
    loader (e.g. read_binvox). The default dispatch faithfully reproduces the
    reference's bare-substring test on the WHOLE path
    (PointcloudFileHandler.cpp:82-110: a path containing 'xyz' anywhere
    parses as xyz) — callers who already know the format, like the URDF
    mesh loader (robot_link.cpp:226 reads binvox directly), must not rely
    on it."""
    paths = list(paths)
    if not paths:
        return []
    scales = list(scalings) if scalings is not None else [scaling] * len(paths)
    if len(scales) != len(paths):
        raise ValueError(f"{len(scales)} scalings for {len(paths)} paths")

    if reader is None:
        def _one(p, s):
            return load_point_cloud(p, use_model_path, shift_to_zero, offset_xyz, s)
    else:
        def _one(p, s):
            pp = str(model_path(True) / p) if use_model_path else str(p)
            pts = reader(pp)
            if shift_to_zero and len(pts):
                pts = pts - pts.min(axis=0)
            return (
                np.asarray(s, dtype=np.float32) * pts
                + np.asarray(offset_xyz, dtype=np.float32)
            ).astype(np.float32)

    from concurrent.futures import ThreadPoolExecutor

    if max_workers is None:
        max_workers = min(len(paths), os.cpu_count() or 4)
    if max_workers <= 1 or len(paths) == 1:
        return [_one(p, s) for p, s in zip(paths, scales)]
    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(lambda ps: _one(*ps), zip(paths, scales)))


def center_point_cloud(points: np.ndarray) -> np.ndarray:
    """PointcloudFileHandler::centerPointCloud: center on bbox midpoint."""
    mid = (points.min(axis=0) + points.max(axis=0)) / 2.0
    return (points - mid).astype(np.float32)


def write_xyz(path, points) -> None:
    np.savetxt(path, np.asarray(points, dtype=np.float32), fmt="%.6f")
