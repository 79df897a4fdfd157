"""The distance field's kernels beside K5 on the CPU: the obstacle merge,
PBA phase 1's Z flood and the clearance query (ops/edt_cuda.py
`merge_occupied`, `flood_z` and `min_distance_to`; on a card one kernel
launch each, csrc/edt_phase1.cu and csrc/distance_query.cu).

On CPU tensors the wrappers return their plain versions, which are held
here against the reference (gpu_voxels_tpu) and against the composition the
map methods used before; each refuses an input of another dtype or shape on
either device. The kernels' integer and float32 arithmetic is modelled in
numpy (the flood's 32-z words of site bits with their leading-zero and
first-set-bit scans; the merge's 4-voxel quads stepping x, y, z from each
quad's first voxel; the query's voxelization, gather and least distance)
and held against the specs. The kernels themselves are checked on a card by
tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from gpu_voxels_tpu.maps.distance_map import DistanceVoxelMap as JDist
from gpu_voxels_tpu.maps.voxelmap import ProbVoxelMap as JProb
from gpu_voxels_tpu.ops import edt_envelope as jenv
from gpu_voxels_tpu_torch.constants import PBA_UNINITIALISED_PACKED, float_to_probability
from gpu_voxels_tpu_torch.maps.distance_map import DistanceVoxelMap
from gpu_voxels_tpu_torch.maps.voxelmap import ProbVoxelMap
from gpu_voxels_tpu_torch.ops import edt, edt_cuda, edt_envelope
from gpu_voxels_tpu_torch.utils import kernels

MISS = edt_envelope.MISS
NAMES = ("gv_flood_z", "gv_merge_occupied", "gv_min_distance_to")
DIMS = {"odd": (37, 19, 53), "column": (1, 1, 1023), "x1024": (1024, 2, 5), "small": (16, 12, 40)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def no_library(monkeypatch):
    """CPU tensors must neither load the kernel library nor count a launch."""
    def refuse():
        raise AssertionError("CPU tensors must not load the kernel library")

    monkeypatch.setattr(kernels, "library", refuse)
    before = {k: kernels.launches[k] for k in NAMES}
    yield
    assert {k: kernels.launches[k] for k in NAMES} == before


def grid(kind, dims, seed=0):
    """A packed int32[N] grid (tests/test_torch_cuda.py `_phase1_grid`'s
    kinds, from a numpy seed)."""
    dx, dy, dz = dims
    n = dx * dy * dz
    rng = np.random.default_rng(seed + n)
    mask = np.zeros((dz, dy, dx), bool)
    if kind in ("random", "edt"):
        mask = rng.random((dz, dy, dx)) < (0.05 if kind == "random" else 0.01)
        mask.reshape(-1)[n // 2] = True
    elif kind == "full":
        mask[:] = True
    elif kind == "ends":
        mask[0] = mask[-1] = True
    elif kind == "ties":
        mask[2::4] = True
    packed = edt.init_from_obstacle_mask(torch.from_numpy(mask.reshape(-1)), dims)
    if kind == "random":
        other = torch.from_numpy(rng.integers(0, 2**30, n).astype(np.int32))
        packed = torch.where(torch.from_numpy(~mask.reshape(-1) & (rng.random(n) < 0.3)), other, packed)
    if kind == "edt":
        packed = edt_envelope.parallel_banding(packed, dims)
    return packed


def flood_model(packed: np.ndarray, dims):
    """The Z flood kernel's arithmetic: per column, 32-z words of site bits;
    `down` the highest set bit at or below z (a leading-zero count on the
    word's bits 0..b, else on the nearest non-empty word below), `up` the
    lowest at or above it (a find-first-set on the word shifted right by b,
    else on the nearest non-empty word above); near = dd <= du ? down : up."""
    dx, dy, dz = dims
    v = packed.reshape(dz, dy, dx).astype(np.int64)
    x = np.arange(dx).reshape(1, 1, dx)
    y = np.arange(dy).reshape(1, dy, 1)
    z = np.arange(dz).reshape(dz, 1, 1)
    site = (v == (x | (y << 10) | (z << 20))) & (x != 1023)
    words = (dz + 31) // 32
    bits = np.zeros((words, dy, dx), np.uint64)
    for zz in range(dz):
        bits[zz // 32] |= site[zz].astype(np.uint64) << np.uint64(zz % 32)
    g1 = np.empty((dz, dy, dx), np.int64)
    near = np.empty((dz, dy, dx), np.int64)

    def highest(w):  # 31 - clz, or -1
        return np.where(w != 0, np.floor(np.log2(np.maximum(w, 1).astype(np.float64))).astype(np.int64), -1)

    def lowest(w):  # ffs - 1, or -1
        return np.where(w != 0, highest(w & (~w + np.uint64(1)) & np.uint64(0xFFFFFFFF)), -1)

    for w in range(words):
        below = np.full((dy, dx), -1, np.int64)
        for k in range(w - 1, -1, -1):
            below = np.where(below < 0, np.where(bits[k] != 0, 32 * k + highest(bits[k]), -1), below)
        above = np.full((dy, dx), -1, np.int64)
        for k in range(w + 1, words):
            above = np.where(above < 0, np.where(bits[k] != 0, 32 * k + lowest(bits[k]), -1), above)
        for b in range(min(32, dz - 32 * w)):
            zz = 32 * w + b
            le = bits[w] & np.uint64((1 << (b + 1)) - 1)
            ge = bits[w] >> np.uint64(b)
            down = np.where(le != 0, 32 * w + highest(le), below)
            up = np.where(ge != 0, zz + lowest(ge), above)
            dd = np.where(down >= 0, (zz - down) ** 2, MISS)
            du = np.where(up >= 0, (up - zz) ** 2, MISS)
            g1[zz] = np.minimum(dd, du)
            near[zz] = np.where(dd <= du, down, up)
    near = np.where(near < 0, 1023, near)
    return g1.astype(np.int32), (x | (y << 10) | (near << 20)).astype(np.int32)


def merge_model(packed: np.ndarray, prob: np.ndarray, threshold: int, dims, z0: int) -> np.ndarray:
    """The merge kernel's arithmetic: quads of 4 voxels, x, y, z found once
    from the quad's first voxel and stepped with wrap-around, the last n % 4
    voxels one by one; coordinates packed as uint32."""
    dx, dy, _ = dims
    n = packed.size
    out = packed.copy()
    for i0 in range(0, n, 4):
        row = i0 // dx
        x, y, z = i0 - row * dx, row % dy, row // dy + z0
        for i in range(i0, min(i0 + 4, n)):
            if int(prob[i]) >= threshold:
                out[i] = np.array((x | (y << 10) | (z << 20)) & 0xFFFFFFFF, np.uint32).view(np.int32)
            x += 1
            if x == dx:
                x, y = 0, y + 1
                if y == dy:
                    y, z = 0, z + 1
    return out


@pytest.mark.parametrize("kind", ["random", "empty", "full", "ends", "ties", "edt"])
def test_flood_z_on_the_cpu_takes_the_plain_path_and_matches_the_reference(kind, no_library):
    """The wrapper returns flood_z_plain on CPU tensors; the spec equals the
    reference's Z scans (gpu_voxels_tpu/ops/edt_envelope.py `_nearest_scan`,
    two lax.scans) on every column kind, ties and an EDT's result
    included."""
    dims = DIMS["odd"]
    packed = grid(kind, dims)
    g1, pay1 = edt_cuda.flood_z(packed, dims)
    want_g1, want_pay1 = edt_cuda.flood_z_plain(packed, dims)
    assert torch.equal(g1, want_g1) and torch.equal(pay1, want_pay1)
    assert torch.equal(edt_envelope.flood_z(packed, dims)[1], want_pay1)
    dx, dy, dz = dims
    ox, oy, oz = edt.unpack(packed.reshape(dz, dy, dx))
    x, y, z = edt._position_grids(dims, "cpu")
    site = ((ox == x) & (oy == y) & (oz == z) & (ox != 1023)).numpy()
    ref_g1, ref_near = jenv._nearest_scan(site, dz)
    ref_pay1 = (x | (y << 10) | (torch.from_numpy(np.array(ref_near)).clamp(0, 1023) << 20)).numpy()
    assert np.array_equal(np.asarray(ref_g1), g1.numpy()) and np.array_equal(ref_pay1, pay1.numpy())
    assert np.array_equal(site, (g1 == 0).numpy())
    if kind == "empty":
        assert bool((g1 == MISS).all()) and bool(((pay1 >> 20) == 1023).all())


@pytest.mark.parametrize("shape", sorted(DIMS))
@pytest.mark.parametrize("kind", ["random", "ties", "ends", "edt"])
def test_flood_kernel_arithmetic_matches_spec(shape, kind):
    """The numpy model of the Z flood kernel equals flood_z_plain byte for
    byte: dims off the 32-column tile and the 32-z word, one 1023-long
    column, a 1024-wide grid (x = 1023 is never a site), ties, sites at both
    ends, an EDT's result."""
    dims = DIMS[shape]
    if kind == "edt" and shape in ("column", "x1024"):
        dims = DIMS["small"]
    packed = grid(kind, dims, seed=7)
    g1, pay1 = flood_model(packed.numpy(), dims)
    want_g1, want_pay1 = edt_cuda.flood_z_plain(packed, dims)
    assert np.array_equal(g1, want_g1.numpy()) and np.array_equal(pay1, want_pay1.numpy()), (shape, kind)


@pytest.mark.parametrize("z0", [0, 7, 300])
def test_merge_on_the_cpu_takes_the_plain_path_and_matches_the_old_composition(z0, no_library):
    """The wrapper returns merge_occupied_plain on CPU tensors, equal to the
    map method's former composition (`with_obstacles` of the log-odds at or
    above the threshold) and to the kernel's numpy model, at thresholds at
    and past the int8 extremes; a 1-element-off view gives the same."""
    dims = DIMS["odd"]
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(z0)
    prob = torch.from_numpy(rng.integers(-128, 128, n + 1).astype(np.int8))[1:]
    prob[:4] = torch.tensor([-128, -127, 127, 0], dtype=torch.int8)
    packed = torch.from_numpy(rng.integers(0, 2**30, n).astype(np.int32))
    for threshold in (-129, -128, -127, 0, float_to_probability(0.6), 127, 128):
        got = edt_cuda.merge_occupied(packed, prob, threshold, dims, z0)
        want = edt.with_obstacles(packed, prob.to(torch.int32) >= threshold, dims, z0)
        assert torch.equal(got, want) and torch.equal(edt_cuda.merge_occupied_plain(packed, prob, threshold, dims, z0),
                                                      want), threshold
        assert np.array_equal(merge_model(packed.numpy(), prob.numpy(), threshold, dims, z0), want.numpy()), threshold
    assert torch.equal(edt_cuda.merge_occupied(packed, prob, 128, dims, z0), packed)


def test_distance_map_merge_matches_the_reference_on_the_cpu(no_library):
    """DistanceVoxelMap.merge_occupied through the wrapper equals the
    reference's mergeOccupied (gpu_voxels_tpu/maps/distance_map.py) and the
    EDT after it equals the reference's parallel_banding, on a CPU map."""
    dims = (20, 18, 24)
    n = dims[0] * dims[1] * dims[2]
    data = np.random.default_rng(11).integers(-128, 128, n).astype(np.int8)
    data[np.random.default_rng(12).random(n) < 0.95] = -100
    for t in (0.6, 0.0, 1.0):
        got = DistanceVoxelMap.create(dims, 0.05, device="cpu").merge_occupied(
            ProbVoxelMap(torch.from_numpy(data), dims, 0.05), t)
        want = JDist.create(dims, 0.05).merge_occupied(JProb(data, dims, 0.05), t)
        assert np.array_equal(got.data.numpy(), np.asarray(want.data)), t
        assert np.array_equal(got.parallel_banding().data.numpy(), np.asarray(want.parallel_banding().data)), t
    empty = DistanceVoxelMap.create(dims, 0.05, device="cpu").merge_occupied(
        ProbVoxelMap(torch.full((n,), -100, dtype=torch.int8), dims, 0.05))
    assert bool((empty.data == PBA_UNINITIALISED_PACKED).all())


def query_model(packed: np.ndarray, points: np.ndarray, side: float, dims) -> np.float32:
    """The query kernel's arithmetic: c = floor(p * f32(1 / side)) in
    float32, clamped to +-2^30 and NaN -> 0; points outside the grid and
    sites with a field of 1023 skipped; the least squared distance in int;
    side * sqrt(float32(least)), each rounded in float32."""
    dx, dy, dz = dims
    recip = np.float32(1.0 / side)
    with np.errstate(invalid="ignore", over="ignore"):
        f = np.floor(points.astype(np.float32) * recip)
    c = np.where(np.isnan(f), 0, np.clip(f, -(2.0**30), 2.0**30)).astype(np.int64)
    inside = ((c >= 0) & (c < np.array([dx, dy, dz]))).all(axis=1)
    c = c[inside]
    v = packed[(c[:, 2] * dy + c[:, 1]) * dx + c[:, 0]].astype(np.int64)
    site = np.stack([v & 0x3FF, (v >> 10) & 0x3FF, v >> 20], axis=1)
    d = ((c - site) ** 2).sum(axis=1)[(site != 1023).all(axis=1)]
    least = np.float32(d.min() if d.size else 2**31 - 1)
    return np.float32(np.sqrt(least, dtype=np.float32) * np.float32(side))


def query_scene(kind, dims=(37, 19, 53), side=0.01, seed=0):
    """A field of `dims` (few obstacles: most voxels hold a far site) and
    float32 [P, 3] query points: "free" (in the map's free space), "edge"
    (a tenth outside the map, NaN and inf coordinates), "outside" (none
    inside) or "one" (a single point)."""
    n = dims[0] * dims[1] * dims[2]
    rng = np.random.default_rng(seed + n)
    mask = rng.random(n) < 0.0005
    mask[n // 3] = True
    field = edt_envelope.parallel_banding(edt.init_from_obstacle_mask(torch.from_numpy(mask), dims), dims)
    ext = np.array(dims) * side
    lo, hi = (-0.1 * ext, 1.1 * ext) if kind == "edge" else (0 * ext, ext)
    pts = rng.uniform(lo, hi, (1 if kind == "one" else 3800, 3)).astype(np.float32)
    if kind == "edge":
        pts[:3] = [[np.nan, 0.1, 0.1], [np.inf, 0.1, 0.1], [-np.inf, 0.1, 0.1]]
    if kind == "outside":
        pts += np.float32(2 * ext.max())
    return field, torch.from_numpy(pts)


@pytest.mark.parametrize("kind", ["free", "edge", "outside", "one"])
def test_query_on_the_cpu_takes_the_plain_path_and_matches_the_reference(kind, no_library):
    """The query wrapper returns min_distance_to_plain on CPU tensors, equal
    to the map method's former composition, to the kernel's numpy model and
    to the reference's min_distance_to on the same field, bit for bit."""
    from gpu_voxels_tpu_torch.ops import insert as insert_ops

    dims, side = (37, 19, 53), 0.01
    field, pts = query_scene(kind, dims, side)
    got = edt_cuda.min_distance_to(field, pts, side, dims)
    idx, _ = insert_ops.voxelize(pts, side, dims)
    former = torch.sqrt(edt.min_squared_distance_at(field, idx, dims).to(torch.float32)) * side
    assert got.dtype == torch.float32 and got.shape == () and torch.equal(got, former)
    assert torch.equal(edt_cuda.min_distance_to_plain(field, pts, side, dims), former)
    assert np.float32(got) == query_model(field.numpy(), pts.numpy(), side, dims)
    want = JDist(field.numpy(), dims, side).min_distance_to(pts.numpy())
    assert float(got) == float(want)
    mine = DistanceVoxelMap(field, dims, side).min_distance_to(pts.numpy())
    assert torch.equal(mine, former) and (kind != "outside" or float(got) > 4e2)


@pytest.mark.parametrize("case", ["flood-dtype", "flood-shape", "flood-strided", "merge-dtype", "merge-prob-dtype",
                                  "merge-shape", "merge-prob-shape", "merge-strided", "query-dtype",
                                  "query-shape", "query-empty", "query-packed"])
def test_phase1_wrappers_refuse_other_dtypes_and_shapes_on_the_cpu(case, no_library):
    dims = (8, 4, 4)
    packed = torch.zeros(128, dtype=torch.int32)
    prob = torch.zeros(128, dtype=torch.int8)
    calls = {
        "flood-dtype": (TypeError, lambda: edt_cuda.flood_z(packed.to(torch.int64), dims)),
        "flood-shape": (ValueError, lambda: edt_cuda.flood_z(packed.reshape(4, 4, 8), dims)),
        "flood-strided": (ValueError, lambda: edt_cuda.flood_z(torch.zeros(256, dtype=torch.int32)[::2], dims)),
        "merge-dtype": (TypeError, lambda: edt_cuda.merge_occupied(packed.to(torch.int64), prob, 0, dims)),
        "merge-prob-dtype": (TypeError, lambda: edt_cuda.merge_occupied(packed, prob.to(torch.int32), 0, dims)),
        "merge-shape": (ValueError, lambda: edt_cuda.merge_occupied(packed[:64], prob, 0, dims)),
        "merge-prob-shape": (ValueError, lambda: edt_cuda.merge_occupied(packed, prob[:100], 0, dims)),
        "merge-strided": (ValueError, lambda: edt_cuda.merge_occupied(
            packed, torch.zeros(256, dtype=torch.int8)[::2], 0, dims)),
    }
    points = torch.zeros((5, 3), dtype=torch.float32)
    calls.update({
        "query-dtype": (TypeError, lambda: edt_cuda.min_distance_to(packed, points.double(), 1.0, dims)),
        "query-shape": (ValueError, lambda: edt_cuda.min_distance_to(packed, points[:, :2].contiguous(), 1.0, dims)),
        "query-empty": (ValueError, lambda: edt_cuda.min_distance_to(packed, points[:0], 1.0, dims)),
        "query-packed": (ValueError, lambda: edt_cuda.min_distance_to(packed[:64], points, 1.0, dims)),
    })
    error, call = calls[case]
    with pytest.raises(error, match="must be|at least one"):
        call()
