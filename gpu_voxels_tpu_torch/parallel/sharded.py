"""Multi-device scaling: the voxel grid as z-slabs over a device grid.

Counterpart of gpu_voxels_tpu/parallel/sharded.py. The dense grid's flat
layout is z-major (index = z*dimx*dimy + y*dimx + x), so cutting the Z axis
into equal slabs gives contiguous per-device pieces:

  * insert: point clouds are replicated (small); each slab voxelizes them in
    the global frame, shifts the z index by its first row as an integer and
    scatters its own cells (the others go to a dropped slot, H2);
  * collide / count: local work per slab, then one sum;
  * the sensor cycle's carve takes the slab's z offset (kernel K3).

One process drives the whole grid, holding one tensor per slab on that
slab's device (`GridMesh`). The reference's collectives become explicit
moves: its psum is a sum of the per-slab 0-d int64 counts on the grid's
first device, its all_gather a `torch.cat` of `.to(device)` copies, its
ppermute a neighbour's boundary rows moved with `.to(device)`. No
torch.distributed process group is used: one card may hold every slab.

On CUDA devices each slab's count is a kernel launch: K1
(collide_cuda.count_prob_prob) for the prob cycle, the sensor cycle and
`sharded_collide_count`, K7 (count_bit_bit) for the bit cycle, and the
sensor cycle's carve is K3 (raycast_cuda.projective_free_space_exact) with
the slab's `z_index_offset`. On CPU devices the same wrappers take their
plain versions. The reference sums counts in uint32; the sums here are
int64, equal below 2^32.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..constants import UNKNOWN_PROBABILITY, BitVoxelMeaning, float_to_probability
from ..ops import collide_cuda
from ..ops import insert as insert_ops
from ..utils import to_device

Dims = Tuple[int, int, int]
F32 = torch.float32


def as_device(d) -> torch.device:
    """`d` as a torch.device with an explicit index on CUDA, so that device
    comparisons with a tensor's `.device` hold."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def visible_devices() -> list:
    """Every visible CUDA device; raises where there is none (a CPU grid
    names its devices: `devices=["cpu"] * n`)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass devices=['cpu'] * n for a grid on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


class GridMesh:
    """A ('world', 'z') grid of torch devices: the counterpart of the
    reference's `jax.sharding.Mesh`. `devices` is a numpy object array of
    shape (world, z); `shape` is {"world": w, "z": nz}. Row w holds the z
    slabs of scene w, slab k on `devices[w, k]`. Several slabs may share a
    device."""

    def __init__(self, devices):
        src = np.array(devices, dtype=object)
        grid = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            grid[idx] = as_device(src[idx])
        if grid.ndim == 1:
            grid = grid.reshape(1, -1)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a grid mesh is a non-empty (world, z) grid of devices, got shape {grid.shape}")
        self.devices = grid

    @property
    def shape(self) -> dict:
        w, nz = self.devices.shape
        return {"world": w, "z": nz}

    def z_devices(self, world: int = 0) -> list:
        """The devices of row `world`'s slabs, slab 0 first."""
        return list(self.devices[world])

    @property
    def first(self) -> torch.device:
        """The device every sum over slabs lands on."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"GridMesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def make_grid_mesh(n_devices: int, world: int = 1, devices: Sequence | None = None) -> GridMesh:
    """Mesh over ('world', 'z'): scene batch x spatial slabs, n_devices
    logical shards in all. By default it takes the visible CUDA devices and
    maps the shards onto them round-robin, so on one card every slab sits on
    that card (`cuda:0`). `devices` names them instead (shards past its
    length wrap round-robin too): the tests pass `["cpu"] * 8`, the
    counterpart of the reference's 8-device virtual CPU mesh."""
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"{n_devices} shards do not split into {world} worlds")
    pool = list(devices) if devices is not None else visible_devices()
    if not pool:
        raise ValueError("need at least one device")
    flat = [pool[i % len(pool)] for i in range(n_devices)]
    grid = np.empty((world, n_devices // world), dtype=object)
    for i, d in enumerate(flat):
        grid[i // grid.shape[1], i % grid.shape[1]] = d
    return GridMesh(grid)


# -- the collectives as moves ---------------------------------------------------
def psum(parts, device) -> torch.Tensor:
    """Sum of per-slab tensors on `device` (the reference's psum)."""
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def split_slabs(x, devices, axis: int = -1) -> list:
    """`x` cut into len(devices) equal slabs along `axis`, slab k moved to
    devices[k] (views where it already lies there). A list or tuple is taken
    as slabs already, each moved to its device."""
    n = len(devices)
    if isinstance(x, (list, tuple)):
        if len(x) != n:
            raise ValueError(f"{len(x)} slabs for {n} devices")
        return [p.to(d) for p, d in zip(x, devices)]
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.shape[axis] % n:
        raise ValueError(f"extent {t.shape[axis]} does not divide over {n} slabs")
    return [p.to(d) for p, d in zip(torch.chunk(t, n, dim=axis), devices)]


def gather_rows(slabs, lo: int, hi: int, device, fill) -> torch.Tensor:
    """Global rows [lo, hi) of a grid held as equal [zl, ...] z-slabs, on
    `device`: the rows of every slab they cover (the reference's ppermute
    of halo rows, as moves), `fill` rows outside the grid."""
    zl = slabs[0].shape[0]
    tail = tuple(slabs[0].shape[1:])
    parts = []
    if lo < 0:
        parts.append(torch.full((min(hi, 0) - lo,) + tail, fill, dtype=slabs[0].dtype, device=device))
    for k, part in enumerate(slabs):
        a, b = max(lo, k * zl), min(hi, (k + 1) * zl)
        if a < b:
            parts.append(part[a - k * zl:b - k * zl].to(device))
    top = zl * len(slabs)
    if hi > top:
        parts.append(torch.full((hi - max(lo, top),) + tail, fill, dtype=slabs[0].dtype, device=device))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def replicate(value, device):
    """A frozen map value (a dense map, a voxel list, a paged snapshot) with
    every tensor field on `device`; the value itself where it lies there."""
    device = as_device(device)
    changes = {}
    for f in dataclasses.fields(value):
        v = getattr(value, f.name)
        if isinstance(v, torch.Tensor) and v.device != device:
            changes[f.name] = v.to(device)
        elif isinstance(v, tuple) and v and all(isinstance(e, torch.Tensor) for e in v):
            if any(e.device != device for e in v):
                changes[f.name] = tuple(e.to(device) for e in v)
    return dataclasses.replace(value, **changes) if changes else value


def _slab_depth(mesh: GridMesh, dims: Dims) -> int:
    nz = mesh.shape["z"]
    if int(dims[2]) % nz:
        raise ValueError(f"dimz {dims[2]} must divide over the z mesh ({nz})")
    return int(dims[2]) // nz


# -- the builders --------------------------------------------------------------
def build_sharded_cycle(mesh: GridMesh, dims: Dims, side_length: float = 1.0, coll_threshold: float = 1.0):
    """Multi-device sense -> insert -> collide step.

    Returns fn(points_a, points_b) -> count. Without a world axis the clouds
    are [M, 3] and the count 0-d; with `world` > 1 they are [W, M, 3] and the
    counts [W] (the reference's vmap over scenes): scene w runs on row w of
    the mesh. Each step builds both maps from scratch per slab (the
    benchmark cycle), counts collisions per slab (K1 on CUDA) and sums the
    counts. All results land on the mesh's first device."""
    dx, dy, _ = (int(d) for d in dims)
    zl = _slab_depth(mesh, dims)
    local = (dx, dy, zl)
    t = float_to_probability(coll_threshold)
    occupied = BitVoxelMeaning.eBVM_OCCUPIED

    def one_scene(w: int, pa, pb) -> torch.Tensor:
        counts = []
        for k, dev in enumerate(mesh.z_devices(w)):
            empty = torch.full((zl * dy * dx,), UNKNOWN_PROBABILITY, dtype=torch.int8, device=dev)
            ma, _ = insert_ops.insert_prob(empty, to_device(pa, F32, dev), side_length, local, occupied, k * zl)
            mb, _ = insert_ops.insert_prob(empty, to_device(pb, F32, dev), side_length, local, occupied, k * zl)
            counts.append(collide_cuda.count_prob_prob(ma, mb, t, t))
        return psum(counts, mesh.first)

    def fn(points_a, points_b) -> torch.Tensor:
        if mesh.shape["world"] > 1:
            return torch.stack([one_scene(w, points_a[w], points_b[w]) for w in range(mesh.shape["world"])])
        return one_scene(0, points_a, points_b)

    return fn


def build_sharded_sensor_cycle(mesh: GridMesh, dims: Dims, side_length: float, fx: float, fy: float, cx: float,
                               cy: float, coll_threshold: float = 0.7):
    """Multi-device sensor fusion: depth image -> hits + projective
    free-space carve -> collide against a z-slab environment grid.

    The depth image is small and replicated; each slab carves only its own
    voxels in the global frame (K3 with the slab's z_index_offset: the pose
    is never translated, which would move projection boundary decisions at
    side lengths f32 cannot represent) and scatters the hits landing in it.
    Returns fn(depth [H, W], pose [4, 4], env) -> collision count, where
    `env` is the environment's flat int8[N] grid or its slabs."""
    from ..ops import raycast

    dx, dy, _ = (int(d) for d in dims)
    zl = _slab_depth(mesh, dims)
    local = (dx, dy, zl)
    t = float_to_probability(coll_threshold)
    devices = mesh.z_devices()

    def fn(depth, pose, env) -> torch.Tensor:
        env_slabs = split_slabs(env, devices)
        counts = []
        for k, (dev, env_k) in enumerate(zip(devices, env_slabs)):
            empty = torch.full((zl * dy * dx,), UNKNOWN_PROBABILITY, dtype=torch.int8, device=dev)
            sensed = raycast.insert_depth_image(empty, to_device(depth, F32, dev), to_device(pose, F32, dev),
                                                fx, fy, cx, cy, side_length, local, z_index_offset=k * zl)
            counts.append(collide_cuda.count_prob_prob(sensed, env_k, t, t))
        return psum(counts, mesh.first)

    return fn


def sharded_collide_count(mesh: GridMesh, data_a, data_b, t1: int, t2: int) -> torch.Tensor:
    """Collide two flat z-major prob grids (or their slabs) slab by slab (K1
    on CUDA) -> 0-d count."""
    devices = mesh.z_devices()
    parts = zip(split_slabs(data_a, devices), split_slabs(data_b, devices))
    return psum([collide_cuda.count_prob_prob(a, b, int(t1), int(t2)) for a, b in parts], mesh.first)


def build_sharded_bit_cycle(mesh: GridMesh, dims: Dims, side_length: float = 1.0, meaning_a: int = 1,
                            meaning_b: int = 1):
    """Z-slab 256-bit voxel maps: each slab sets the replicated clouds' bits
    landing in it in a local int32[8, zl*Y*X] plane block and counts the
    voxels !noneButEmpty in both (K7 on CUDA); the counts sum. Equal to the
    single-device BitVectorVoxelMap insert + collide_with count."""
    from .. import bitops

    dx, dy, _ = (int(d) for d in dims)
    zl = _slab_depth(mesh, dims)
    local = (dx, dy, zl)
    devices = mesh.z_devices()

    def fn(points_a, points_b) -> torch.Tensor:
        counts = []
        for k, dev in enumerate(devices):
            empty = bitops.zeros((zl * dy * dx,), device=dev)
            ma, _, _ = insert_ops.insert_bit(empty, to_device(points_a, F32, dev), side_length, local,
                                             int(meaning_a), k * zl)
            mb, _, _ = insert_ops.insert_bit(empty, to_device(points_b, F32, dev), side_length, local,
                                             int(meaning_b), k * zl)
            counts.append(collide_cuda.count_bit_bit(ma, mb))
        return psum(counts, mesh.first)

    return fn


def _row_slabs(x, devices, what: str) -> list:
    """The rows of `x` (queries, list keys) cut into one slab per device."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if t.shape[0] % len(devices):
        raise ValueError(f"{t.shape[0]} {what} do not divide over the z mesh ({len(devices)})")
    return split_slabs(t, devices, axis=0)


def build_sharded_paged_probe(mesh: GridMesh, min_level: int = 0, offset=(0, 0, 0)):
    """Sharded paged-octree probe batch: the snapshot (page pyramid, sorted
    directory, tile pool) is replicated, the query batch splits over the z
    slabs. Each slab runs the single-device descent on its queries
    (maps/paged._count_probe_hits) and the occupied / unknown counts sum:
    collide_with_coords / collide_with_counting_unknown_coords of the
    single-device map, distributed over queries.

    Returns fn(snap: PagedSnapshot, coords int32[Q, 3]) -> (occupied,
    unknown) 0-d int64; Q must divide over the z mesh."""
    from ..maps.paged import _count_probe_hits

    devices = mesh.z_devices()

    def fn(snap, coords):
        occ, unk = [], []
        for dev, c in zip(devices, _row_slabs(coords, devices, "queries")):
            c = c.to(torch.int32)
            valid = torch.ones(c.shape[:-1], dtype=torch.bool, device=dev)
            o, u = _count_probe_hits(replicate(snap, dev), c, valid, min_level, offset)
            occ.append(o)
            unk.append(u)
        return psum(occ, mesh.first), psum(unk, mesh.first)

    return fn


def build_sharded_list_collide(mesh: GridMesh):
    """Sharded list x list collide: list A's sorted keys split over the z
    slabs, list B's are replicated; each slab binary-searches its keys in B
    and the matches sum: `VoxelList.collide_with(list)` of two lists of one
    id mode (the thrust::binary_search stencil, TemplateVoxelList.hpp:228-275,
    distributed over A's entries). The keys are the port's single int64 key
    (maps/voxellist.py), so one search replaces the reference's (lo, hi)
    pair search; EMPTY padding never matches.

    Returns fn(a: VoxelList, b: VoxelList) -> 0-d int64; A's capacity
    divides over the z mesh."""
    devices = mesh.z_devices()

    def fn(a, b) -> torch.Tensor:
        counts = []
        for dev, ka in zip(devices, _row_slabs(a.keys, devices, "list entries")):
            kb = b.keys.to(dev)
            if kb.shape[0] == 0:
                counts.append(torch.zeros((), dtype=torch.int64, device=dev))
                continue
            pos = torch.searchsorted(kb, ka).clamp_(0, kb.shape[0] - 1)
            found = (torch.take(kb, pos) == ka) & (ka != a.empty)
            counts.append(found.sum(dtype=torch.int64))
        return psum(counts, mesh.first)

    return fn


def build_sharded_hier_probe(mesh: GridMesh, levels: int, dims: Dims):
    """Sharded hierarchy probe batch: level 0 splits into z slabs and the
    coarse levels (small) are kept once; the queries descend across them as
    a `ShardedPyramid` (parallel/shard_value.py) does, so a query reaching
    level 0 is answered by its slab, and the occupied hits sum:
    collide_with_coords on the single-device pyramid, out-of-range
    queries included.

    Returns fn(l0 [Z, Y, X] or its slabs, coarse levels (tuple), coords
    [Q, 3]) -> 0-d int64; `dims` are the pyramid's padded dims."""
    from ..maps.hierarchical import HierarchicalBitMap
    from .shard_value import ShardedPyramid

    _slab_depth(mesh, dims)
    devices = mesh.z_devices()

    def fn(l0, coarse, coords) -> torch.Tensor:
        pyramid = [split_slabs(l0, devices, axis=0)] + [c.to(devices[0]) for c in coarse]
        pyr = ShardedPyramid(HierarchicalBitMap, dims, 1.0, levels, None, pyramid, None, mesh, "z")
        return pyr.probe(coords)[0].sum(dtype=torch.int64)

    return fn
