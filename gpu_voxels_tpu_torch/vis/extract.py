"""Cube extraction: device maps -> renderable cube sets.

Equivalent of the extractCubes paths (TemplateVoxelList.hpp:704,
NTree.hpp:2637) feeding the visualizer. Counterpart of
gpu_voxels_tpu/vis/extract.py: the same cubes, in the same order (ascending
linear index for dense maps, the list's order for lists, the walk's order
for multi-level extraction), so the files written from them are
byte-equal.

Every host read here is O(extracted), never O(N): dense masks are compacted
on the map's device (ops/compact.py), a bit map's meanings gather only the
K occupied columns, the multi-level walks gather one level's open nodes at
a time, and a distance slice reads one plane.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import UNKNOWN_PROBABILITY, BitVoxelMeaning, float_to_probability
from ..maps.hierarchical import NS_COLLISION, NS_FREE, NS_OCCUPIED, NS_UNKNOWN, STATUS_OCCUPANCY_MASK
from ..ops.compact import compacted_nonzero
from ..utils import to_device

def _host_index(a: np.ndarray, device) -> torch.Tensor:
    return to_device(np.ascontiguousarray(a), torch.int64, device)


def _dense_mask(m, threshold: float, z0: int = 0) -> torch.Tensor:
    """bool[N] occupied voxels of a plain dense map, or of a slab whose first
    global row is z0 (a distance slab's obstacles store global coordinates)."""
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
    from ..ops import edt

    if isinstance(m, ProbVoxelMap):
        return m.occupied_mask(threshold)
    if isinstance(m, BitVectorVoxelMap):
        return m.occupied_mask()
    if isinstance(m, CountingVoxelMap):
        return m.occupied_mask(1)
    if isinstance(m, DistanceVoxelMap):
        return edt.squared_distance_grid(m.data, m.dims, z0).reshape(-1) == 0
    raise TypeError(type(m))


def _compacted_slabs(parts, plane: int, max_cubes: Optional[int]) -> np.ndarray:
    """Ascending global flat indices of the set cells of (mask, first row)
    z-slabs in z order: each slab compacted on its device (two host reads a
    slab, O(K) bytes), its indices moved by its first row; at most
    max_cubes, the first ones, as one compaction of the joined mask gives."""
    out, left = [], max_cubes
    for mask, z0 in parts:
        if left is not None and left <= 0:
            break
        idx = compacted_nonzero(mask, capacity=left) + z0 * plane
        out.append(idx)
        left = None if left is None else left - len(idx)
    return np.concatenate(out) if out else np.zeros((0,), np.int64)


def occupied_coords(m, threshold: float = 0.5, max_cubes: Optional[int] = None) -> np.ndarray:
    """int32[K, 3] coordinates of occupied voxels (host readback).

    Works for ProbVoxelMap (occupancy >= threshold), BitVectorVoxelMap
    (!noneButEmpty), CountingVoxelMap (count >= 1), DistanceVoxelMap
    (distance == 0), voxel lists and every octree tier, plain or sharded: a
    sharded map is compacted slab by slab, never gathered.
    """
    from ..maps.hierarchical import HierarchicalProbMap
    from ..maps.voxellist import VoxelList
    from ..maps.voxelmap import _DenseMap
    from ..parallel.shard_value import operand_class, operand_slabs

    if isinstance(m, VoxelList):
        n = int(m.count)
        return m.coords_from_ids(m.keys[:n]).cpu().numpy()
    if operand_class(m) is HierarchicalProbMap:
        # the caller's threshold against the occupancy grid (the status
        # pyramid bakes the octree's fixed THRESHOLD_OCCUPANCY, the probe
        # contract, not the visualization contract); a sharded pyramid's
        # occupancy slab by slab
        slabs = m.occupancy if isinstance(m.occupancy, list) else [m.occupancy]
        t = float_to_probability(threshold)
        pdx, pdy, _ = m.padded_dims
        zl = slabs[0].shape[0]
        idx = _compacted_slabs([((o.to(torch.int32) >= t) & (o != UNKNOWN_PROBABILITY), k * zl)
                                for k, o in enumerate(slabs)], pdx * pdy, None)
        z, rem = np.divmod(idx, pdx * pdy)
        y, x = np.divmod(rem, pdx)
        keep = (x < m.dims[0]) & (y < m.dims[1]) & (z < m.dims[2])
        coords = np.stack([x[keep], y[keep], z[keep]], axis=1).astype(np.int32)
        return coords[:max_cubes] if max_cubes is not None else coords
    if hasattr(m, "extract_occupied_coords"):  # HierarchicalBitMap and the paged tier
        coords = np.asarray(m.extract_occupied_coords())
        return coords[:max_cubes] if max_cubes is not None else coords
    if not issubclass(operand_class(m), _DenseMap):
        raise TypeError(type(m))
    dx, dy, _ = m.dims
    idx = _compacted_slabs([(_dense_mask(slab, threshold, z0), z0) for slab, z0, _ in operand_slabs(m)], dx * dy,
                           max_cubes)
    z, rem = np.divmod(idx, dx * dy)
    y, x = np.divmod(rem, dx)
    return np.stack([x, y, z], axis=1).astype(np.int32)


def _status_types(status: np.ndarray) -> np.ndarray:
    """Status byte -> BitVoxelMeaning type id, the reference's default
    status-to-meaning mapping (NTree.hpp:336-352): FREE and FREE|UNKNOWN ->
    eBVM_FREE, UNKNOWN -> eBVM_UNKNOWN, anything containing OCCUPIED ->
    eBVM_OCCUPIED, anything carrying ns_COLLISION -> eBVM_COLLISION."""
    s = status.astype(np.uint8)
    occ = s & np.uint8(STATUS_OCCUPANCY_MASK)
    t = np.full(s.shape, int(BitVoxelMeaning.eBVM_UNKNOWN), np.uint8)
    t[(occ == NS_FREE) | (occ == (NS_FREE | NS_UNKNOWN))] = int(BitVoxelMeaning.eBVM_FREE)
    t[(occ & NS_OCCUPIED) != 0] = int(BitVoxelMeaning.eBVM_OCCUPIED)
    t[(s & np.uint8(NS_COLLISION)) != 0] = int(BitVoxelMeaning.eBVM_COLLISION)
    return t


def _is_uniform_np(status: np.ndarray) -> np.ndarray:
    s = status.astype(np.int32) & STATUS_OCCUPANCY_MASK
    return (s & (s - 1)) == 0


def _gather_level(level, coords: np.ndarray) -> np.ndarray:
    """level[z, y, x] at host coords: one gather on the level's device and a
    K-byte readback, never the whole level. A level held as z-slabs (a
    sharded pyramid's) is read slab by slab, each coordinate from its slab."""
    if coords.shape[0] == 0:
        return np.zeros((0,), np.uint8)
    if isinstance(level, list):
        zl = level[0].shape[0]
        out = np.zeros((coords.shape[0],), np.uint8)
        for k, part in enumerate(level):
            own = coords[:, 2] // zl == k
            if own.any():
                out[own] = _gather_level(part, coords[own] - np.array([0, 0, k * zl]))
        return out
    c = _host_index(coords, level.device)
    return level[c[:, 2], c[:, 1], c[:, 0]].cpu().numpy()


def _children_of(coords: np.ndarray) -> np.ndarray:
    """8 child coords (next finer level) per parent coord [K,3] -> [8K,3]."""
    offs = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"), axis=-1).reshape(-1, 3)[:, ::-1]
    return (coords[:, None, :] * 2 + offs[None, :, :]).reshape(-1, 3)


class _CubeSink:
    """Accumulates (corner, size, status) rows and applies the status
    selection filter (the reference's const_extract_selection,
    Extract.cuh:178; defaults select everything, NTree.hpp:361-363)."""

    def __init__(self, occupied: bool, free: bool, unknown: bool, dims):
        self.rows = []
        self._sel = {
            int(BitVoxelMeaning.eBVM_OCCUPIED): occupied,
            int(BitVoxelMeaning.eBVM_COLLISION): occupied,
            int(BitVoxelMeaning.eBVM_FREE): free,
            int(BitVoxelMeaning.eBVM_UNKNOWN): unknown,
        }
        self._dims = np.asarray(dims, np.int64)

    def emit(self, corners: np.ndarray, size: int, statuses: np.ndarray) -> None:
        if corners.shape[0] == 0:
            return
        types = _status_types(statuses)
        keep = np.zeros(types.shape, bool)
        for t, sel in self._sel.items():
            if sel:
                keep |= types == t
        # drop cubes entirely outside the logical dims (pyramid padding)
        keep &= np.all(corners < self._dims[None, :], axis=1)
        if np.any(keep):
            self.rows.append((corners[keep], np.full(int(keep.sum()), size, np.int32), types[keep]))

    def result(self, max_cubes: Optional[int]):
        if not self.rows:
            return np.zeros((0, 3), np.int64), np.zeros((0,), np.int32), np.zeros((0,), np.uint8)
        corners = np.concatenate([r[0] for r in self.rows]).astype(np.int64)
        sizes = np.concatenate([r[1] for r in self.rows])
        types = np.concatenate([r[2] for r in self.rows])
        if max_cubes is not None and len(sizes) > max_cubes:
            # coarsest-first: large context cubes survive truncation
            order = np.argsort(-sizes, kind="stable")[:max_cubes]
            corners, sizes, types = corners[order], sizes[order], types[order]
        return corners, sizes, types


def _mini_walk(sink, grid: np.ndarray, base_corners: np.ndarray, top_fine_level: int, stop_level: int,
               min_level: int):
    """Walk per-group 8^3 mini-pyramids (block summaries within open pages /
    voxels within open tiles), vectorized across groups.

    grid: uint8[G, 8, 8, 8] statuses in [wz, wy, wx] order (zero bytes
    already read as NS_UNKNOWN); base_corners: int64[G, 3] fine-voxel corner
    of each group. Emits the uniform nodes from top_fine_level (2x2x2 over
    the group) down to stop_level and returns the corners and the
    (group, wz, wy, wx) cells of the nodes still open at stop_level.
    """
    levels = [grid]  # fine (8^3, at fine level top_fine_level - 2) -> coarse (2^3)
    cur = grid
    while cur.shape[1] > 2:
        cur = cur[:, :, :, 0::2] | cur[:, :, :, 1::2]
        cur = cur[:, :, 0::2, :] | cur[:, :, 1::2, :]
        cur = cur[:, 0::2, :, :] | cur[:, 1::2, :, :]
        levels.append(cur)
    open_mask = None  # [G, n, n, n] bool at the previous (coarser) level
    for fl in range(top_fine_level, stop_level - 1, -1):
        lv = levels[fl - (top_fine_level - len(levels) + 1)]
        if open_mask is None:
            sel = np.ones(lv.shape, bool)
        else:
            sel = np.repeat(np.repeat(np.repeat(open_mask, 2, axis=1), 2, axis=2), 2, axis=3)
        leaf = sel & (_is_uniform_np(lv) | (fl == min_level))
        gi, zz, yy, xx = np.nonzero(leaf)
        corners = base_corners[gi] + (np.stack([xx, yy, zz], axis=1).astype(np.int64) << fl)
        sink.emit(corners, 1 << fl, lv[gi, zz, yy, xx])
        open_mask = sel & ~leaf
        if fl == stop_level:
            gi, zz, yy, xx = np.nonzero(open_mask)
            corners = base_corners[gi] + (np.stack([xx, yy, zz], axis=1).astype(np.int64) << fl)
            return corners, np.stack([gi, zz, yy, xx], axis=1)
    return np.zeros((0, 3), np.int64), np.zeros((0, 4), np.int64)


def extract_multilevel_cubes(
    m,
    min_level: int = 0,
    occupied: bool = True,
    free: bool = True,
    unknown: bool = True,
    max_cubes: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One cube per occupancy-uniform octree node — the reference's
    extractCubes (NTree.hpp:2637 via the Extract load-balancer task,
    Extract.h:50): the traversal descends ns_PART nodes and emits every
    non-PART node at its own level; min_level stops the descent early,
    emitting (possibly mixed) nodes at that level (Extract.cuh:163-178).

    Works on HierarchicalProbMap / HierarchicalBitMap (dense status pyramid,
    plain or sharded: a split level read slab by slab), PagedHierarchicalMap (coarse page pyramid -> block summaries -> tile
    pool) and ShardedPagedWorld (per slab, corners moved into the global
    frame): a paged world extracts in O(allocated surface) cubes, not
    O(volume).

    Returns (corners int64[K,3] fine-voxel coords of the cube's min corner,
    sizes int32[K] cube edge in fine voxels, types uint8[K] BitVoxelMeaning
    ids per the reference's default status mapping, NTree.hpp:336-352).
    occupied/free/unknown toggle the status selection (default: everything,
    like the reference's default extract selection, NTree.hpp:361-363).
    """
    from ..maps.hierarchical import _is_sharded_pyramid, _PyramidQueries
    from ..maps.paged import PagedHierarchicalMap
    from ..parallel.paged_world import ShardedPagedWorld

    if isinstance(m, ShardedPagedWorld):
        return _world_multilevel(m, min_level, occupied, free, unknown, max_cubes)
    if isinstance(m, PagedHierarchicalMap):
        return _paged_multilevel(m, min_level, occupied, free, unknown, max_cubes)
    if isinstance(m, _PyramidQueries) or _is_sharded_pyramid(m):
        return _dense_multilevel(m, min_level, occupied, free, unknown, max_cubes)
    raise TypeError(f"multi-level extraction needs a hierarchical map, got {type(m)}")


def _world_multilevel(m, min_level, occupied, free, unknown, max_cubes):
    """Per-slab extraction (each read is local to its slab's device), the
    corners moved into the global frame; the coarsest-first truncation
    applies to the combined set, as the single map's sink does. The UNKNOWN
    cubes are the slabs' own: a slab never spans another's space."""
    parts = [_paged_multilevel(s, min_level, occupied, free, unknown, max_cubes) for s in m.shards]
    corners = [c.copy() for c, _, _ in parts]
    for z0, c in zip(m.z0s, corners):
        c[:, 2] += z0
    corners = np.concatenate(corners, axis=0)
    sizes = np.concatenate([s for _, s, _ in parts], axis=0)
    types = np.concatenate([t for _, _, t in parts], axis=0)
    if max_cubes is not None and corners.shape[0] > max_cubes:
        order = np.argsort(-sizes.astype(np.int64), kind="stable")[:max_cubes]
        corners, sizes, types = corners[order], sizes[order], types[order]
    return corners, sizes, types


def _top_coords(level) -> np.ndarray:
    """(x, y, z) of every cell of a level (a tensor, or its z-slabs)."""
    parts = level if isinstance(level, list) else [level]
    _, yt, xt = parts[0].shape
    zt = sum(p.shape[0] for p in parts)
    gz, gy, gx = np.meshgrid(np.arange(zt), np.arange(yt), np.arange(xt), indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.int64)


def _dense_multilevel(m, min_level, occupied, free, unknown, max_cubes):
    if min_level > m.levels:
        raise ValueError("min_level greater than octree height")
    sink = _CubeSink(occupied, free, unknown, m.dims)
    open_c = _top_coords(m.pyramid[m.levels])
    for lvl in range(m.levels, min_level - 1, -1):
        if open_c.shape[0] == 0:
            break
        s = _gather_level(m.pyramid[lvl], open_c)
        leaf = _is_uniform_np(s) | (lvl == min_level)
        sink.emit(open_c[leaf] << lvl, 1 << lvl, s[leaf])
        open_c = _children_of(open_c[~leaf])
    return sink.result(max_cubes)


def _paged_multilevel(m, min_level, occupied, free, unknown, max_cubes):
    from ..maps.paged import B, PAGE_EDGE, SB

    if min_level > m.fine_levels:
        raise ValueError("min_level greater than octree height")
    sink = _CubeSink(occupied, free, unknown, m.dims)

    # -- coarse page pyramid (fine levels >= 6), compact-gather walk ---------
    top = m.levels
    open_c = _top_coords(m.pyramid[top])
    stop = max(min_level - 6, 0)
    for lvl in range(top, stop - 1, -1):
        if open_c.shape[0] == 0:
            break
        s = _gather_level(m.pyramid[lvl], open_c)
        leaf = _is_uniform_np(s) | (lvl == stop and min_level >= 6)
        fine_shift = lvl + 6
        sink.emit(open_c[leaf] << fine_shift, 1 << fine_shift, s[leaf])
        open_c = _children_of(open_c[~leaf]) if lvl > stop else open_c[~leaf]
    if min_level >= 6 or open_c.shape[0] == 0:
        return sink.result(max_cubes)

    # -- block summaries of the open (mixed => allocated) pages ---------------
    sx, sy, _ = m.sdims
    page_keys = (open_c[:, 2] * sy + open_c[:, 1]) * sx + open_c[:, 0]
    rows = np.asarray([m._page_of[int(k)] for k in page_keys], np.int64)
    rows_t = _host_index(rows, m.device)
    bs = m.block_summaries[rows_t].cpu().numpy().reshape(-1, SB, SB, SB)  # [P, wz, wy, wx]
    bs = np.where(bs == 0, np.uint8(NS_UNKNOWN), bs)  # unallocated block
    open_corners, open_cells = _mini_walk(sink, bs, open_c * PAGE_EDGE, top_fine_level=5,
                                          stop_level=max(min_level, 3), min_level=min_level)
    if min_level >= 3 or open_corners.shape[0] == 0:
        return sink.result(max_cubes)

    # -- tile pool of the open (mixed => allocated) blocks ---------------------
    gi, wz, wy, wx = open_cells.T
    within = (wz * SB + wy) * SB + wx
    slots = m.pages[_host_index(rows[gi], m.device), _host_index(within, m.device)].cpu().numpy()
    # a mixed block summary can only come from an existing tile (the
    # summaries are rebuilt from the pool), so every open block has a slot
    assert np.all(slots >= 0), "mixed block without a tile slot"
    tiles = m.pool[_host_index(slots, m.device)].cpu().numpy().reshape(-1, B, B, B)
    tiles = np.where(tiles == 0, np.uint8(NS_UNKNOWN), tiles)
    _mini_walk(sink, tiles, open_corners, top_fine_level=2, stop_level=max(min_level, 0),
               min_level=max(min_level, 0))
    return sink.result(max_cubes)


def extract_distance_slice(m, axis: str = "z", index: Optional[int] = None):
    """(coords int32[K,3], distances float32[K]) of one plane of a
    DistanceVoxelMap — the distance-field visualization source (the
    reference viewer colors DistanceVoxel maps by distance,
    gpu_visualization/Visualizer.cu / XMLInterpreter distance configs).
    Distances are metric (voxel units x side_length). The plane is cut on
    the map's device: one plane is read, not the grid; a sharded map's from
    the slabs it crosses, each slab's obstacles at their global rows."""
    from ..ops import edt
    from ..parallel.shard_value import operand_slabs

    ax = {"x": 0, "y": 1, "z": 2}[axis]
    n_ax = m.dims[ax]
    if index is None:
        index = n_ax // 2
    if not (0 <= index < n_ax):
        raise ValueError(f"slice index {index} outside axis {axis} of {n_ax}")
    parts = []  # [z, y, x] minus the axis, slab by slab in z order
    for slab, z0, _ in operand_slabs(m):
        zl = slab.dims[2]
        if ax == 2 and not z0 <= index < z0 + zl:
            continue
        sl = [slice(None)] * 3
        sl[2 - ax] = index - z0 if ax == 2 else index
        parts.append(edt.squared_distance_grid(slab.data, slab.dims, z0)[tuple(sl)].cpu())
    plane = torch.cat(parts).numpy() if ax != 2 else parts[0].numpy()
    uu, vv = np.meshgrid(*[np.arange(s) for s in plane.shape], indexing="ij")
    rem = [d for d in (0, 1, 2) if d != 2 - ax]  # remaining z-major dims
    coords = np.zeros((plane.size, 3), np.int32)
    coords[:, 2 - rem[0]] = uu.ravel()
    coords[:, 2 - rem[1]] = vv.ravel()
    coords[:, ax] = index
    dist = np.sqrt(plane.ravel().astype(np.float64)) * float(m.side_length)
    return coords, dist.astype(np.float32)


def _lowest_meanings(planes: np.ndarray) -> np.ndarray:
    """uint8[K]: per column of uint32[8, K] bit planes the lowest set
    meaning, skipping eBVM_FREE (plane 0's bit 0); 0 where none is set."""
    w = planes.copy()
    w[0] &= np.uint32(0xFFFFFFFE)
    nz = w != 0
    first = np.argmax(nz, axis=0)
    word = w[first, np.arange(w.shape[1])]
    lowest = word & (~word + np.uint32(1))  # the lowest set bit, as a power of two
    bit = np.log2(np.maximum(lowest, 1).astype(np.float64)).astype(np.int64)
    return np.where(nz.any(axis=0), first * 32 + bit, 0).astype(np.uint8)


def extract_cubes(m, threshold: float = 0.5, max_cubes: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(centers float32[K,3] in metric space, types uint8[K]).

    Types: for bit maps the lowest set meaning bit per voxel; for the other
    maps eBVM_OCCUPIED; mirrors what the reference visualizer colors by.
    max_cubes bounds the device->host fetch (compaction capacity) — the
    live-viewer budget knob.
    """
    from ..maps.voxelmap import BitVectorVoxelMap
    from ..parallel.shard_value import operand_class, operand_slabs

    coords = occupied_coords(m, threshold, max_cubes=max_cubes)
    centers = (coords.astype(np.float32) + 0.5) * m.side_length
    if operand_class(m) is BitVectorVoxelMap:
        dx, dy, _ = m.dims
        lin = coords[:, 2].astype(np.int64) * dx * dy + coords[:, 1] * dx + coords[:, 0]
        # gather the K occupied columns on the device, each from the slab that
        # holds it: the readback is [8, K] words, never the whole plane set;
        # the int32 planes are read as the uint32 words they hold (H1: a
        # shift of a negative int32 would sign-extend bit 31)
        planes = np.zeros((8, len(lin)), np.uint32)
        for slab, z0, dev in operand_slabs(m):
            start = z0 * dx * dy
            own = (lin >= start) & (lin < start + slab.voxelmap_size)
            planes[:, own] = slab.data[:, _host_index(lin[own] - start, dev)].cpu().numpy().view(np.uint32)
        return centers, _lowest_meanings(planes)
    return centers, np.full(len(centers), 1, np.uint8)  # eBVM_OCCUPIED
