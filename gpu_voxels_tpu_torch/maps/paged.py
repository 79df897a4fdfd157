"""Paged hierarchical map: octree-scale worlds past the dense pyramid's wall.

Counterpart of gpu_voxels_tpu/maps/paged.py. The reference NTree spans 15
levels, 32768^3 virtual voxels, with sparse node allocation
(octree/DataTypes.h, common_defines.h:189-191). The dense status pyramid
(maps/hierarchical.py) stops near 1024^3, so this tier splits the world
into a dense coarse part and two sparse fine levels:

  * a grid of 64^3-voxel pages carries a dense status pyramid (a 32768^3
    world is a 512^3 page grid), which decides every query a uniform page
    can decide;
  * each allocated page owns a row of 512 block-summary bytes and a row of
    512 block -> tile-slot entries;
  * each allocated 8^3 block owns a tile of 512 status bytes in one pool.

Status bytes are the deterministic tier's (hard FREE / UNKNOWN / OCCUPIED
plus the ns_STATIC_MAP / ns_DYNAMIC_MAP tags); byte 0, never written, reads
UNKNOWN. The probabilistic tier keeps an int8 log-odds pool beside it and
derives the status pool from it, so both tiers share every probe.

The host allocates tiles and pages, in the reference's order and with its
capacity doubling and power-of-two page directory, so slot numbers, files,
`memory_usage` and `n_tiles` agree with the JAX package's. Every bulk step
(voxelizing, scattering statuses, the summaries and the coarse pyramid,
probing) runs on the map's device. `_host_fetch` is the allocator's only
device -> host read: one scalar on a steady-state insert, a scalar and the
O(new tiles) list of new blocks when an insert allocates. `check_tree`,
`extract_occupied_coords`, the self-collision test and the files read too.

Every update builds new tensors instead of writing in place, so a
`PagedSnapshot` (what the validity checker probes) keeps the state it was
taken from until the checker's `refresh()`, as in the reference.

The reference's jit-only structure is not kept (H9): points are not padded
to a power of two (its -1e9 sentinels; a ray to a non-finite point is still
dead, as there) and the fetched prefix is not bucketed. Its two int32 sort
keys (page key, block within the page) are one int64 key here, and the OR
reductions over 512 bytes fold by halves (torch has no OR reduction: H13).
Every scatter writes one slot past the end for the dropped entries (H2);
the destinations of a scatter-set are distinct, or the duplicates carry
one value (H7: noted at each site).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import (MAX_PROBABILITY, MIN_PROBABILITY, SENSOR_MODEL_FREE, SENSOR_MODEL_OCCUPIED,
                         UNKNOWN_PROBABILITY, BitVoxelMeaning, MapType, meaning_to_probability)
from ..geometry import transforms
from ..ops import raycast
from ..ops.insert import clamp_coords, floor_to_int32, in_map, linear_index, map_to_voxels, shifted
from ..utils import resolve_device, to_device
from ..utils.io import DiskIO
from ..utils.logging import log_stream
from .hierarchical import (NS_DYNAMIC_MAP, NS_FREE, NS_OCCUPIED, NS_STATIC_MAP, NS_UNKNOWN,
                           STATUS_OCCUPANCY_MASK, U8, _build_pyramid, _is_sharded_pyramid, _is_uniform, _num_levels,
                           _pad_dims, _PyramidQueries, _reject_octree_offset, _status_from_occupancy,
                           count_part_hits, count_probe_hits, decode_status_flags, descend, meta_first_meaning,
                           probe_occupied, query_parts_of)

_log = log_stream("octree")

Dims = Tuple[int, int, int]
B = 8  # tile edge (fine voxels per block axis)
SB = 8  # page edge (blocks per page axis); a page covers (B*SB)^3 = 64^3 voxels
PAGE = SB * SB * SB
TILE = B * B * B
PAGE_EDGE = B * SB
INT32_MAX = 2**31 - 1  # the directory's padding key: after every page key (< 2^30)


def fold_or(rows: torch.Tensor) -> torch.Tensor:
    """uint8[R, 2^k] -> uint8[R]: the bitwise OR along each row, folded by
    halves (H13: torch has no OR reduction; a sum or a max is not one)."""
    while rows.shape[-1] > 1:
        h = rows.shape[-1] // 2
        rows = rows[..., :h] | rows[..., h:]
    return rows[..., 0]


def _or_summary(rows: torch.Tensor) -> torch.Tensor:
    """The OR of each row, with UNKNOWN added where the row holds a byte 0
    (a never-written cell or block): getNewStatus over the children."""
    return fold_or(rows) | torch.where(torch.any(rows == 0, dim=-1), NS_UNKNOWN, 0).to(U8)


def _unknown_if_unwritten(b: torch.Tensor) -> torch.Tensor:
    """A status byte with no occupancy bit (never written) reads UNKNOWN."""
    return torch.where((b & STATUS_OCCUPANCY_MASK) == 0, b | NS_UNKNOWN, b)


def _page_keys(coords: torch.Tensor, sdims: Dims) -> torch.Tensor:
    """int32 page key (z * sy + y) * sx + x of fine coords (< 2^31 by the
    dims check)."""
    sx, sy, _ = sdims
    pc = coords // PAGE_EDGE
    return (pc[..., 2] * sy + pc[..., 1]) * sx + pc[..., 0]


def _within(c: torch.Tensor, edge: int) -> torch.Tensor:
    """Index of c inside its edge^3 cell, z-major (block in page, voxel in tile)."""
    return ((c[..., 2] % edge) * edge + (c[..., 1] % edge)) * edge + c[..., 0] % edge


def _lookup_pages(skeys: torch.Tensor, srows: torch.Tensor, coords: torch.Tensor, sdims: Dims):
    """(page row int64, found) of fine coords through the sorted page-key
    directory (a binary search)."""
    skey = _page_keys(coords, sdims)
    pos = torch.searchsorted(skeys, skey).clamp_(max=skeys.shape[0] - 1)
    found = torch.take(skeys, pos) == skey
    return torch.where(found, torch.take(srows, pos), 0).to(torch.int64), found


@dataclass(frozen=True, eq=False)
class PagedSnapshot:
    """A frozen view of a PagedHierarchicalMap's device state: what the
    validity checker probes. All probe machinery lives here; the map
    delegates to it."""

    pyramid: Tuple[torch.Tensor, ...]
    skeys: torch.Tensor  # int32[D], sorted, INT32_MAX padding
    srows: torch.Tensor  # int32[D] page row per key
    pages: torch.Tensor  # int32[NP, 512] tile slot per block, -1 = none
    block_summaries: torch.Tensor  # uint8[NP, 512]
    pool: torch.Tensor  # uint8[NT, 512]
    slot_block: torch.Tensor  # int32[NT, 3] block coords per slot
    n_slots: int
    dims: Dims
    sdims: Dims
    levels: int
    side_length: float

    @property
    def device(self) -> torch.device:
        return self.pool.device

    def probe_status(self, coords, min_level: int = 0) -> torch.Tensor:
        """Status byte per fine voxel coordinate [..., 3]. Levels >= 6 descend
        the page pyramid only; levels 3-5 refine through the block
        summaries (the OR over the aligned 2^(l-3) block cube); levels 0-2
        through the tiles (0 the voxel, 1 and 2 the OR over the aligned 2^l
        cube): the NTree min_level semantics, kernel_Octree.h:383-423.
        Out-of-range coords clamp to the border cell."""
        c = clamp_coords(to_device(coords, torch.int32, self.device), self.dims)
        pc = c // PAGE_EDGE
        status = descend(self.pyramid, self.levels, max(min_level - 6, 0), pc[..., 0], pc[..., 1], pc[..., 2],
                         in_range=True)
        if min_level >= 6:
            return status

        needs = ~_is_uniform(status)
        page_row, found = _lookup_pages(self.skeys, self.srows, c, self.sdims)
        row_base = page_row * PAGE
        bc = c // B
        if min_level >= 3:
            # the OR over the aligned block cube, always inside one page; an
            # unallocated block reads UNKNOWN before the OR, so unknown
            # survives beside an occupied sibling (as in the page pyramid)
            r = 1 << (min_level - 3)
            base = ((bc % SB) // r) * r
            blk = torch.zeros(c.shape[:-1], dtype=U8, device=c.device)
            for dz in range(r):
                for dy in range(r):
                    for dx in range(r):
                        widx = (base[..., 2] + dz) * (SB * SB) + (base[..., 1] + dy) * SB + (base[..., 0] + dx)
                        blk |= _unknown_if_unwritten(torch.take(self.block_summaries, row_base + widx))
            return torch.where(needs & found, blk, status)

        within_s = _within(bc, SB)
        blk = _unknown_if_unwritten(torch.take(self.block_summaries, row_base + within_s))
        slot = torch.take(self.pages, row_base + within_s)
        have_tile = found & (slot >= 0)
        tile_base = slot.clamp(min=0).to(torch.int64) * TILE
        r = 1 << min_level
        base = ((c % B) // r) * r
        fine = torch.zeros(c.shape[:-1], dtype=U8, device=c.device)
        for dz in range(r):
            for dy in range(r):
                for dx in range(r):
                    widx = (base[..., 2] + dz) * (B * B) + (base[..., 1] + dy) * B + (base[..., 0] + dx)
                    fine |= torch.take(self.pool, tile_base + widx)
        refined = torch.where(_is_uniform(blk) | ~have_tile, blk, _unknown_if_unwritten(fine))
        return torch.where(needs & found, refined, status)

    def probe(self, coords, min_level: int = 0):
        return decode_status_flags(self.probe_status(coords, min_level))

    probe_clamped = probe  # every probe here clamps

    def occupied_cells(self):
        """(int32[n_slots * 512, 3] fine coords, bool valid) of every
        occupied voxel: the map's exact occupied set, which lives in the
        tile pool."""
        n = self.n_slots
        wi = torch.arange(TILE, dtype=torch.int32, device=self.device)
        w = torch.stack([wi % B, (wi // B) % B, wi // (B * B)], dim=-1)
        coords = self.slot_block[:n, None, :] * B + w[None, :, :]
        occ = (self.pool[:n] & STATUS_OCCUPANCY_MASK) == NS_OCCUPIED
        return coords.reshape(-1, 3), occ.reshape(-1)


# -- device programs ---------------------------------------------------------
def _host_fetch(t: torch.Tensor) -> np.ndarray:
    """The allocator's single device -> host read. Tests replace it to count
    what it reads: one scalar per steady-state insert; a scalar and the
    O(new tiles) prefix of new blocks when an insert allocates."""
    return t.cpu().numpy()


def _voxelize_points(pts: torch.Tensor, side_length: float, dims: Dims, voff=None):
    """Voxelize in the global frame, then shift by an integer voxel offset
    (the slab decomposition's hook: the shift follows the one global
    boundary decision). Returns (clamped int32 coords, inside)."""
    coords = map_to_voxels(pts, side_length)
    if voff is not None:
        coords = shifted(coords, voff, -1)
    return clamp_coords(coords, dims), in_map(coords, dims)


def _pool_address(state, coords: torch.Tensor, inside: torch.Tensor):
    """Point coords -> flat tile-pool address slot * 512 + within, and
    whether the point resolves (inside, on an allocated page and block).
    Unresolved points get the address one past the pool."""
    page_row, found = _lookup_pages(state.skeys, state.srows, coords, state.sdims)
    slot = torch.take(state.pages, page_row * PAGE + _within(coords // B, SB))
    ok = inside & found & (slot >= 0)
    addr = slot.to(torch.int64) * TILE + _within(coords, B)
    return torch.where(ok, addr, state.pool.numel()), ok


def _needs_allocation(state, coords: torch.Tensor, inside: torch.Tensor) -> torch.Tensor:
    """True iff an in-bounds point lands outside every allocated tile: the
    only case in which the host allocator runs."""
    return torch.any(inside & ~_pool_address(state, coords, inside)[1])


def _new_tile_blocks(state, coords: torch.Tensor, inside: torch.Tensor):
    """(n_new, int32[N, 3] blocks): the distinct block coords of in-bounds
    points whose tile is unallocated, at the front of `blocks`, in the
    reference's order: sorted by (page key, block within the page), here
    one int64 key page_key * 512 + within, sorted stable. The scatter's
    destinations are distinct ranks (H7); the rest go to slot N (H2)."""
    _, ok = _pool_address(state, coords, inside)
    new = inside & ~ok
    bc = coords // B
    key = _page_keys(coords, state.sdims).to(torch.int64) * PAGE + _within(bc, SB)
    key = torch.where(new, key, torch.iinfo(torch.int64).max)
    ks, order = torch.sort(key, stable=True)
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    take = first & new[order]
    n = coords.shape[0]
    pos = torch.where(take, torch.cumsum(take, dim=0) - 1, n)
    blocks = torch.zeros((n + 1, 3), dtype=torch.int32, device=coords.device)
    blocks[pos] = bc[order]
    return take.sum(), blocks[:n]


def _scatter_pool(pool: torch.Tensor, addr: torch.Tensor, occ_bit: int, flag: int) -> torch.Tensor:
    """Hard status set at pool addresses. The new byte depends only on the
    old byte at the same address, so duplicate addresses carry one value
    (H7): a touched mask then one select."""
    n = pool.numel()
    touched = torch.zeros(n + 1, dtype=torch.bool, device=pool.device).index_fill_(0, addr, True)[:n]
    flat = pool.reshape(-1)
    new = (flat & (0xFF ^ STATUS_OCCUPANCY_MASK)) | (occ_bit | flag)
    return torch.where(touched, new, flat).reshape(pool.shape)


def _scatter_pool_prob_set(occ_pool: torch.Tensor, addr: torch.Tensor, value: int):
    """Probabilistic point insert: the voxels take the meaning's
    probability (ProbabilisticVoxel.hpp:77-92), one value for every
    duplicate (H7). Returns (occ_pool, derived status pool)."""
    n = occ_pool.numel()
    flat = torch.empty(n + 1, dtype=occ_pool.dtype, device=occ_pool.device)
    flat[:n] = occ_pool.reshape(-1)
    occ = flat.index_fill_(0, addr, value)[:n].reshape(occ_pool.shape)
    return occ, _status_from_occupancy(occ)


def _scatter_pool_prob_add(occ_pool: torch.Tensor, addr: torch.Tensor, weights: torch.Tensor):
    """Probabilistic sensor update: int32 deltas accumulated per voxel, then
    one saturating clamp (insertSensorData, ProbVoxelMap.hpp:52-102).
    Voxels whose delta sums to 0 keep their value (UNKNOWN stays -128).
    Returns (occ_pool, derived status pool)."""
    n = occ_pool.numel()
    cnt = torch.zeros(n + 1, dtype=torch.int32, device=occ_pool.device).index_add_(0, addr, weights)[:n]
    cnt = cnt.reshape(occ_pool.shape)
    upd = (occ_pool.to(torch.int32) + cnt).clamp_(MIN_PROBABILITY, MAX_PROBABILITY).to(torch.int8)
    occ = torch.where(cnt != 0, upd, occ_pool)
    return occ, _status_from_occupancy(occ)


def _rebuild_programs(pool, slot_page, slot_within, page_coord, n_slots: int, n_pages: int, coarse_shape,
                      levels: int):
    """Tile summaries -> block summaries -> page statuses -> pyramid. One
    slot per block and one row per page: the scatters' destinations are
    distinct (H7)."""
    dev = pool.device
    bs = torch.zeros((page_coord.shape[0], PAGE), dtype=U8, device=dev)
    if n_slots:
        dest = slot_page[:n_slots].to(torch.int64) * PAGE + slot_within[:n_slots]
        bs.view(-1)[dest] = _or_summary(pool[:n_slots])
    coarse0 = torch.full(coarse_shape, NS_UNKNOWN, dtype=U8, device=dev)
    if n_pages:
        pc = page_coord[:n_pages].to(torch.int64)
        dest = (pc[:, 2] * coarse_shape[1] + pc[:, 1]) * coarse_shape[2] + pc[:, 0]
        coarse0.view(-1)[dest] = _or_summary(bs[:n_pages])
    return bs, tuple(_build_pyramid(coarse0, levels))


def robot_self_collision_clash(robot_links, side_length: float) -> bool:
    """Host cell-set self-collision test for insertRobotConfiguration: links
    clash iff two link clouds share a voxel (reads the clouds on the host)."""
    seen: set = set()
    clash = False
    for i in range(robot_links.num_clouds):
        cloud = robot_links.get_cloud(i)
        pts = cloud.cpu().numpy() if isinstance(cloud, torch.Tensor) else np.asarray(cloud, np.float32)
        cells = set(map(tuple, np.floor(pts.astype(np.float32) / side_length).astype(np.int64)))
        if seen & cells:
            clash = True
        seen |= cells
    return clash


def _free_box_cloud(points, side_length: float) -> np.ndarray:
    """NTree::build's free_bounding_box (NTree.h:127) as an explicit free
    cloud: the voxel centres of the points' box. Raises, touching no map
    state, when the box is too large to enumerate."""
    pts = points.cpu().numpy() if isinstance(points, torch.Tensor) else np.asarray(points, np.float32)
    pts = pts.astype(np.float32).reshape(-1, 3)
    lo = np.floor(pts.min(axis=0) / side_length).astype(np.int64)
    hi = np.floor(pts.max(axis=0) / side_length).astype(np.int64)
    n_box = int(np.prod(hi - lo + 1))
    if n_box > 64 * 1024 * 1024:
        raise ValueError(f"free bounding box spans {n_box} voxels; carve free space "
                         "incrementally via insert_point_cloud_with_free_space instead")
    xs, ys, zs = (np.arange(lo[i], hi[i] + 1) for i in range(3))
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    out = (np.stack([gx, gy, gz], axis=-1).reshape(-1, 3) + 0.5) * side_length
    return out.astype(np.float32)


def _free_ray_cells(pts: torch.Tensor, origin: torch.Tensor, side_length: float, dims: Dims, max_steps: int,
                    voff=None):
    """(int32[S, N, 3] visited voxel coords, bool[S, N] live) of the rays
    origin -> point: one dominant-axis voxel a step, the endpoint voxel
    excluded (VoxelMapOperations.h:199-323), at most max_steps cells. A ray
    to a point at or below -1e8, or to a non-finite point, is dead. Every
    f32 operation is one torch op in the reference's order
    (`start + step * k` rounds the product and the sum on their own, F11).
    The ray is walked in the global frame and only its cells are shifted
    by `voff`."""
    recip = float(np.float32(1.0 / float(side_length)))  # insert.map_to_voxels' reciprocal
    start_v = origin * recip
    delta = pts * recip - start_v[None, :]
    dominant = delta.abs().amax(dim=-1)
    real = torch.all(pts > -1e8, dim=-1)
    n_steps = torch.where(real, floor_to_int32(torch.ceil(dominant)), 0)
    inv = torch.where(n_steps > 0, 1.0 / n_steps.to(torch.float32).clamp(min=1.0), 0.0)
    step_vec = delta * inv[:, None]
    ks = torch.arange(int(max_steps), dtype=torch.int32, device=pts.device)
    pos = start_v + step_vec[None, :, :] * ks.to(torch.float32)[:, None, None]
    coords = torch.floor(pos.clamp_(-1.0, 2.0**30)).to(torch.int32)
    if voff is not None:
        coords = shifted(coords, voff, -1)
    live = (ks[:, None] < n_steps[None, :]) & in_map(coords, dims)
    return coords, live


def _probe_occupancy(occ_pool: torch.Tensor, state, coords: torch.Tensor) -> torch.Tensor:
    """int8 log-odds at in-range coords; unallocated space reads UNKNOWN."""
    addr, ok = _pool_address(state, coords, torch.ones(coords.shape[:-1], dtype=torch.bool, device=coords.device))
    occ = torch.take(occ_pool, addr.clamp(max=occ_pool.numel() - 1))
    return torch.where(ok, occ, UNKNOWN_PROBABILITY)


# -- collision programs --------------------------------------------------------
def _count_probe_hits(snap: PagedSnapshot, coords, valid, min_level: int, offset):
    return count_probe_hits(snap.probe_clamped, coords, valid, snap.dims, min_level, offset)


def _paged_collide_list(snap: PagedSnapshot, lst, min_level: int, offset):
    return count_part_hits(snap.probe_clamped, query_parts_of(lst), snap.device, snap.dims, min_level, offset)


def _paged_collide_coords(snap: PagedSnapshot, coords, min_level: int, offset):
    coords = to_device(coords, torch.int32, snap.device)
    valid = torch.ones(coords.shape[:-1], dtype=torch.bool, device=coords.device)
    return _count_probe_hits(snap, coords, valid, min_level, offset)


def _paged_collide_paged(snap: PagedSnapshot, other: PagedSnapshot, min_level: int) -> torch.Tensor:
    """NTree x NTree (intersect_load_balance, NTree.hpp:1139): the other
    octree's exact occupied set probed in self."""
    coords, valid = other.occupied_cells()
    return _count_probe_hits(snap, coords, valid, min_level, (0, 0, 0))[0]


def _paged_collide_hier(snap: PagedSnapshot, hier, min_level: int, offset) -> torch.Tensor:
    """Paged octree x dense hierarchy: self's occupied set probed in the
    dense pyramid (over its padded dims); the count is symmetric. The
    offset translates the other map into self's frame, so self's cells map
    back at coords - offset."""
    coords, valid = snap.occupied_cells()
    c = shifted(coords, offset, -1)
    pd = hier.padded_dims
    occ, _, _ = hier.probe_clamped(clamp_coords(c, pd), min_level)
    return (occ & valid & in_map(c, pd)).sum(dtype=torch.int64)


def _paged_collide_dense_probed(snap: PagedSnapshot, other, min_level: int, offset):
    """Paged octree x dense map at any level: self probed at every map voxel
    + offset (the literal intersect_sparse direction), a sharded map slab by
    slab."""
    return count_part_hits(snap.probe_clamped, query_parts_of(other), snap.device, snap.dims, min_level, offset)


def _paged_collide_dense(snap: PagedSnapshot, other, offset) -> torch.Tensor:
    """Paged octree x dense voxel map at level 0 (intersect_load_balance
    (ProbVoxelMap&), NTree.hpp:1006): self's occupied set gathers the map,
    a sharded map each cell from the slab that owns it. Map occupancy is the
    octree probe's rule (`probe_occupied`)."""
    from ..parallel.shard_value import take_from_slabs

    coords, valid = snap.occupied_cells()
    c = shifted(coords, offset, -1)
    lin = linear_index(clamp_coords(c, other.dims), other.dims)
    return (take_from_slabs(other, lin, probe_occupied) & valid & in_map(c, other.dims)).sum(dtype=torch.int64)


class PagedHierarchicalMap(DiskIO):
    """Sparse hierarchical map (GvlNTree-scale worlds), deterministic or
    probabilistic (`occ_pool`). Host-stateful: inserts grow its tensors and
    return the map itself.

    Device state: the coarse status pyramid over pages, the sorted page-key
    directory (skeys / srows int32[D], D a power of two), per page the
    block -> slot row (pages int32[NP, 512]) and the block summaries
    (uint8[NP, 512]), the tile pool uint8[NT, 512] and per slot its block
    coords, page row and index within the page. Host state: the page and
    slot counts and the page-key -> row and block-key -> slot directories.
    """

    def __init__(self, dims: Dims, side_length: float = 1.0, probabilistic: bool = False, device=None):
        if any(d % PAGE_EDGE for d in dims):
            raise ValueError(f"dims must be multiples of {PAGE_EDGE}")
        if (dims[0] // PAGE_EDGE) * (dims[1] // PAGE_EDGE) * (dims[2] // PAGE_EDGE) >= 2**31:
            raise ValueError("page count must fit int32 (dims <= 65536^3)")
        dev = resolve_device(device)
        self.dims = tuple(int(d) for d in dims)
        self.side_length = float(side_length)
        self.probabilistic = bool(probabilistic)
        self.map_type = MapType.MT_PROBAB_OCTREE if probabilistic else MapType.MT_BITVECTOR_OCTREE
        self.cdims = tuple(d // B for d in self.dims)  # blocks per axis
        self.sdims = tuple(d // PAGE_EDGE for d in self.dims)  # pages per axis
        # up to 16 levels: a 65536^3 world's 1024^3 page grid needs 10
        self.levels = _num_levels(self.sdims, cap=16)
        pd = _pad_dims(self.sdims, self.levels)
        self._coarse_shape = (pd[2], pd[1], pd[0])
        self.pyramid = tuple(_build_pyramid(torch.full(self._coarse_shape, NS_UNKNOWN, dtype=U8, device=dev),
                                            self.levels))
        self.skeys = torch.full((1,), INT32_MAX, dtype=torch.int32, device=dev)
        self.srows = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.pages = torch.full((1, PAGE), -1, dtype=torch.int32, device=dev)
        self.block_summaries = torch.zeros((1, PAGE), dtype=U8, device=dev)
        self.page_coord = torch.zeros((1, 3), dtype=torch.int32, device=dev)  # (px, py, pz) per page row
        self.pool = torch.zeros((1, TILE), dtype=U8, device=dev)
        # the probabilistic tier (GvlNTreeProb, Octree.cu:71): int8 log-odds
        # per fine voxel; the status pool above is derived from it
        self.occ_pool = (torch.full((1, TILE), UNKNOWN_PROBABILITY, dtype=torch.int8, device=dev)
                         if probabilistic else None)
        self.slot_block = torch.zeros((1, 3), dtype=torch.int32, device=dev)
        self.slot_page = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.slot_within = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._n_pages = 0
        self._n_slots = 0
        self._page_of: dict = {}  # page key -> page row
        self._slot_of: dict = {}  # block key -> tile slot

    @property
    def device(self) -> torch.device:
        return self.pool.device

    @property
    def fine_levels(self) -> int:
        """Octree height in fine-voxel levels (the reference's level count)."""
        return self.levels + 6

    # -- host-side allocation -------------------------------------------------
    @staticmethod
    def _ensure_capacity(arr: torch.Tensor, n_needed: int, fill) -> torch.Tensor:
        cap = arr.shape[0]
        if n_needed <= cap:
            return arr
        grown = torch.full((max(n_needed, cap * 2),) + tuple(arr.shape[1:]), fill, dtype=arr.dtype, device=arr.device)
        grown[:cap] = arr
        return grown

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return to_device(np.ascontiguousarray(a), torch.int64, self.device)

    def _allocate(self, blocks_np) -> None:
        """Host: a tile slot (and its page) for every block (bx, by, bz) not
        allocated yet, in first-appearance order: pages and slots take the
        next free numbers, as the reference's loop gives them."""
        blocks = np.asarray(blocks_np, np.int64).reshape(-1, 3)
        cx, cy, _ = self.cdims
        sx, sy, _ = self.sdims
        keys = (blocks[:, 2] * cy + blocks[:, 1]) * cx + blocks[:, 0]
        _, first = np.unique(keys, return_index=True)
        first = np.sort(first)
        fresh = np.fromiter((k not in self._slot_of for k in keys[first].tolist()), bool, first.size)
        blocks, keys = blocks[first[fresh]], keys[first[fresh]]
        if not keys.size:
            return
        p = blocks // SB
        skeys = (p[:, 2] * sy + p[:, 1]) * sx + p[:, 0]
        uniq, first_p = np.unique(skeys, return_index=True)
        new_keys = [k for k in uniq[np.argsort(first_p)].tolist() if k not in self._page_of]
        rows0, slot0 = self._n_pages, self._n_slots
        self._page_of.update(zip(new_keys, range(rows0, rows0 + len(new_keys))))
        self._n_pages += len(new_keys)
        slots = np.arange(slot0, slot0 + keys.size, dtype=np.int64)
        self._slot_of.update(zip(keys.tolist(), slots.tolist()))
        self._n_slots += keys.size
        rows = np.fromiter((self._page_of[k] for k in skeys.tolist()), np.int64, skeys.size)
        within = ((blocks[:, 2] % SB) * SB + (blocks[:, 1] % SB)) * SB + blocks[:, 0] % SB
        if new_keys:
            self.pages = self._ensure_capacity(self.pages, self._n_pages, -1)
            self.block_summaries = self._ensure_capacity(self.block_summaries, self._n_pages, 0)
            self.page_coord = self._ensure_capacity(self.page_coord, self._n_pages, 0)
            nk = np.asarray(new_keys, np.int64)
            page_xyz = np.stack([nk % sx, (nk // sx) % sy, nk // (sx * sy)], axis=1)
            self.page_coord = self.page_coord.index_put(
                (self._upload(np.arange(rows0, self._n_pages)),), self._upload(page_xyz).to(torch.int32))
            # the sorted directory, padded to a power of two with INT32_MAX
            # keys, the reference's layout (so memory_usage agrees)
            npg = len(self._page_of)
            dkeys = np.fromiter(self._page_of.keys(), np.int64, npg)
            drows = np.fromiter(self._page_of.values(), np.int64, npg)
            order = np.argsort(dkeys)
            cap = 1 << (npg - 1).bit_length() if npg else 1
            sk = np.full(cap, INT32_MAX, np.int64)
            sr = np.zeros(cap, np.int64)
            sk[:npg], sr[:npg] = dkeys[order], drows[order]
            self.skeys = self._upload(sk).to(torch.int32)
            self.srows = self._upload(sr).to(torch.int32)
        self.pool = self._ensure_capacity(self.pool, self._n_slots, 0)
        if self.probabilistic:
            self.occ_pool = self._ensure_capacity(self.occ_pool, self._n_slots, UNKNOWN_PROBABILITY)
        self.slot_block = self._ensure_capacity(self.slot_block, self._n_slots, 0)
        self.slot_page = self._ensure_capacity(self.slot_page, self._n_slots, 0)
        self.slot_within = self._ensure_capacity(self.slot_within, self._n_slots, 0)
        # one slot per new block: every destination below is distinct (H7)
        slots_t, rows_t, within_t = self._upload(slots), self._upload(rows), self._upload(within)
        self.pages = self.pages.index_put((rows_t, within_t), slots_t.to(torch.int32))
        self.slot_page = self.slot_page.index_put((slots_t,), rows_t.to(torch.int32))
        self.slot_within = self.slot_within.index_put((slots_t,), within_t.to(torch.int32))
        self.slot_block = self.slot_block.index_put((slots_t,), self._upload(blocks).to(torch.int32))

    def snapshot(self) -> PagedSnapshot:
        """A frozen view for the checker (tensors by reference; updates make
        new tensors, so the view keeps this state)."""
        return PagedSnapshot(self.pyramid, self.skeys, self.srows, self.pages, self.block_summaries, self.pool,
                             self.slot_block, self._n_slots, self.dims, self.sdims, self.levels, self.side_length)

    # -- insertion --------------------------------------------------------------
    def _allocate_for(self, coords: torch.Tensor, inside: torch.Tensor) -> None:
        """Host: tiles for the blocks the coords touch. A steady-state insert
        reads one scalar; an allocating one reads the new-block count and
        then only the list of new blocks, O(new tiles), never O(points)."""
        if self._n_slots and not bool(_host_fetch(_needs_allocation(self, coords, inside))):
            return
        n_new, blocks = _new_tile_blocks(self, coords, inside)
        n = int(_host_fetch(n_new))
        if n:
            self._allocate(_host_fetch(blocks[:n]))

    def _points(self, points) -> torch.Tensor:
        return to_device(points, torch.float32, self.device).reshape(-1, 3)

    @staticmethod
    def _voff(voxel_offset):
        return None if voxel_offset is None else tuple(int(v) for v in np.asarray(voxel_offset).ravel())

    def insert_point_cloud(self, points, meaning=BitVoxelMeaning.eBVM_OCCUPIED, static_map: bool = True,
                           voxel_offset=None) -> "PagedHierarchicalMap":
        """Point insert (setOccupied / insertNode, kernel_common.h:186-245).
        Deterministic tier: eBVM_FREE hard free, every other meaning hard
        occupied, tagged ns_STATIC_MAP or ns_DYNAMIC_MAP. Probabilistic tier:
        the voxels take the meaning's probability. `voxel_offset` shifts
        the voxelized coords after the global boundary decision."""
        coords, inside = _voxelize_points(self._points(points), self.side_length, self.dims,
                                          self._voff(voxel_offset))
        self._allocate_for(coords, inside)
        addr, _ = _pool_address(self, coords, inside)
        if self.probabilistic:
            self.occ_pool, self.pool = _scatter_pool_prob_set(self.occ_pool, addr, meaning_to_probability(meaning))
        else:
            occ_bit = NS_FREE if int(meaning) == int(BitVoxelMeaning.eBVM_FREE) else NS_OCCUPIED
            self.pool = _scatter_pool(self.pool, addr, occ_bit, NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP)
        self._rebuild_coarse()
        return self

    def insert_point_cloud_with_free_space(self, points, sensor_origin=(0.0, 0.0, 0.0), max_steps: int = 128,
                                           static_map: bool = False, voxel_offset=None) -> "PagedHierarchicalMap":
        """insertPointCloudWithFreespaceCalculation (GvlNTree.hpp:108-130) on
        the sparse tier: rays step one dominant-axis voxel at a time, the
        endpoint voxel excluded, at most max_steps cells. Deterministic tier:
        the ray cells hard FREE, then the hits hard OCCUPIED (hits win).
        Probabilistic tier: one log-odds update per cell, hits x
        SENSOR_MODEL_OCCUPIED + crossings x SENSOR_MODEL_FREE, one clamp."""
        pts = self._points(points)
        voff = self._voff(voxel_offset)
        origin = to_device(np.asarray(sensor_origin, np.float32), torch.float32, self.device)
        ray_coords, live = _free_ray_cells(pts, origin, self.side_length, self.dims, max_steps, voff)
        hit_coords, hit_inside = _voxelize_points(pts, self.side_length, self.dims, voff)
        rc = clamp_coords(ray_coords.reshape(-1, 3), self.dims)
        live = live.reshape(-1)
        all_coords = torch.cat([rc, hit_coords])
        all_inside = torch.cat([live, hit_inside])
        self._allocate_for(all_coords, all_inside)
        if not self.probabilistic:
            flag = NS_STATIC_MAP if static_map else NS_DYNAMIC_MAP
            self.pool = _scatter_pool(self.pool, _pool_address(self, rc, live)[0], NS_FREE, flag)
            self.pool = _scatter_pool(self.pool, _pool_address(self, hit_coords, hit_inside)[0], NS_OCCUPIED, flag)
        else:
            weights = torch.cat([torch.full((rc.shape[0],), SENSOR_MODEL_FREE, dtype=torch.int32, device=self.device),
                                 torch.full((hit_coords.shape[0],), SENSOR_MODEL_OCCUPIED, dtype=torch.int32,
                                            device=self.device)])
            addr, _ = _pool_address(self, all_coords, all_inside)
            self.occ_pool, self.pool = _scatter_pool_prob_add(self.occ_pool, addr, weights)
        self._rebuild_coarse()
        return self

    def insert_depth_image(self, depth, sensor, max_steps: int = 128, voxel_offset=None) -> "PagedHierarchicalMap":
        """The octree sensor pipeline (Sensor.cu processSensorData): back-project
        the depth image, transform it into the world frame, then the
        ray-carved insert from the sensor's position. Invalid pixels cast no
        ray."""
        depth = to_device(depth, torch.float32, self.device)
        pose = sensor.pose()
        pts = raycast.depth_image_to_point_cloud(depth, sensor.fx, sensor.fy, sensor.cx, sensor.cy,
                                                 sensor.invalid_value)
        world = transforms.transform_points(to_device(pose, torch.float32, self.device), pts)
        finite = torch.all(torch.isfinite(world), dim=-1)
        world = torch.where(finite[:, None], world, -1e9)
        return self.insert_point_cloud_with_free_space(world, tuple(float(v) for v in pose[:3, 3]),
                                                       max_steps=max_steps, voxel_offset=voxel_offset)

    def _rebuild_coarse(self) -> None:
        """Tile summaries -> block summaries -> page statuses -> pyramid."""
        if self._n_slots == 0:
            return
        self.block_summaries, self.pyramid = _rebuild_programs(
            self.pool, self.slot_page, self.slot_within, self.page_coord, self._n_slots, self._n_pages,
            self._coarse_shape, self.levels)

    # -- probing ----------------------------------------------------------------
    def probe_status(self, coords, min_level: int = 0) -> torch.Tensor:
        return self.snapshot().probe_status(coords, min_level)

    def probe(self, coords, min_level: int = 0):
        return self.snapshot().probe(coords, min_level)

    def probe_occupancy(self, coords) -> torch.Tensor:
        """int8 log-odds per fine voxel (probabilistic tier only); unallocated
        space reads UNKNOWN_PROBABILITY. Out-of-range coords clamp."""
        if not self.probabilistic:
            raise TypeError("probe_occupancy requires a probabilistic paged map")
        c = clamp_coords(to_device(coords, torch.int32, self.device), self.dims)
        return _probe_occupancy(self.occ_pool, self, c)

    def clear_map(self) -> "PagedHierarchicalMap":
        """Every page and tile dropped: the pristine UNKNOWN world."""
        self.__init__(self.dims, self.side_length, self.probabilistic, device=self.device)
        return self

    def build(self, points, free_bounding_box: bool = False) -> "PagedHierarchicalMap":
        """NTree::build (NTree.hpp:385-540): rebuild from a point set; with
        free_bounding_box the points' voxel box is first inserted FREE as
        explicit points. The box is checked before the map is cleared."""
        free = _free_box_cloud(points, self.side_length) if free_bounding_box else None
        self.clear_map()
        if free is not None:
            self.insert_point_cloud(free, BitVoxelMeaning.eBVM_FREE)
        return self.insert_point_cloud(points, BitVoxelMeaning.eBVM_OCCUPIED)

    def insert_meta_point_cloud(self, meta, meanings=None) -> "PagedHierarchicalMap":
        """insertMetaPointCloud (GvlNTree.hpp:437-453): the first meaning."""
        return self.insert_point_cloud(meta.points, meta_first_meaning(meanings))

    def insert_robot_configuration(self, robot_links, with_self_collision_test: bool = False):
        """insertRobotConfiguration (GpuVoxelsMap contract). Returns (map, ok)."""
        ok = True
        if with_self_collision_test:
            ok = not robot_self_collision_clash(robot_links, self.side_length)
        return self.insert_meta_point_cloud(robot_links), ok

    def clear_voxel_meaning(self, meaning) -> "PagedHierarchicalMap":
        """clearBitVoxelMeaning (GvlNTree.hpp:487-494): only eBVM_OCCUPIED,
        which resets the map."""
        if int(meaning) != int(BitVoxelMeaning.eBVM_OCCUPIED):
            _log.error("octree maps only clear eBVM_OCCUPIED")
            return self
        return self.clear_map()

    # -- NTree maintenance contract ---------------------------------------------
    def needs_rebuild(self) -> bool:
        """NTree::needsRebuild: tiles are never freed one by one."""
        return False

    def rebuild(self) -> "PagedHierarchicalMap":
        """NTree::rebuild: defragmentation, a no-op."""
        return self

    def check_tree(self) -> bool:
        """NTree::checkTree (NTree.h:267-271): the block summaries and the page
        pyramid recomputed from the pool equal the maintained ones (host read)."""
        if self._n_slots == 0:
            return True
        want_blocks, want_pyr = _rebuild_programs(self.pool, self.slot_page, self.slot_within, self.page_coord,
                                                  self._n_slots, self._n_pages, self._coarse_shape, self.levels)
        if not torch.equal(want_blocks, self.block_summaries):
            return False
        return all(torch.equal(w, p) for w, p in zip(want_pyr, self.pyramid))

    def clear_collision_flags(self) -> "PagedHierarchicalMap":
        """NTree::clearCollisionFlags: nothing is stored in the nodes."""
        return self

    def collide_with_coords(self, coords, min_level: int = 0, offset=(0, 0, 0)) -> torch.Tensor:
        return _paged_collide_coords(self.snapshot(), coords, min_level, offset)[0]

    def collide_with(self, other, min_level: int = 0, offset=(0, 0, 0)) -> torch.Tensor:
        """collideWith on the sparse octree (GvlNTree.hpp:150-330): a voxel
        list is probed at its coords + offset; a dense voxel map at level 0
        is gathered at self's occupied set (the same count,
        NTree.hpp:1006), at coarser levels probed voxel by voxel; an octree
        (paged or dense, a sharded pyramid too) is intersected without an
        offset."""
        from ..parallel.shard_value import operand_class
        from .voxellist import VoxelList
        from .voxelmap import BitVectorVoxelMap, ProbVoxelMap

        off = tuple(int(v) for v in np.asarray(offset).ravel())
        if isinstance(other, VoxelList):
            return _paged_collide_list(self.snapshot(), other, min_level, off)[0]
        if isinstance(other, PagedHierarchicalMap):
            _reject_octree_offset(off)
            return _paged_collide_paged(self.snapshot(), other.snapshot(), min_level)
        if isinstance(other, _PyramidQueries) or _is_sharded_pyramid(other):
            _reject_octree_offset(off)
            return _paged_collide_hier(self.snapshot(), other, min_level, (0, 0, 0))
        if issubclass(operand_class(other), (ProbVoxelMap, BitVectorVoxelMap)):
            if min_level == 0:
                return _paged_collide_dense(self.snapshot(), other, off)
            return _paged_collide_dense_probed(self.snapshot(), other, min_level, off)[0]
        raise TypeError(type(other))

    def collide_with_resolution(self, other, coll_threshold: float = 1.0, resolution_level: int = 0,
                                offset=(0, 0, 0)) -> torch.Tensor:
        """collideWithResolution (GvlNTree.hpp:179-330); coll_threshold is
        ignored, as by the reference's hard-coded probe occupancy."""
        del coll_threshold
        if resolution_level > self.fine_levels:
            raise ValueError("resolution_level greater than octree height")
        return self.collide_with(other, min_level=int(resolution_level), offset=offset)

    def collide_with_counting_unknown(self, other, min_level: int = 0, offset=(0, 0, 0)):
        """collideWithTypesConsideringUnknownCells (GvlNTree.h:115-129):
        (collisions, unknown-cell hits); unallocated space reads unknown."""
        from .voxellist import VoxelList

        off = tuple(int(v) for v in np.asarray(offset).ravel())
        if isinstance(other, VoxelList):
            return _paged_collide_list(self.snapshot(), other, min_level, off)
        return _paged_collide_dense_probed(self.snapshot(), other, min_level, off)

    def collide_with_counting_unknown_coords(self, coords, min_level: int = 0, offset=(0, 0, 0)):
        return _paged_collide_coords(self.snapshot(), coords, min_level, offset)

    # -- maintenance --------------------------------------------------------------
    def memory_usage(self) -> int:
        """Device bytes of the map's tensors, as the reference counts them."""
        tensors = [self.skeys, self.srows, self.pages, self.block_summaries, self.page_coord, self.pool,
                   self.slot_block, self.slot_page, self.slot_within, *self.pyramid]
        if self.probabilistic:
            tensors.append(self.occ_pool)
        return int(sum(t.numel() * t.element_size() for t in tensors))

    def n_tiles(self) -> int:
        return self._n_slots

    def extract_occupied_coords(self, max_out: Optional[int] = None) -> np.ndarray:
        """int32[K, 3] occupied fine coords, in slot order (extractCubes;
        host read)."""
        n = self._n_slots
        if n == 0:
            return np.zeros((0, 3), np.int32)
        pool = self.pool[:n].cpu().numpy()
        sb = self.slot_block[:n].cpu().numpy()
        slot_i, widx = np.nonzero((pool & STATUS_OCCUPANCY_MASK) == NS_OCCUPIED)
        wz, rem = widx // (B * B), widx % (B * B)
        out = np.stack([sb[slot_i, 0] * B + rem % B, sb[slot_i, 1] * B + rem // B, sb[slot_i, 2] * B + wz],
                       axis=1).astype(np.int32)
        return out[:max_out] if max_out is not None else out
