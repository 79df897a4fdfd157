"""Map disk serialization, byte-compatible with the reference.

Counterpart of gpu_voxels_tpu/utils/io.py for every single-device map tier:
a file written here equals, byte for byte, the one the JAX package
writes from the same content, and each package reads the other's files.

VoxelMap format (TemplateVoxelMap.hpp:666-713):
    int32 MapType | float32 side_length | 3 x uint32 dims | raw voxel array
where the raw array is int8 occupancy (prob, counting), uint32 packed
coordinates (distance), or 32 bytes a voxel of little-endian bit vector
(bit maps: voxel-major on disk, converted from and to the plane-major
planes on the maps' device).

VoxelList format (TemplateVoxelList.hpp:445-535):
    int32 MapType | 3 x uint32 ref dims | float32 side_length | uint32 count
    | ids | coords (3 x uint32 each) | voxel payloads
with uint32 ids in linear mode and the 60-bit Morton code as uint64 in
morton mode (``hi << 30 | lo``, which is the port's int64 list key).

Octree formats (NTree::serialize, NTree.hpp:3283-3400, binary and ascii):
the fine ground truth and metadata, with the pyramid and the summaries
rebuilt on load. The dense hierarchy writes its status grid (bit) or its
int8 occupancy grid (prob):
    header | int32 levels | 3 x int32 [Z, Y, X] shape | the grid
the paged tier its tile pool (int8 log-odds in the probabilistic tier) and
its blocks, in slot order, with the levels field negative:
    header | int32 -fine_levels | int32 n | int32[n, 3] blocks | n x 512 bytes
The ascii variants start with `GPU_VOXELS_TPU_OCTREE ascii v1`.
`write_map` / `read_map` dispatch on the map's type and the file's MapType.

The reference's optional native C++ fast path for bit-plane bodies is not
ported: the bodies are transposed on the device instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MapType
from . import resolve_device, to_device

_HEADER = np.dtype([("map_type", "<i4"), ("side_length", "<f4"), ("dims", "<u4", 3)])

MORTON_LIST_TYPES = (MapType.MT_BITVECTOR_MORTON_VOXELLIST, MapType.MT_PROBAB_MORTON_VOXELLIST)


def _write_planes_body(f, planes: torch.Tensor) -> None:
    """The voxel-major 32-byte records of int32[8, N] planes at f's position:
    the transpose runs where the planes live, then one copy to the host."""
    voxel_major = planes.t().contiguous().cpu().numpy()
    voxel_major.astype("<i4", copy=False).tofile(f)


def _read_planes_body(f, n: int, device) -> torch.Tensor:
    """n voxel-major 32-byte records at f's position as int32[8, n] planes."""
    raw = np.frombuffer(f.read(n * 32), "<i4", n * 8).reshape(n, 8).astype(np.int32)
    return torch.from_numpy(raw).to(device).t().contiguous()


def _header(m) -> bytes:
    """MapType, side length and dims: the header of the dense and octree files."""
    header = np.zeros((), dtype=_HEADER)
    header["map_type"] = int(m.map_type)
    header["side_length"] = m.side_length
    header["dims"] = m.dims
    return header.tobytes()


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


def write_voxel_map(m, path) -> None:
    """writeToDisk of a dense map: ProbVoxelMap, BitVectorVoxelMap,
    CountingVoxelMap or DistanceVoxelMap."""
    write_voxel_map_slabs(m, [m], path)


def write_voxel_map_slabs(m, slabs, path) -> None:
    """writeToDisk of a dense map held as z-slabs (dense maps of its class,
    the grid's z-major order): `m`'s header, then each slab's body in turn,
    one host read a slab. The bytes are the whole map's file."""
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

    if not all(isinstance(s, (ProbVoxelMap, CountingVoxelMap, BitVectorVoxelMap, DistanceVoxelMap)) for s in slabs):
        raise TypeError(type(slabs[0]))
    with open(path, "wb") as f:
        f.write(_header(m))
        for s in slabs:
            if isinstance(s, BitVectorVoxelMap):
                _write_planes_body(f, s.data)
            elif isinstance(s, DistanceVoxelMap):
                _host(s.data, "<i4").tofile(f)  # the int32 view of the uint32 packed coordinates
            else:
                _host(s.data, np.int8).tofile(f)


def read_voxel_map(path, device=None):
    """readFromDisk of a dense map file; the map lands on `device` (default:
    the card)."""
    maps, _ = read_voxel_map_slabs(path, [resolve_device(device)])
    return maps[0]


def read_voxel_map_slabs(path, devices) -> tuple:
    """A dense map file read as len(devices) equal z-slabs, slab k's body
    read straight onto devices[k]: (one map of the file's class per slab,
    with dims (dx, dy, dz / slabs), the whole grid's dims). dimz must
    divide over the slabs."""
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

    with open(path, "rb") as f:
        header = np.frombuffer(f.read(_HEADER.itemsize), dtype=_HEADER)[0]
        map_type = MapType(int(header["map_type"]))
        side = float(header["side_length"])
        dims = tuple(int(v) for v in header["dims"])
        if dims[2] % len(devices):
            raise ValueError(f"map dimz {dims[2]} must divide over {len(devices)} slabs")
        local = (dims[0], dims[1], dims[2] // len(devices))
        n = local[0] * local[1] * local[2]
        maps = []
        for device in devices:
            device = resolve_device(device)
            if map_type == MapType.MT_PROBAB_VOXELMAP:
                maps.append(ProbVoxelMap(_int8_body(f, n, device), local, side))
            elif map_type == MapType.MT_BITVECTOR_VOXELMAP:
                maps.append(BitVectorVoxelMap.from_planes(_read_planes_body(f, n, device), local, side))
            elif map_type == MapType.MT_DISTANCE_VOXELMAP:
                data = np.frombuffer(f.read(n * 4), "<i4", n).astype(np.int32)
                maps.append(DistanceVoxelMap(torch.from_numpy(data).to(device), local, side))
            elif map_type == MapType.MT_COUNTING_VOXELLIST:
                maps.append(CountingVoxelMap(_int8_body(f, n, device), local, side))
            else:
                raise ValueError(f"unknown map type {map_type}")
    return maps, dims


def _int8_body(f, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(f.read(n), np.int8, n).copy()).to(device)


def write_voxel_list(lst, path) -> None:
    """writeToDisk of a VoxelList: its `count` live entries (one host read)."""
    from ..maps.voxellist import KIND_BIT

    n = int(lst.count)
    keys = lst.keys[:n]
    ids = _host(keys, "<u8" if lst.id_mode == "morton" else "<u4")
    coords = _host(lst.coords_from_ids(keys), "<u4")
    with open(path, "wb") as f:
        f.write(np.int32(int(lst.map_type)).tobytes())
        f.write(np.asarray(lst.dims, "<u4").tobytes())
        f.write(np.float32(lst.side_length).tobytes())
        f.write(np.uint32(n).tobytes())
        f.write(ids.tobytes())
        f.write(coords.tobytes())
        if lst.kind == KIND_BIT:
            _write_planes_body(f, lst.payload[:, :n])
        else:
            _host(lst.payload[:n], np.int8).tofile(f)


def read_voxel_list(path, device=None):
    """readFromDisk of a VoxelList file: a list of capacity `count`, on
    `device` (default: the card)."""
    from dataclasses import replace

    from ..maps.voxellist import KIND_BIT, KIND_COUNT, KIND_PROB, VoxelList

    device = resolve_device(device)
    with open(path, "rb") as f:
        map_type = MapType(int(np.frombuffer(f.read(4), "<i4")[0]))
        dims = tuple(int(v) for v in np.frombuffer(f.read(12), "<u4"))
        side = float(np.frombuffer(f.read(4), "<f4")[0])
        n = int(np.frombuffer(f.read(4), "<u4")[0])
        morton = map_type in MORTON_LIST_TYPES
        ids = np.frombuffer(f.read((8 if morton else 4) * n), "<u8" if morton else "<u4")
        f.read(12 * n)  # the coordinates follow from the ids
        kind = {
            MapType.MT_BITVECTOR_VOXELLIST: KIND_BIT,
            MapType.MT_BITVECTOR_MORTON_VOXELLIST: KIND_BIT,
            MapType.MT_PROBAB_VOXELLIST: KIND_PROB,
            MapType.MT_PROBAB_MORTON_VOXELLIST: KIND_PROB,
            MapType.MT_COUNTING_VOXELLIST: KIND_COUNT,
        }[map_type]
        payload = _read_planes_body(f, n, device) if kind == KIND_BIT else _int8_body(f, n, device)
    lst = VoxelList.create(dims, side, kind, n, "morton" if morton else "linear", map_type, device=device)
    if n == 0:
        return lst
    keys = torch.from_numpy(ids.astype(np.int64)).to(device)
    return replace(lst, keys=keys, payload=payload, count=torch.full((), n, dtype=torch.int64, device=device))


_ASCII_MAGIC = b"GPU_VOXELS_TPU_OCTREE ascii v1"
OCTREE_TYPES = (MapType.MT_PROBAB_OCTREE, MapType.MT_BITVECTOR_OCTREE)
LIST_TYPES = (MapType.MT_BITVECTOR_VOXELLIST, MapType.MT_BITVECTOR_MORTON_VOXELLIST, MapType.MT_PROBAB_VOXELLIST,
              MapType.MT_PROBAB_MORTON_VOXELLIST, MapType.MT_COUNTING_VOXELLIST)


def _write_octree_ascii_header(f, map_type: int, side_length: float, dims, levels: int) -> None:
    f.write(_ASCII_MAGIC + b"\n")
    # side_length is float32 in the binary header; hex keeps the round trip exact
    f.write((f"map_type {map_type}\nside_length {float(np.float32(side_length)).hex()}\n"
             f"dims {dims[0]} {dims[1]} {dims[2]}\nlevels {levels}\n").encode())


def write_hierarchical_map(h, path, ascii: bool = False) -> None:
    """A dense hierarchy's fine grid and metadata: the status grid of a
    HierarchicalBitMap, the occupancy grid of a HierarchicalProbMap. The
    body is z-major, so a sharded pyramid writes its slabs' rows in turn
    (ShardedPyramid.fine_slabs): one host read a slab, the whole map's bytes."""
    from ..maps.hierarchical import HierarchicalBitMap
    from ..parallel.shard_value import ShardedPyramid

    if isinstance(h, ShardedPyramid):
        parts = h.fine_slabs()
    else:
        parts = [h.status if isinstance(h, HierarchicalBitMap) else h.occupancy]
    shape = (sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:])
    with open(path, "wb") as f:
        if ascii:
            _write_octree_ascii_header(f, int(h.map_type), h.side_length, h.dims, h.levels)
            f.write(("shape %d %d %d\n" % shape).encode())
        else:
            f.write(_header(h))
            f.write(np.int32(h.levels).tobytes())
            f.write(np.asarray(shape, "<i4").tobytes())
        for p in parts:
            fine = p.cpu().numpy()
            if ascii:
                np.savetxt(f, fine.reshape(fine.shape[0], -1), fmt="%d")
            else:
                fine.tofile(f)


def write_paged_map(m, path, ascii: bool = False) -> None:
    """A paged map's blocks and tile pool in slot order (host read); the
    directory, the summaries and the pyramid are rebuilt on load."""
    n = m.n_tiles()
    slot_block = _host(m.slot_block[:n], "<i4")
    pool = _host(m.occ_pool[:n], np.int8) if m.probabilistic else _host(m.pool[:n], np.uint8)
    with open(path, "wb") as f:
        if ascii:
            _write_octree_ascii_header(f, int(m.map_type), m.side_length, m.dims, -m.fine_levels)
            f.write(f"tiles {n}\n".encode())
            if n:  # one line per tile: its block coords, then its 512 cells
                np.savetxt(f, np.concatenate([slot_block, pool.astype("<i4")], axis=1), fmt="%d")
            return
        f.write(_header(m))
        f.write(np.int32(-m.fine_levels).tobytes())
        f.write(np.int32(n).tobytes())
        slot_block.tofile(f)
        pool.tofile(f)


def _paged_from_tiles(map_type, dims, side: float, slot_block: np.ndarray, pool, device):
    """A paged map holding these tiles: allocating the blocks in file (slot)
    order gives back the written slot and page numbering. `pool` is a host
    array or a tensor."""
    from ..maps.hierarchical import _status_from_occupancy
    from ..maps.paged import PagedHierarchicalMap

    prob = map_type == MapType.MT_PROBAB_OCTREE
    m = PagedHierarchicalMap(dims, side, probabilistic=prob, device=device)
    n = slot_block.shape[0]
    if n:
        m._allocate(slot_block)
        dtype = torch.int8 if prob else torch.uint8
        body = to_device(pool if isinstance(pool, torch.Tensor) else np.ascontiguousarray(pool), dtype, m.device)
        if prob:
            m.occ_pool = m.occ_pool.clone()
            m.occ_pool[:n] = body
            m.pool = m.pool.clone()
            m.pool[:n] = _status_from_occupancy(body)
        else:
            m.pool = m.pool.clone()
            m.pool[:n] = body
        m._rebuild_coarse()
    return m


def _hierarchy_from_fine(map_type, dims, side: float, levels: int, fine: np.ndarray, device):
    from ..maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap, _build_pyramid, _status_from_occupancy

    if map_type == MapType.MT_BITVECTOR_OCTREE:
        s0 = torch.from_numpy(np.ascontiguousarray(fine).astype(np.uint8)).to(device)
        return HierarchicalBitMap(tuple(_build_pyramid(s0, levels)), dims, side, levels)
    occ = torch.from_numpy(np.ascontiguousarray(fine).astype(np.int8)).to(device)
    return HierarchicalProbMap(occ, tuple(_build_pyramid(_status_from_occupancy(occ), levels)), dims, side, levels)


def _octree_head(f) -> tuple:
    """Either octree file's metadata, f left at its body: (map_type, dims,
    side, levels, ascii, args), args the paged body's [n tiles] (levels
    < 0) or the dense body's [Z, Y, X] shape."""
    if f.read(len(_ASCII_MAGIC)) == _ASCII_MAGIC:
        f.readline()
        fields = {}
        for _ in range(4):
            k, v = f.readline().decode().split(None, 1)
            fields[k] = v.strip()
        levels = int(fields["levels"])
        parts = f.readline().decode().split()
        args = [int(v) for v in parts[1:]]
        if levels >= 0 and (parts[0] != "shape" or len(args) != 3):
            raise ValueError(f"not an octree ascii body: {parts}")
        return (MapType(int(fields["map_type"])), tuple(int(v) for v in fields["dims"].split()),
                float.fromhex(fields["side_length"]), levels, True, args)
    f.seek(0)
    header = np.frombuffer(f.read(_HEADER.itemsize), dtype=_HEADER)[0]
    levels = int(np.frombuffer(f.read(4), "<i4")[0])
    args = [int(v) for v in np.frombuffer(f.read(4 if levels < 0 else 12), "<i4")]
    return (MapType(int(header["map_type"])), tuple(int(v) for v in header["dims"]), float(header["side_length"]),
            levels, False, args)


def _fine_dtype(map_type):
    return np.uint8 if map_type == MapType.MT_BITVECTOR_OCTREE else np.int8


def is_paged_octree(path) -> bool:
    """An octree file whose body is the paged tier's (levels field < 0)."""
    with open(path, "rb") as f:
        return _octree_head(f)[3] < 0


def read_hierarchical_map(path, device=None):
    """Either octree tier's file, binary or ascii, on `device` (default: the
    card): a negative levels field marks the paged body."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        map_type, dims, side, levels, ascii, args = _octree_head(f)
        if levels < 0:
            from ..maps.paged import TILE

            n = args[0]
            if ascii:  # one line per tile: its block coords, then its 512 cells
                body = np.loadtxt(f, dtype=np.int64, ndmin=2) if n else np.zeros((0, 3 + TILE), np.int64)
                return _paged_from_tiles(map_type, dims, side, body[:, :3], body[:, 3:], device)
            slot_block = np.frombuffer(f.read(n * 12), "<i4").reshape(n, 3)
            pool = np.frombuffer(f.read(n * TILE), _fine_dtype(map_type)).reshape(n, TILE)
            return _paged_from_tiles(map_type, dims, side, slot_block, pool, device)
        if ascii:
            fine = np.loadtxt(f, dtype=np.int64, ndmin=2).reshape(args)
        else:
            fine = np.frombuffer(f.read(), _fine_dtype(map_type)).reshape(args)
    return _hierarchy_from_fine(map_type, dims, side, levels, fine, device)


def read_hierarchical_slabs(path, devices) -> tuple:
    """A dense hierarchy's octree file, its fine grid read as len(devices)
    equal z-slabs, slab k's rows read straight onto devices[k] (one whole
    part on devices[0] where the padded z extent does not divide):
    (map_type, dims, side, levels, [uint8 or int8 [zl, Y, X] slabs])."""
    with open(path, "rb") as f:
        map_type, dims, side, levels, ascii, args = _octree_head(f)
        if levels < 0:
            raise ValueError("a paged octree body has no z-slabs: read_hierarchical_map reads it whole")
        z, y, x = args
        if z % len(devices):
            devices = devices[:1]
        zl = z // len(devices)
        dtype = _fine_dtype(map_type)
        parts = []
        for device in devices:
            if ascii:
                rows = np.loadtxt([f.readline().decode() for _ in range(zl)], dtype=np.int64, ndmin=2)
                fine = rows.astype(dtype)
            else:
                fine = np.frombuffer(f.read(zl * y * x), dtype).copy()
            parts.append(torch.from_numpy(fine.reshape(zl, y, x)).to(resolve_device(device)))
    return map_type, dims, side, levels, parts


def write_map(m, path) -> None:
    """writeToDisk of any ported map (GpuVoxelsMap.h:200-204): each type to
    its reference format. A ShardedPagedWorld writes the single-device paged
    format (its slabs gathered, as the reference's io.py:397-401 does); a
    slab-sharded dense map or pyramid writes the single-device map's bytes
    slab by slab (its own write_to_disk): the bytes the reference writes of
    its sharded arrays."""
    from ..maps.hierarchical import _PyramidQueries
    from ..maps.paged import PagedHierarchicalMap
    from ..maps.voxellist import VoxelList
    from ..parallel.paged_world import ShardedPagedWorld
    from ..parallel.shard_value import _ShardedValue

    if isinstance(m, _ShardedValue):
        m.write_to_disk(path)
        return
    if isinstance(m, VoxelList):
        write_voxel_list(m, path)
    elif isinstance(m, ShardedPagedWorld):
        write_paged_map(m.to_paged_map(), path)
    elif isinstance(m, PagedHierarchicalMap):
        write_paged_map(m, path)
    elif isinstance(m, _PyramidQueries):
        write_hierarchical_map(m, path)
    else:
        write_voxel_map(m, path)


def _file_map_type(path) -> MapType:
    with open(path, "rb") as f:
        head = f.read(len(_ASCII_MAGIC))
    if head == _ASCII_MAGIC:
        with open(path, "rb") as f:
            f.readline()
            return MapType(int(f.readline().decode().split()[1]))
    return MapType(int(np.frombuffer(head[:4], "<i4")[0]))


def read_map(path, device=None):
    """readFromDisk dispatch on the file's MapType (GpuVoxelsMap.h:205-209).
    As in the reference, a CountingVoxelMap's file (MT_COUNTING_VOXELLIST)
    goes to the list reader; `DiskIO.read_from_disk` reads each map with its
    own tier's reader instead (F14)."""
    map_type = _file_map_type(path)
    if map_type in OCTREE_TYPES:
        return read_hierarchical_map(path, device)
    if map_type in LIST_TYPES:
        return read_voxel_list(path, device)
    return read_voxel_map(path, device)


class DiskIO:
    """writeToDisk / readFromDisk (GpuVoxelsMap.h:200-209), mixed into every
    map tier. read_from_disk returns the loaded map (on this map's device);
    a file of another MapType raises ValueError where the reference logs and
    returns false. An octree map reads either octree body of its MapType.

    Each map reads with its own tier's reader. The reference dispatches on
    the file's MapType instead, which sends a CountingVoxelMap's file
    (MT_COUNTING_VOXELLIST, gpu_voxels_tpu/maps/voxelmap.py:678) to the
    list reader, so its CountingVoxelMap.read_from_disk raises (F14)."""

    def write_to_disk(self, path) -> bool:
        write_map(self, path)
        return True

    def read_from_disk(self, path):
        from ..maps.hierarchical import _PyramidQueries
        from ..maps.paged import PagedHierarchicalMap
        from ..maps.voxellist import VoxelList

        map_type = _file_map_type(path)
        if map_type != MapType(int(self.map_type)):
            raise ValueError(f"file holds {map_type.name}, map is {MapType(int(self.map_type)).name}")
        if isinstance(self, (_PyramidQueries, PagedHierarchicalMap)):
            reader = read_hierarchical_map
        else:
            reader = read_voxel_list if isinstance(self, VoxelList) else read_voxel_map
        return reader(path, device=self.device)
