"""Map disk serialization, byte-compatible with the reference.

Counterpart of gpu_voxels_tpu/utils/io.py for the dense maps and the voxel
lists: a file written here equals, byte for byte, the one the JAX package
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

The octree and paged formats and the type-dispatching `write_map` /
`read_map` are not ported yet (ROADMAP Queue 1 item 12). The reference's
optional native C++ fast path for bit-plane bodies is not ported: the bodies
are transposed on the device instead.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import MapType
from . import resolve_device

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


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    return t.cpu().numpy().astype(dtype, copy=False)


def write_voxel_map(m, path) -> None:
    """writeToDisk of a dense map: ProbVoxelMap, BitVectorVoxelMap,
    CountingVoxelMap or DistanceVoxelMap."""
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

    if not isinstance(m, (ProbVoxelMap, CountingVoxelMap, BitVectorVoxelMap, DistanceVoxelMap)):
        raise TypeError(type(m))
    header = np.zeros((), dtype=_HEADER)
    header["map_type"] = int(m.map_type)
    header["side_length"] = m.side_length
    header["dims"] = m.dims
    with open(path, "wb") as f:
        f.write(header.tobytes())
        if isinstance(m, BitVectorVoxelMap):
            _write_planes_body(f, m.data)
        elif isinstance(m, DistanceVoxelMap):
            _host(m.data, "<i4").tofile(f)  # the int32 view of the uint32 packed coordinates
        else:
            _host(m.data, np.int8).tofile(f)


def read_voxel_map(path, device=None):
    """readFromDisk of a dense map file; the map lands on `device` (default:
    the card)."""
    from ..maps.distance_map import DistanceVoxelMap
    from ..maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap

    device = resolve_device(device)
    with open(path, "rb") as f:
        header = np.frombuffer(f.read(_HEADER.itemsize), dtype=_HEADER)[0]
        map_type = MapType(int(header["map_type"]))
        side = float(header["side_length"])
        dims = tuple(int(v) for v in header["dims"])
        n = dims[0] * dims[1] * dims[2]
        if map_type == MapType.MT_PROBAB_VOXELMAP:
            return ProbVoxelMap(_int8_body(f, n, device), dims, side)
        if map_type == MapType.MT_BITVECTOR_VOXELMAP:
            return BitVectorVoxelMap.from_planes(_read_planes_body(f, n, device), dims, side)
        if map_type == MapType.MT_DISTANCE_VOXELMAP:
            data = np.frombuffer(f.read(n * 4), "<i4", n).astype(np.int32)
            return DistanceVoxelMap(torch.from_numpy(data).to(device), dims, side)
        if map_type == MapType.MT_COUNTING_VOXELLIST:
            return CountingVoxelMap(_int8_body(f, n, device), dims, side)
    raise ValueError(f"unknown map type {map_type}")


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


class DiskIO:
    """writeToDisk / readFromDisk (GpuVoxelsMap.h:200-209), mixed into the
    dense maps and the voxel lists. Maps are values, so read_from_disk
    returns the loaded map (on this map's device); a file of another
    MapType raises ValueError where the reference logs and returns false.

    Each map reads with its own tier's reader. The reference dispatches on
    the file's MapType instead, which sends a CountingVoxelMap's file
    (MT_COUNTING_VOXELLIST, gpu_voxels_tpu/maps/voxelmap.py:678) to the
    list reader, so its CountingVoxelMap.read_from_disk raises (F14)."""

    def write_to_disk(self, path) -> bool:
        from ..maps.voxellist import VoxelList

        (write_voxel_list if isinstance(self, VoxelList) else write_voxel_map)(self, path)
        return True

    def read_from_disk(self, path):
        from ..maps.voxellist import VoxelList

        with open(path, "rb") as f:
            map_type = MapType(int(np.frombuffer(f.read(4), "<i4")[0]))
        if map_type != MapType(int(self.map_type)):
            raise ValueError(f"file holds {map_type.name}, map is {MapType(int(self.map_type)).name}")
        reader = read_voxel_list if isinstance(self, VoxelList) else read_voxel_map
        return reader(path, device=self.device)
