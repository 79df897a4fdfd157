"""Map state carried between the JAX package and the port.

The engine has no weights: its state is its maps and its robots (a DH
table plus link clouds). These functions convert that state, as numpy, in
both directions, so a map or robot built by gpu_voxels_tpu
(``np.asarray(m.data)``) continues in the port and the two states can be
compared byte for byte. Bit planes and packed distance-map coordinates are
uint32 in the reference and int32 here; the conversion reinterprets the
same bits (``np.ndarray.view``), it never converts values. A voxel list's
(ids_hi, ids) uint32 words become the port's int64 keys and back
(maps/voxellist.py). A dense hierarchy travels as its occupancy grid and
its pyramid levels, a paged map as its device arrays, its counters and its
host directories (`PAGED_ARRAYS`), a primitive array as its float32[N, 4]
positions and diameters with its type. Everything lands on `device`
(default: the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .geometry.pointcloud import MetaPointCloud
from .maps.distance_map import DistanceVoxelMap
from .maps.hierarchical import HierarchicalBitMap, HierarchicalProbMap
from .maps.paged import PagedHierarchicalMap
from .maps.voxellist import KIND_BIT, VoxelList, join_keys, split_keys
from .maps.voxelmap import BitVectorVoxelMap, CountingVoxelMap, ProbVoxelMap
from .primitive_array import PrimitiveArray, PrimitiveType
from .robot.dh import DHJointType, DHParameters, KinematicChain
from .sensors import Sensor, SensorModel
from .utils import resolve_device


def prob_map_from_numpy(data, dims, side_length: float, device=None) -> ProbVoxelMap:
    """A ProbVoxelMap over a copy of int8[N] log-odds `data`."""
    data = np.asarray(data)
    if data.dtype != np.int8 or data.shape != (dims[0] * dims[1] * dims[2],):
        raise ValueError(f"prob map data must be int8[{dims[0] * dims[1] * dims[2]}], got {data.dtype}{data.shape}")
    return ProbVoxelMap(
        torch.tensor(data, device=resolve_device(device)), tuple(int(d) for d in dims), float(side_length)
    )


def bit_map_from_numpy(planes, occ, dims, side_length: float, device=None) -> BitVectorVoxelMap:
    """A BitVectorVoxelMap over a copy of uint32[8, N] `planes` and of the
    reference map's occupancy summary `occ` (uint8[N]). A reference map
    without a summary (`occ is None`) becomes a port map without one;
    `BitVectorVoxelMap.from_planes` is the call that computes a summary."""
    planes = np.ascontiguousarray(planes)
    n = dims[0] * dims[1] * dims[2]
    if planes.dtype != np.uint32 or planes.shape != (8, n):
        raise ValueError(f"bit planes must be uint32[8, {n}], got {planes.dtype}{planes.shape}")
    device = resolve_device(device)
    if occ is not None:
        occ = np.asarray(occ)
        if occ.dtype != np.uint8 or occ.shape != (n,):
            raise ValueError(f"occupancy summary must be uint8[{n}], got {occ.dtype}{occ.shape}")
        occ = torch.tensor(occ, device=device)
    return BitVectorVoxelMap(
        torch.tensor(planes.view(np.int32), device=device), tuple(int(d) for d in dims), float(side_length), occ=occ
    )


def counting_map_from_numpy(data, dims, side_length: float, device=None) -> CountingVoxelMap:
    """A CountingVoxelMap over a copy of int8[N] counts `data`."""
    data = np.asarray(data)
    n = dims[0] * dims[1] * dims[2]
    if data.dtype != np.int8 or data.shape != (n,):
        raise ValueError(f"counting map data must be int8[{n}], got {data.dtype}{data.shape}")
    return CountingVoxelMap(
        torch.tensor(data, device=resolve_device(device)), tuple(int(d) for d in dims), float(side_length)
    )


def distance_map_from_numpy(data, dims, side_length: float, device=None) -> DistanceVoxelMap:
    """A DistanceVoxelMap over a copy of uint32[N] packed obstacle
    coordinates `data` (the reference never sets bit 31)."""
    data = np.ascontiguousarray(data)
    n = dims[0] * dims[1] * dims[2]
    if data.dtype != np.uint32 or data.shape != (n,):
        raise ValueError(f"distance map data must be uint32[{n}], got {data.dtype}{data.shape}")
    return DistanceVoxelMap(
        torch.tensor(data.view(np.int32), device=resolve_device(device)), tuple(int(d) for d in dims),
        float(side_length),
    )


def voxel_list_from_numpy(ids, ids_hi, payload, count, dims, side_length: float, kind: str,
                          id_mode: str = "linear", map_type=None, device=None) -> VoxelList:
    """A VoxelList over copies of the reference list's fields: uint32[C] `ids`
    and `ids_hi` (joined into the port's int64 keys, the (EMPTY, EMPTY) pair
    into the morton EMPTY key), the payload (uint32[8, C] planes or int8[C])
    and the live `count`."""
    ids, ids_hi = np.asarray(ids), np.asarray(ids_hi)
    payload = np.ascontiguousarray(payload)
    c = ids.shape[0]
    if ids.dtype != np.uint32 or ids_hi.dtype != np.uint32 or ids.shape != (c,) or ids_hi.shape != (c,):
        raise ValueError(f"ids and ids_hi must be uint32[C], got {ids.dtype}{ids.shape}, {ids_hi.dtype}{ids_hi.shape}")
    want = (np.uint32, (8, c)) if kind == KIND_BIT else (np.int8, (c,))
    if (payload.dtype, payload.shape) != want:
        raise ValueError(f"a {kind} list's payload must be {np.dtype(want[0])}{want[1]}, got {payload.dtype}{payload.shape}")
    device = resolve_device(device)
    lst = VoxelList.create(dims, side_length, kind, 0, id_mode, map_type, device=device)
    keys = join_keys(torch.tensor(ids_hi.astype(np.int64)), torch.tensor(ids.astype(np.int64)), id_mode)
    data = payload.view(np.int32) if kind == KIND_BIT else payload
    return dataclasses.replace(lst, keys=keys.to(device), payload=torch.tensor(data, device=device),
                               count=torch.tensor(int(count), dtype=torch.int64, device=device))


def meta_point_cloud_from_numpy(points, cloud_ids, offsets, names, device=None) -> MetaPointCloud:
    """A MetaPointCloud over copies of float32[total, 3] `points` and the
    per-point sub-cloud ids, with the reference's host offsets and names."""
    points = np.asarray(points)
    cloud_ids = np.asarray(cloud_ids)
    offsets, names = tuple(int(o) for o in offsets), tuple(names)
    total = offsets[-1]
    if points.dtype != np.float32 or points.shape != (total, 3):
        raise ValueError(f"points must be float32[{total}, 3], got {points.dtype}{points.shape}")
    if cloud_ids.shape != (total,) or len(names) != len(offsets) - 1:
        raise ValueError(f"cloud ids must be [{total}] and names one per sub-cloud")
    device = resolve_device(device)
    return MetaPointCloud(torch.tensor(points, device=device),
                          torch.tensor(cloud_ids.astype(np.int64), device=device), offsets, names)


def kinematic_chain_from_numpy(link_names, dh_rows, joint_types, points, cloud_ids, offsets, cloud_names,
                               lower_limits=None, upper_limits=None, device=None) -> KinematicChain:
    """A KinematicChain from the reference chain's plain state: one
    (d, theta, a, alpha, value) row and one joint type per link, the link
    clouds as for meta_point_cloud_from_numpy, and the joint limits."""
    params = [DHParameters(*(float(v) for v in row), joint_type=DHJointType(int(jt)))
              for row, jt in zip(dh_rows, joint_types)]
    clouds = meta_point_cloud_from_numpy(points, cloud_ids, offsets, cloud_names, device)
    return KinematicChain(list(link_names), params, clouds, lower_limits=lower_limits, upper_limits=upper_limits)


def hierarchical_map_from_numpy(pyramid, dims, side_length: float, levels: int, occupancy=None,
                                device=None):
    """A HierarchicalProbMap (given its int8[Zp, Yp, Xp] `occupancy`) or a
    HierarchicalBitMap (without one) over copies of the uint8 `pyramid`
    levels, taken as they are (not rebuilt)."""
    device = resolve_device(device)
    pyr = tuple(torch.tensor(np.asarray(p), device=device) for p in pyramid)
    if len(pyr) != levels + 1 or any(p.dtype != torch.uint8 for p in pyr):
        raise ValueError(f"the pyramid must be {levels + 1} uint8 levels")
    dims = tuple(int(d) for d in dims)
    if occupancy is None:
        return HierarchicalBitMap(pyr, dims, float(side_length), int(levels))
    occ = np.asarray(occupancy)
    if occ.dtype != np.int8 or occ.shape != tuple(pyr[0].shape):
        raise ValueError(f"occupancy must be int8{tuple(pyr[0].shape)}, got {occ.dtype}{occ.shape}")
    return HierarchicalProbMap(torch.tensor(occ, device=device), pyr, dims, float(side_length), int(levels))


# a paged map's device arrays, by attribute name (occ_pool only in the
# probabilistic tier)
PAGED_ARRAYS = ("skeys", "srows", "pages", "block_summaries", "page_coord", "pool", "occ_pool", "slot_block",
                "slot_page", "slot_within")


def paged_map_from_numpy(state: dict, device=None) -> PagedHierarchicalMap:
    """A PagedHierarchicalMap over copies of a paged map's state: `dims`,
    `side_length`, `probabilistic`, the `pyramid` levels, the arrays of
    PAGED_ARRAYS (uint32 nowhere: int32, uint8 and int8 as the reference
    holds them), the counters `n_pages` and `n_slots`, and the host
    directories `page_of` (page key -> row) and `slot_of` (block key ->
    slot)."""
    m = PagedHierarchicalMap(state["dims"], state["side_length"], probabilistic=state["probabilistic"],
                             device=device)
    m.pyramid = tuple(torch.tensor(np.asarray(p), device=m.device) for p in state["pyramid"])
    for name in PAGED_ARRAYS:
        a = state[name]
        setattr(m, name, None if a is None else torch.tensor(np.asarray(a), device=m.device))
    m._n_pages, m._n_slots = int(state["n_pages"]), int(state["n_slots"])
    m._page_of = {int(k): int(v) for k, v in state["page_of"].items()}
    m._slot_of = {int(k): int(v) for k, v in state["slot_of"].items()}
    return m


def primitive_array_from_numpy(positions_diameters, prim_type, device=None) -> PrimitiveArray:
    """A PrimitiveArray over a copy of float32[N, 4] (x, y, z, diameter)."""
    pd = np.asarray(positions_diameters, np.float32).reshape(-1, 4)
    return PrimitiveArray(torch.from_numpy(pd.copy()).to(resolve_device(device)), PrimitiveType(int(prim_type)))


def to_numpy(m):
    """The map's arrays in the reference's dtypes: int8[N] for a ProbVoxelMap
    or a CountingVoxelMap, (uint32[8, N] planes, uint8[N] occ or None) for a
    BitVectorVoxelMap, uint32[N] for a DistanceVoxelMap, and the reference's
    (ids uint32[C], ids_hi uint32[C], payload, count int) for a VoxelList,
    (occupancy int8 grid or None, [uint8 pyramid levels]) for a dense
    hierarchy, the state dict of `paged_map_from_numpy` for a paged map and
    (float32[N, 4], int type) for a PrimitiveArray."""
    if isinstance(m, PrimitiveArray):
        return m.positions_diameters.cpu().numpy(), int(m.prim_type)
    if isinstance(m, (HierarchicalProbMap, HierarchicalBitMap)):
        occ = m.occupancy.cpu().numpy() if isinstance(m, HierarchicalProbMap) else None
        return occ, [p.cpu().numpy() for p in m.pyramid]
    if isinstance(m, PagedHierarchicalMap):
        state = {name: (None if getattr(m, name) is None else getattr(m, name).cpu().numpy())
                 for name in PAGED_ARRAYS}
        state.update(dims=m.dims, side_length=m.side_length, probabilistic=m.probabilistic,
                     pyramid=[p.cpu().numpy() for p in m.pyramid], n_pages=m._n_pages, n_slots=m._n_slots,
                     page_of=dict(m._page_of), slot_of=dict(m._slot_of))
        return state
    if isinstance(m, VoxelList):
        hi, lo = (w.cpu().numpy().astype(np.uint32) for w in split_keys(m.keys, m.id_mode))
        payload = m.payload.cpu().numpy()
        return lo, hi, payload.view(np.uint32) if m.kind == KIND_BIT else payload, int(m.count)
    if isinstance(m, (ProbVoxelMap, CountingVoxelMap)):
        return m.data.cpu().numpy()
    if isinstance(m, DistanceVoxelMap):
        return m.data.cpu().numpy().view(np.uint32)
    if isinstance(m, BitVectorVoxelMap):
        return m.data.cpu().numpy().view(np.uint32), None if m.occ is None else m.occ.cpu().numpy()
    raise TypeError(f"no numpy form for {type(m)}")


def sensor_from_reference(fields) -> Sensor:
    """A Sensor from the reference Sensor's plain fields (a dict, or any
    object with those attributes, such as a gpu_voxels_tpu.sensors.Sensor)."""
    if not isinstance(fields, dict):
        fields = {f.name: getattr(fields, f.name) for f in dataclasses.fields(Sensor) if hasattr(fields, f.name)}
    kw = dict(fields)
    for k in ("position", "orientation_rpy"):
        if k in kw:
            kw[k] = np.array(kw[k], np.float32)
    model = kw.pop("model", None)
    if model is not None:
        if not isinstance(model, dict):
            model = {"initial_probability": model.initial_probability, "update_probability": model.update_probability}
        kw["model"] = SensorModel(**model)
    return Sensor(**kw)
