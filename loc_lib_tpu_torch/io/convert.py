"""Carry engine state across from host arrays (the engine has no weights:
its state is the target tables, the ESKF state, the LIO / Loc state and the
2D stack's occupancy grids and device-resident mapping state).

Each function takes a dict of numpy arrays -- e.g. a state built elsewhere
and flattened with `tree_map(np.asarray, state)._asdict()`, whose nested
NamedTuples may stay NamedTuples or be dicts -- and a device, and returns
this package's counterpart on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import eskf, grid2d, icp, loam, ndt
from ..ops import voxel
from ..pipeline import lio, loc, mapping2d_device


def _fields(d) -> dict:
    return d if isinstance(d, dict) else d._asdict()


def _tensor(a, device) -> torch.Tensor:
    arr = np.array(a, dtype=np.float32 if np.asarray(a).dtype == np.float64 else None)
    return torch.from_numpy(arr).to(device)      # np.array copies: writable


def _maybe(a, device):
    return None if a is None else _tensor(a, device)


def hash_grid_from_numpy(d, device) -> voxel.HashGrid:
    f = _fields(d)
    return voxel.HashGrid(**{k: _tensor(f[k], device) for k in voxel.HashGrid._fields})


def dense_index_from_numpy(d, device):
    if d is None:
        return None
    f = _fields(d)
    return voxel.DenseIndex(table=_tensor(f["table"], device), lo=_tensor(f["lo"], device))


def icp_target_from_numpy(d, device) -> icp.IcpTarget:
    f = _fields(d)
    return icp.IcpTarget(
        grid=hash_grid_from_numpy(f["grid"], device),
        centroid=_maybe(f.get("centroid"), device),
        packed=_maybe(f.get("packed"), device),
        plane=_maybe(f.get("plane"), device),
        plane_mu=_maybe(f.get("plane_mu"), device),
        plane_valid=_maybe(f.get("plane_valid"), device),
        dense=dense_index_from_numpy(f.get("dense"), device),
        dense_oct=dense_index_from_numpy(f.get("dense_oct"), device),
        oct_table=_maybe(f.get("oct_table"), device),
        packed_ext=_maybe(f.get("packed_ext"), device),
        line_packed=_maybe(f.get("line_packed"), device),
        line_dir=_maybe(f.get("line_dir"), device),
    )


def _maybe_of(convert, d, device):
    return None if d is None else convert(d, device)


def loam_target_from_numpy(d, device) -> loam.LoamTarget:
    f = _fields(d)
    return loam.LoamTarget(edge=icp_target_from_numpy(f["edge"], device),
                           surf=icp_target_from_numpy(f["surf"], device))


def ndt_map_from_numpy(d, device) -> ndt.NdtMap:
    f = _fields(d)
    return ndt.NdtMap(
        **{k: _tensor(f[k], device) for k in
           ("keys", "count", "mean", "cov", "info", "estimated", "age", "origin")},
        epoch=int(np.asarray(f["epoch"])),
        packed=_maybe(f.get("packed"), device),
        dense_table=_maybe(f.get("dense_table"), device),
        dense_lo=_maybe(f.get("dense_lo"), device),
    )


def eskf_state_from_numpy(d, device) -> eskf.EskfState:
    f = _fields(d)
    return eskf.EskfState(**{k: _tensor(f[k], device) for k in eskf.EskfState._fields})


def lio_state_from_numpy(d, device) -> lio.LioState:
    f = _fields(d)
    tensors = {k: _tensor(f[k], device) for k in
               ("R", "t", "last_R", "last_t", "kf_xyz", "kf_mask", "kf_R", "kf_t",
                "last_kf_R", "last_kf_t", "R_il", "t_il", "map_overflow")}
    return lio.LioState(
        **tensors,
        num_kfs=int(np.asarray(f["num_kfs"])),
        frame_idx=int(np.asarray(f["frame_idx"])),
        icp_target=_maybe_of(icp_target_from_numpy, f.get("icp_target"), device),
        ndt_map=_maybe_of(ndt_map_from_numpy, f.get("ndt_map"), device),
        loam_target=_maybe_of(loam_target_from_numpy, f.get("loam_target"), device),
        kf_edge_xyz=_maybe(f.get("kf_edge_xyz"), device),
        kf_edge_mask=_maybe(f.get("kf_edge_mask"), device),
        eskf=eskf_state_from_numpy(f["eskf"], device),
    )


def loc_state_from_numpy(d, device) -> loc.LocState:
    f = _fields(d)
    return loc.LocState(
        **{k: _tensor(f[k], device) for k in
           ("R", "t", "last_R", "last_t", "map_center", "R_il", "t_il")},
        icp_target=_maybe_of(icp_target_from_numpy, f.get("icp_target"), device),
        ndt_map=_maybe_of(ndt_map_from_numpy, f.get("ndt_map"), device),
        eskf=eskf_state_from_numpy(f["eskf"], device),
        initialized=bool(np.asarray(f["initialized"])),
    )


def occupancy_grid_from_numpy(d, device) -> grid2d.OccupancyGrid:
    f = _fields(d)
    return grid2d.OccupancyGrid(counts=_tensor(f["counts"], device),
                                touched=_tensor(f["touched"], device))


def mapping2d_device_state_from_numpy(d, device) -> mapping2d_device.Mapping2dDeviceState:
    """The JAX engine's Mapping2dDeviceState; its device-side counts
    (frames, submap keyframes, ring pushes) become the host ints the port
    keeps them as."""
    f = _fields(d)
    ints = ("num_frames", "recent_count", "frame_count")
    return mapping2d_device.Mapping2dDeviceState(
        **{k: int(np.asarray(f[k])) if k in ints else _tensor(f[k], device)
           for k in mapping2d_device.Mapping2dDeviceState._fields})
