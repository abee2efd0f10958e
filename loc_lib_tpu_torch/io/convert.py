"""Carry engine state across from host arrays (the engine has no weights:
its state is the target table, the ESKF state and the LIO state).

Each function takes a dict of numpy arrays -- e.g. a state built elsewhere
and flattened with `tree_map(np.asarray, state)._asdict()`, whose nested
NamedTuples may stay NamedTuples or be dicts -- and a device, and returns
this package's counterpart on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import eskf, icp
from ..ops import voxel
from ..pipeline import lio


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
        icp_target=icp_target_from_numpy(f["icp_target"], device),
        eskf=eskf_state_from_numpy(f["eskf"], device),
    )
