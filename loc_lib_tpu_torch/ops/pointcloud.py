"""Fixed-shape point-cloud container (port of loc_lib_tpu/ops/pointcloud.py).

A variable-length cloud becomes a padded `(N, 3)` float32 tensor plus a bool
validity mask, so every downstream op sees static shapes; per-point
attributes ride along as optional fields.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class PointCloud(NamedTuple):
    """Padded point cloud. Invalid rows have mask=False and xyz=PAD."""

    xyz: torch.Tensor                       # (N, 3) float32
    mask: torch.Tensor                      # (N,) bool
    intensity: Optional[torch.Tensor] = None  # (N,) float32
    ring: Optional[torch.Tensor] = None       # (N,) int32
    time: Optional[torch.Tensor] = None       # (N,) float32
    stamp: Optional[torch.Tensor] = None      # () float32 scan timestamp

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum()


# Padding coordinate for invalid points: far away so voxel/NN logic can also
# rely on geometry, not only on masks.
PAD_COORD = 1e6


def card_device(device=None) -> torch.device:
    """The device an entry point puts its tensors on: `device` when the
    caller names one, else the current CUDA card (the first, unless
    `torch.cuda.set_device` chose another, as `multihost.init` does for a
    rank). Without a card it raises; it never falls back to the CPU
    (callers that want the CPU say so)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _pad_to(n_points: int, arr: np.ndarray, fill) -> np.ndarray:
    out = np.full((n_points,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def from_numpy(
    xyz: np.ndarray,
    capacity: Optional[int] = None,
    intensity: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    time: Optional[np.ndarray] = None,
    stamp: float = 0.0,
    device=None,
) -> PointCloud:
    """Build a padded PointCloud on `device` (default: the card, see
    `card_device`) from host arrays, dropping non-finite points."""
    device = card_device(device)
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    if intensity is not None:
        intensity = np.asarray(intensity, dtype=np.float32).reshape(-1)[finite]
    if ring is not None:
        ring = np.asarray(ring, dtype=np.int32).reshape(-1)[finite]
    if time is not None:
        time = np.asarray(time, dtype=np.float32).reshape(-1)[finite]

    n = xyz.shape[0]
    if capacity is None:
        capacity = max(int(2 ** np.ceil(np.log2(max(n, 1)))), 128)
    if n > capacity:
        raise ValueError(f"cloud with {n} points exceeds capacity {capacity}")

    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    dev = lambda a: torch.from_numpy(a).to(device)
    return PointCloud(
        xyz=dev(_pad_to(capacity, xyz, PAD_COORD)),
        mask=dev(mask),
        intensity=None if intensity is None else dev(_pad_to(capacity, intensity, 0.0)),
        ring=None if ring is None else dev(_pad_to(capacity, ring, -1)),
        time=None if time is None else dev(_pad_to(capacity, time, 0.0)),
        stamp=torch.tensor(stamp, dtype=torch.float32, device=device),
    )


def to_numpy(pc: PointCloud) -> np.ndarray:
    """Valid points only, as a host (n, 3) array."""
    xyz = pc.xyz.cpu().numpy()
    mask = pc.mask.cpu().numpy()
    return xyz[mask]


def transform(pc: PointCloud, R: torch.Tensor, t: torch.Tensor) -> PointCloud:
    """Rigid transform of the valid points (padding stays far away)."""
    new_xyz = pc.xyz @ R.T + t
    new_xyz = torch.where(pc.mask[:, None], new_xyz, pc.xyz)
    return pc._replace(xyz=new_xyz)


def concat(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two padded clouds (capacity adds; attrs dropped)."""
    return PointCloud(xyz=torch.cat([a.xyz, b.xyz], dim=0),
                      mask=torch.cat([a.mask, b.mask], dim=0))


def compact(pc: PointCloud) -> PointCloud:
    """Move valid points to the front (stable), padding to the back."""
    order = torch.argsort((~pc.mask).to(torch.int32), stable=True)
    take = lambda x: None if x is None else x[order]
    return PointCloud(
        xyz=pc.xyz[order],
        mask=pc.mask[order],
        intensity=take(pc.intensity),
        ring=take(pc.ring),
        time=take(pc.time),
        stamp=pc.stamp,
    )
