"""Cloud filters as mask transforms (port of loc_lib_tpu/ops/filters.py).

The box filter is how localization crops a local map, the range filter the
subscribers' minimum-range cull, and `voxel_downsample` the voxel grid
(re-exported from ops/voxel.py). Filters never change shapes: they only
clear mask bits, so every consumer keeps its fixed capacity.
"""

from __future__ import annotations

import math

import torch

from .pointcloud import PointCloud
from .voxel import voxel_downsample  # re-exported beside the other filters  # noqa: F401


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def box_filter(pc: PointCloud, origin, size) -> PointCloud:
    """Keep the points inside the axis-aligned box centred at `origin` with
    edge lengths `size` (bounds included)."""
    origin = _f32(origin, pc.device)
    size = _f32(size, pc.device)
    lo = origin - 0.5 * size
    hi = origin + 0.5 * size
    inside = torch.all((pc.xyz >= lo) & (pc.xyz <= hi), dim=-1)
    return pc._replace(mask=pc.mask & inside)


def range_filter(pc: PointCloud, min_range: float = 0.0,
                 max_range: float = math.inf) -> PointCloud:
    """Drop the points closer than min_range or farther than max_range from
    the sensor (bounds included)."""
    r = torch.linalg.vector_norm(pc.xyz, dim=-1)
    keep = (r >= min_range) & (r <= max_range)
    return pc._replace(mask=pc.mask & keep)


def no_filter(pc: PointCloud) -> PointCloud:
    """Identity."""
    return pc


def remove_nonfinite(pc: PointCloud) -> PointCloud:
    """Mask out the points with a non-finite coordinate."""
    return pc._replace(mask=pc.mask & torch.isfinite(pc.xyz).all(dim=-1))
