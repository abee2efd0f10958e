"""Voxel hashing: downsample, hash grid, segment statistics and the dense
O(1) voxel index (port of loc_lib_tpu/ops/voxel.py).

Voxel coordinates are offset into a bounded window of 1024 cells per axis
(+-512 around a caller-supplied origin) and packed into one positive int32
key; points outside the window get INVALID_KEY and fall out of every masked
reduction. A stable key sort is the workhorse: every per-voxel quantity is a
segment reduction over the sorted order.

Two differences from the JAX package, both kept semantically identical:
  * JAX's out-of-bounds scatters are dropped (`mode="drop"`); torch raises
    on the CPU and asserts on the card. Every scatter here writes its
    masked-out rows into one extra trash slot that is sliced away, which
    also avoids boolean-mask indexing (a host sync on the card).
  * `jax.ops.segment_sum` becomes `index_add_` over the sorted order. On
    the CPU that adds sequentially (as XLA does); on CUDA a float
    `index_add_` uses atomics, so the float sums of one voxel may differ in
    the last bits from run to run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from .pointcloud import PointCloud, PAD_COORD

WINDOW = 1024          # cells per axis in the local key window
HALF_WINDOW = WINDOW // 2
INVALID_KEY = 2 ** 31 - 1   # int32 max

_NEARBY6 = [[0, 0, 0], [-1, 0, 0], [1, 0, 0], [0, 1, 0], [0, -1, 0],
            [0, 0, -1], [0, 0, 1]]  # the NDT NEARBY6 stencil + center


@functools.lru_cache(maxsize=None)
def nearby6(device: torch.device) -> torch.Tensor:
    """(7, 3) int32 stencil on `device`, made once per device so the hot
    loop never copies it from the host."""
    return torch.tensor(_NEARBY6, dtype=torch.int32, device=device)


def voxel_coords(xyz: torch.Tensor, inv_leaf, origin=None, mode: str = "floor") -> torch.Tensor:
    """Integer voxel coordinates of points. mode="trunc" reproduces C++
    truncation toward zero; "floor" is the default for binning."""
    p = xyz if origin is None else xyz - origin
    scaled = p * inv_leaf
    c = torch.trunc(scaled) if mode == "trunc" else torch.floor(scaled)
    return c.to(torch.int32)


def coords_to_key(coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Pack (..., 3) int32 coords into a positive int32 key; out-of-window or
    invalid points get INVALID_KEY."""
    shifted = coords + HALF_WINDOW
    in_window = torch.all((shifted >= 0) & (shifted < WINDOW), dim=-1)
    key = (shifted[..., 0] * WINDOW + shifted[..., 1]) * WINDOW + shifted[..., 2]
    return torch.where(valid & in_window, key, INVALID_KEY)


def key_to_coords(keys: torch.Tensor) -> torch.Tensor:
    """Invert coords_to_key: (...,) int32 key -> (..., 3) int32 coords.
    Only meaningful for keys != INVALID_KEY."""
    z = keys % WINDOW
    rest = keys // WINDOW
    y = rest % WINDOW
    x = rest // WINDOW
    return torch.stack([x, y, z], dim=-1) - HALF_WINDOW


class _Segments(NamedTuple):
    order: torch.Tensor        # (N,) int64 permutation sorting points by key
    sorted_keys: torch.Tensor  # (N,) int32 keys in sorted order
    seg_id: torch.Tensor       # (N,) int64 segment index per sorted row
    starts: torch.Tensor       # (N,) bool, segment start marker


def _segment_by_key(keys: torch.Tensor) -> _Segments:
    # stable, like jnp.argsort: equal keys keep point order (bucket contents)
    order = torch.argsort(keys, stable=True)
    sk = keys[order]
    prev = torch.cat([torch.full((1,), -1, dtype=sk.dtype, device=sk.device), sk[:-1]])
    starts = (sk != prev) & (sk != INVALID_KEY)
    seg_id = torch.clamp(torch.cumsum(starts.to(torch.int64), 0) - 1, min=0)
    return _Segments(order, sk, seg_id, starts)


def _segment_sum(values: torch.Tensor, seg_id: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + values.shape[1:], dtype=values.dtype, device=values.device)
    return out.index_add_(0, seg_id, values)


def _segment_keys(seg: _Segments, count: torch.Tensor) -> torch.Tensor:
    """segment_min of the sorted keys: each segment's first row holds its
    key (INVALID rows only ever trail the last segment)."""
    n = seg.sorted_keys.shape[0]
    dev = seg.sorted_keys.device
    slot = torch.where(seg.starts, seg.seg_id, n)          # n = trash slot
    vkeys = torch.full((n + 1,), INVALID_KEY, dtype=torch.int32, device=dev)
    vkeys[slot] = seg.sorted_keys
    return torch.where(count > 0, vkeys[:n], INVALID_KEY)


def voxel_downsample(pc: PointCloud, leaf_size: float, origin=None) -> PointCloud:
    """Centroid voxel downsample: same capacity, row v is the centroid of
    voxel v (compacted to the front), mask marks real voxels."""
    n = pc.capacity
    inv = 1.0 / leaf_size
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin), pc.mask)
    seg = _segment_by_key(keys)
    pts_sorted = pc.xyz[seg.order]
    w = (seg.sorted_keys != INVALID_KEY).to(pc.xyz.dtype)
    sums = _segment_sum(pts_sorted * w[:, None], seg.seg_id, n)
    cnts = _segment_sum(w, seg.seg_id, n)
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    mask = cnts > 0
    xyz = torch.where(mask[:, None], centroids, PAD_COORD)
    return PointCloud(xyz=xyz, mask=mask, stamp=pc.stamp)


class HashGrid(NamedTuple):
    """Spatial hash over a target cloud.

    voxel_keys : (V,) int32 sorted unique voxel keys (INVALID_KEY padded)
    bucket_xyz : (V, 3*C) float32 per-voxel point coords, [x0..xC, y.., z..]
    bucket_idx : (V, C) int32 original point indices (-1 padded)
    bucket_cnt : (V,) int32 points stored per voxel
    num_voxels : () int32
    overflow   : () int32 points dropped because their bucket was full
    inv_leaf   : () float32
    origin     : (3,) float32 window origin
    """

    voxel_keys: torch.Tensor
    bucket_xyz: torch.Tensor
    bucket_idx: torch.Tensor
    bucket_cnt: torch.Tensor
    num_voxels: torch.Tensor
    overflow: torch.Tensor
    inv_leaf: torch.Tensor
    origin: torch.Tensor

    @property
    def bucket_size(self) -> int:
        return self.bucket_idx.shape[1]


def _default_origin(pc: PointCloud, origin):
    if origin is None:
        return torch.zeros((3,), dtype=torch.float32, device=pc.device)
    return origin.to(torch.float32)


def _inv_leaf(pc: PointCloud, leaf_size: float) -> torch.Tensor:
    return torch.full((), 1.0 / leaf_size, dtype=torch.float32, device=pc.device)


def build_hash_grid_with_stats(pc: PointCloud, leaf_size: float,
                               bucket_size: int = 8,
                               origin: Optional[torch.Tensor] = None):
    """(HashGrid, VoxelStats) from ONE key sort: both share floor binning and
    the same origin."""
    inv = _inv_leaf(pc, leaf_size)
    origin = _default_origin(pc, origin)
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin), pc.mask)
    seg = _segment_by_key(keys)
    grid = _grid_from_segments(pc, seg, inv, origin, bucket_size)
    stats = _stats_from_segments(pc, seg, inv, origin)
    return grid, stats


def _grid_from_segments(pc: PointCloud, seg: _Segments, inv, origin,
                        bucket_size: int) -> HashGrid:
    n = pc.capacity
    dev = pc.device
    c = bucket_size
    valid_row = seg.sorted_keys != INVALID_KEY
    seg_count = _segment_sum(valid_row.to(torch.int32), seg.seg_id, n)
    voxel_keys = _segment_keys(seg, seg_count)

    # rank of each sorted row inside its segment
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    start_pos = torch.where(seg.starts, idx, 0)
    rank = idx - torch.cummax(start_pos, 0).values
    keep = valid_row & (rank < c)

    # scatter point ids and coordinates into (V, C) buckets; rows that do not
    # fit go to a trash slot that is sliced away
    flat_pos = torch.where(keep, seg.seg_id * c + rank, n * c)
    bucket_idx = torch.full((n * c + 1,), -1, dtype=torch.int32, device=dev)
    bucket_idx[flat_pos] = seg.order.to(torch.int32)
    pts_sorted = pc.xyz[seg.order]
    soa = torch.full((n, 3 * c + 1), PAD_COORD, dtype=pc.xyz.dtype, device=dev)
    for axis in range(3):
        col = torch.where(keep, rank + axis * c, 3 * c)
        soa[seg.seg_id, col] = pts_sorted[:, axis]

    return HashGrid(
        voxel_keys=voxel_keys,
        bucket_xyz=soa[:, :3 * c],
        bucket_idx=bucket_idx[:n * c].reshape(n, c),
        bucket_cnt=torch.clamp(seg_count, max=c),
        num_voxels=seg.starts.to(torch.int32).sum(),
        overflow=(valid_row & (rank >= c)).to(torch.int32).sum(),
        inv_leaf=inv,
        origin=origin,
    )


class DenseIndex(NamedTuple):
    """O(1) voxel lookup: a dense int32 slot table over a bounded voxel-coord
    window anchored at the key set's min corner.

    table : (dims[0]*dims[1]*dims[2],) int32 slot into the key array, -1 empty
    lo    : (3,) int32 window min corner in voxel coords
    """

    table: torch.Tensor
    lo: torch.Tensor


def _in_dims(rel: torch.Tensor, dims) -> torch.Tensor:
    """0 <= rel < dims on every axis (dims are host ints: no device copy)."""
    return ((rel[..., 0] >= 0) & (rel[..., 0] < dims[0])
            & (rel[..., 1] >= 0) & (rel[..., 1] < dims[1])
            & (rel[..., 2] >= 0) & (rel[..., 2] < dims[2]))


def build_dense_index(keys: torch.Tensor, dims=(256, 256, 64)) -> DenseIndex:
    """Dense slot table from a (V,) key array (INVALID padded). Keys outside
    `lo + dims` are not indexed."""
    v = keys.shape[0]
    dev = keys.device
    valid = keys != INVALID_KEY
    coords = key_to_coords(keys)
    lo = torch.where(valid[:, None], coords, HALF_WINDOW).amin(dim=0)
    rel = coords - lo
    in_win = valid & _in_dims(rel, dims)
    total = dims[0] * dims[1] * dims[2]
    flat = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
    flat = torch.where(in_win, flat.to(torch.int64), total)   # total = trash
    table = torch.full((total + 1,), -1, dtype=torch.int32, device=dev)
    table[flat] = torch.arange(v, dtype=torch.int32, device=dev)
    return DenseIndex(table=table[:total], lo=lo)


def lookup_dense(dense: DenseIndex, dims, query_keys: torch.Tensor):
    """O(1) slot lookup; `dims` must match the build. Returns
    (slot clamped to >= 0, found)."""
    coords = key_to_coords(query_keys)
    rel = coords - dense.lo
    in_win = (query_keys != INVALID_KEY) & _in_dims(rel, dims)
    flat = (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] + rel[..., 2]
    flat = torch.where(in_win, flat, 0)
    slot = dense.table[flat.to(torch.int64)]
    found = in_win & (slot >= 0)
    return torch.clamp(slot, min=0), found


class VoxelStats(NamedTuple):
    """Per-voxel Gaussian statistics.

    keys  : (V,) sorted unique voxel keys (INVALID_KEY padded)
    count : (V,) float32 number of points
    mean  : (V, 3)
    cov   : (V, 3, 3) unbiased covariance (/(n-1))
    """

    keys: torch.Tensor
    count: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    inv_leaf: torch.Tensor
    origin: torch.Tensor


def voxel_stats(pc: PointCloud, leaf_size: float, origin=None,
                mode: str = "trunc") -> VoxelStats:
    """One-pass segment reduce: per-voxel count, mean, covariance."""
    inv = _inv_leaf(pc, leaf_size)
    origin = _default_origin(pc, origin)
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin, mode), pc.mask)
    return _stats_from_segments(pc, _segment_by_key(keys), inv, origin)


def _stats_from_segments(pc: PointCloud, seg: _Segments, inv, origin) -> VoxelStats:
    """Per-voxel moments from a precomputed key sort. The covariance is
    formed from raw second moments about the window origin, exactly as the
    reference does (s2 - n mu mu^T)."""
    n = pc.capacity
    pts = pc.xyz[seg.order]
    w = (seg.sorted_keys != INVALID_KEY).to(pc.xyz.dtype)
    pw = pts * w[:, None]
    cnt = _segment_sum(w, seg.seg_id, n)
    s1 = _segment_sum(pw, seg.seg_id, n)
    s2 = _segment_sum(pw[:, :, None] * pts[:, None, :], seg.seg_id, n)
    mean = s1 / torch.clamp(cnt, min=1.0)[:, None]
    cov = (s2 - cnt[:, None, None] * mean[:, :, None] * mean[:, None, :]) \
        / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    vkeys = _segment_keys(seg, cnt)
    return VoxelStats(keys=vkeys, count=cnt, mean=mean, cov=cov,
                      inv_leaf=inv, origin=origin)
