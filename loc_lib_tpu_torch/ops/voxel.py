"""Voxel hashing: downsample, hash grid with its gather-style kNN, segment
statistics and the dense O(1) voxel index (port of loc_lib_tpu/ops/voxel.py).

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
  * `jax.ops.segment_sum` becomes `torch.segment_reduce` over the run
    boundaries of the sorted order (`segment_sum`): each segment is summed
    serially in row order, on the CPU and on CUDA alike, so one input gives
    the same bits on every run, as in JAX. (A float `index_add_` would sum
    with atomics on CUDA.)
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


@functools.lru_cache(maxsize=None)
def center1(device: torch.device) -> torch.Tensor:
    """(1, 3) int32 single-voxel stencil (NDT nearby="center")."""
    return torch.zeros((1, 3), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def nearby27(device: torch.device) -> torch.Tensor:
    """(27, 3) int32 full 3x3x3 stencil (x slowest): exact kNN within one
    cell radius."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3)


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


def segment_offsets(seg_id: torch.Tensor, n: int, valid=None) -> torch.Tensor:
    """(n + 1,) int64 run boundaries of n segments over rows sorted by
    segment (`seg_id` non-decreasing): segment s is rows [off[s], off[s+1]).
    Rows where `valid` is False must trail the others; they belong to no
    segment. Searchsorted, no atomics: the same bits on every run."""
    ids = seg_id if valid is None else torch.where(valid, seg_id, n)
    return torch.searchsorted(ids, torch.arange(n + 1, dtype=ids.dtype, device=ids.device))


def segment_sum(values: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Sum the rows of float `values` (N, ...) over the runs `offsets` (from
    `segment_offsets`): each output row is its run added serially in row
    order from 0, the order `index_add_` adds in on the CPU (bit-equal to it
    there). On CUDA, `segment_reduce` walks each run in one thread for 2-D
    data, so the sum is the same on every run (a float `index_add_` uses
    atomics there). Empty segments are 0; rows past offsets[-1] are not read."""
    flat = values.reshape(values.shape[0], -1)
    out = torch.segment_reduce(flat, "sum", offsets=offsets, axis=0, unsafe=True)
    return out.reshape((offsets.shape[0] - 1,) + values.shape[1:])


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
    valid = seg.sorted_keys != INVALID_KEY
    pts_sorted = pc.xyz[seg.order]
    w = valid.to(pc.xyz.dtype)
    s = segment_sum(torch.cat([pts_sorted * w[:, None], w[:, None]], dim=1),
                    segment_offsets(seg.seg_id, n, valid))
    sums, cnts = s[:, 0:3], s[:, 3]
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


def build_hash_grid(pc: PointCloud, leaf_size: float, bucket_size: int = 8,
                    origin: Optional[torch.Tensor] = None) -> HashGrid:
    """The hash grid alone (floor binning): sort by voxel key, scatter the
    per-voxel buckets. What the knn matchers search."""
    inv = _inv_leaf(pc, leaf_size)
    origin = _default_origin(pc, origin)
    keys = coords_to_key(voxel_coords(pc.xyz, inv, origin), pc.mask)
    return _grid_from_segments(pc, _segment_by_key(keys), inv, origin, bucket_size)


def _grid_from_segments(pc: PointCloud, seg: _Segments, inv, origin,
                        bucket_size: int) -> HashGrid:
    n = pc.capacity
    dev = pc.device
    c = bucket_size
    valid_row = seg.sorted_keys != INVALID_KEY
    off = segment_offsets(seg.seg_id, n, valid_row)
    seg_count = (off[1:] - off[:-1]).to(torch.int32)
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


def lookup_voxels(grid: HashGrid, query_keys: torch.Tensor):
    """Slot of each query key in the grid's sorted keys (binary search).
    Returns (slot int32, found)."""
    slot = torch.searchsorted(grid.voxel_keys, query_keys)
    slot = torch.clamp(slot, max=grid.voxel_keys.shape[0] - 1)
    found = (grid.voxel_keys[slot] == query_keys) & (query_keys != INVALID_KEY)
    return slot.to(torch.int32), found


def _topk_small(d2: torch.Tensor, k: int):
    """k masked argmin passes over the last axis; among equal distances the
    lowest candidate position comes first, as in the reference. Returns
    (positions (Q, k) int64, values (Q, k))."""
    work = d2
    cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
    poss, vals = [], []
    for _ in range(k):
        v, p = torch.min(work, dim=1)
        poss.append(p)
        vals.append(v)
        work = torch.where(cols == p[:, None], float("inf"), work)
    return torch.stack(poss, dim=1), torch.stack(vals, dim=1)


def knn(grid: HashGrid, queries: torch.Tensor, query_mask: torch.Tensor, k: int,
        max_radius: Optional[float] = None, stencil: Optional[torch.Tensor] = None):
    """k nearest neighbours by a neighbour-voxel bucket gather and a masked
    top-k: candidates = stencil voxels (default 3x3x3) x bucket capacity,
    exact within one cell radius while no bucket overflowed.

    queries (Q, 3). Returns (pts (Q, k, 3) neighbour coordinates, idx (Q, k)
    int32 original point ids, dist2 (Q, k), valid (Q, k))."""
    if stencil is None:
        stencil = nearby27(queries.device)
    q = queries.shape[0]
    c = grid.bucket_size
    qcoords = voxel_coords(queries, grid.inv_leaf, grid.origin)
    nb_keys = coords_to_key(qcoords[:, None, :] + stencil[None, :, :], query_mask[:, None])
    slot, found = lookup_voxels(grid, nb_keys)                 # (Q, S)
    slot = slot.to(torch.int64)
    rows = grid.bucket_xyz[slot]                               # (Q, S, 3C)
    s = rows.shape[1]
    bx = rows[:, :, 0 * c:1 * c].reshape(q, s * c)
    by = rows[:, :, 1 * c:2 * c].reshape(q, s * c)
    bz = rows[:, :, 2 * c:3 * c].reshape(q, s * c)
    d2 = ((bx - queries[:, 0:1]) ** 2 + (by - queries[:, 1:2]) ** 2
          + (bz - queries[:, 2:3]) ** 2)
    valid = torch.repeat_interleave(found, c, dim=1) & (bx < PAD_COORD * 0.5)
    if max_radius is not None:
        valid = valid & (d2 <= max_radius * max_radius)
    d2 = torch.where(valid, d2, float("inf"))
    pos, top_d2 = _topk_small(d2, k)
    take = lambda x: torch.take_along_dim(x, pos, dim=1)
    top_pts = torch.stack([take(bx), take(by), take(bz)], dim=-1)
    top_valid = take(valid) & query_mask[:, None]
    top_idx = take(grid.bucket_idx[slot].reshape(q, s * c))
    return top_pts, top_idx, torch.where(top_valid, top_d2, float("inf")), top_valid


def nn1(grid: HashGrid, queries: torch.Tensor, query_mask: torch.Tensor,
        max_radius: Optional[float] = None, stencil: Optional[torch.Tensor] = None):
    """Single nearest neighbour (the P2P correspondence)."""
    pts, idx, d2, valid = knn(grid, queries, query_mask, 1, max_radius, stencil)
    return pts[:, 0], idx[:, 0], d2[:, 0], valid[:, 0]


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
    s = segment_sum(torch.cat([w[:, None], pw, (pw[:, :, None] * pts[:, None, :]).reshape(-1, 9)],
                              dim=1),
                    segment_offsets(seg.seg_id, n, seg.sorted_keys != INVALID_KEY))
    cnt, s1, s2 = s[:, 0], s[:, 1:4], s[:, 4:13].reshape(-1, 3, 3)
    mean = s1 / torch.clamp(cnt, min=1.0)[:, None]
    cov = (s2 - cnt[:, None, None] * mean[:, :, None] * mean[:, None, :]) \
        / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    vkeys = _segment_keys(seg, cnt)
    return VoxelStats(keys=vkeys, count=cnt, mean=mean, cov=cov,
                      inv_leaf=inv, origin=origin)
