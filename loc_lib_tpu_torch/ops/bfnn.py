"""Brute-force exact nearest neighbours, the library's oracle search (port of
loc_lib_tpu/ops/bfnn.py).

The ground truth the hash-grid `ops.voxel.knn` is checked against: a masked
distance matrix over the WHOLE cloud and a top-k, with no stencil-radius
bound. Same contract as voxel.knn.

The distance matrix uses |q - t|^2 = |q|^2 - 2 q.t + |t|^2, the cross term
one (Q, 3) x (3, N) float32 matrix product (torch keeps TF32 off for
float32 products unless a caller turns it on). Queries are taken in tiles
of `tile` rows, so the distance matrix held at once is tile x N (at 65,536
targets and 1,024 queries a tile, 256 MB). The top-k keeps the lower target
index first among equal distances, as jax.lax.top_k does: it runs on one
int64 key per entry, the distance's float32 bits (non-negative, so ordered
as integers) above the index.
"""

from __future__ import annotations

import torch

from .pointcloud import PointCloud


def _topk_lowest_index_first(d2: torch.Tensor, k: int):
    """The k smallest entries of each row of d2 (>= 0 or +inf), ties to the
    lower column. Returns (d2 (Q, k), idx (Q, k) int64)."""
    n = d2.shape[1]
    bits = (d2 + 0.0).view(torch.int32).to(torch.int64)      # + 0.0 turns -0.0 into 0.0
    cols = torch.arange(n, dtype=torch.int64, device=d2.device)
    key = (bits << 32) | cols
    idx = torch.topk(key, k, dim=1, largest=False, sorted=True).indices
    return torch.gather(d2, 1, idx), idx


def knn(target: PointCloud, queries: torch.Tensor, query_mask: torch.Tensor, k: int = 1,
        tile: int = 1024):
    """Exact k-NN of each query against every valid target point.

    queries (Q, 3). Returns (pts (Q, k, 3), idx (Q, k) int32, dist2 (Q, k),
    valid (Q, k)): a neighbour is valid where its distance is finite and its
    query is; invalid entries carry dist2 = +inf."""
    t = target.xyz                                              # (N, 3)
    tt = torch.sum(t * t, dim=1)[None, :]
    d2_out, idx_out = [], []
    for s in range(0, queries.shape[0], tile):
        q = queries[s:s + tile]
        cross = q @ t.T                                         # (tile, N)
        d2 = torch.sum(q * q, dim=1)[:, None] - 2.0 * cross + tt
        d2 = torch.clamp(d2, min=0.0)                           # numeric floor
        d2 = torch.where(target.mask[None, :], d2, torch.inf)
        top_d2, idx = _topk_lowest_index_first(d2, k)
        d2_out.append(top_d2)
        idx_out.append(idx)
    top_d2 = torch.cat(d2_out)
    idx = torch.cat(idx_out)
    valid = torch.isfinite(top_d2) & query_mask[:, None]
    return t[idx], idx.to(torch.int32), torch.where(valid, top_d2, torch.inf), valid


def nn1(target: PointCloud, queries: torch.Tensor, query_mask: torch.Tensor):
    """The single exact nearest neighbour: (pts (Q, 3), idx (Q,), d2 (Q,),
    valid (Q,))."""
    pts, idx, d2, valid = knn(target, queries, query_mask, 1)
    return pts[:, 0], idx[:, 0], d2[:, 0], valid[:, 0]
