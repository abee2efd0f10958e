"""ScanContext: polar max-height descriptor and loop-closure retrieval (port
of loc_lib_tpu/graph/scan_context.py).

  * `descriptor`: one scatter-max over all points -> (R, S) grid of the
    highest point (z + 2 m) per (ring, sector) cell;
  * `ring_key`: per-ring occupancy, the rotation-invariant key;
  * `detect_loop_topk` / `detect_loop`: a ring-key L2 gate keeps the best
    search_ratio of the database, then the descriptor distance (the minimum
    over all S column shifts of the mean per-column cosine distance) of
    every candidate at every shift in one batched contraction;
  * `ScanContextDb`: the descriptors in a ring buffer on the device.

Ties: the reference takes `jax.lax.top_k`, which puts the lower index first
among equal values; `torch.topk` makes no such promise, so both selections
here are a stable ascending sort, sliced. Ring keys are occupancy ratios in
steps of 1/num_sector, so equal key distances are common and the tie order
decides which candidates pass the search_ratio cut.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops.pointcloud import PointCloud, card_device


@dataclasses.dataclass(frozen=True)
class ScanContextOptions:
    """Mirror of the JAX package's ScanContextOptions."""

    num_ring: int = 20
    num_sector: int = 60
    max_radius: float = 80.0
    search_ratio: float = 0.1        # fraction of the DB kept by the ring-key gate
    dist_threshold: float = 0.13     # descriptor distance acceptance gate
    exclude_recent: int = 30         # don't match the most recent insertions


def descriptor(pc: PointCloud, opts: ScanContextOptions = ScanContextOptions()) -> torch.Tensor:
    """(R, S) polar max-height grid: the largest z + 2 m of the points in each
    (ring, sector) bin, 0 where the bin is empty. The maximum does not
    depend on the order of the points."""
    x, y, z = pc.xyz[:, 0], pc.xyz[:, 1], pc.xyz[:, 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.remainder(torch.atan2(y, x), 2.0 * math.pi)
    ring = torch.clamp((r / opts.max_radius * opts.num_ring).to(torch.int32),
                       0, opts.num_ring - 1)
    sector = torch.clamp((theta / (2 * math.pi) * opts.num_sector).to(torch.int32),
                         0, opts.num_sector - 1)
    ok = pc.mask & (r <= opts.max_radius)
    cells = opts.num_ring * opts.num_sector
    flat = torch.where(ok, ring * opts.num_sector + sector, cells).to(torch.int64)
    zz = torch.where(ok, z + 2.0, -math.inf)
    grid = torch.full((cells + 1,), -math.inf, dtype=torch.float32, device=pc.device)
    grid = grid.scatter_reduce(0, flat, zz, "amax")
    grid = torch.where(torch.isfinite(grid), grid, 0.0)
    return grid[:-1].reshape(opts.num_ring, opts.num_sector)


def ring_key(desc: torch.Tensor) -> torch.Tensor:
    """(R,) rotation-invariant key: per-ring occupancy ratio. The count
    times the float32 reciprocal of S, the bits XLA:CPU gives the
    reference's mean (a division differs in the last bit for half of the
    ratios, and ring keys tie often)."""
    occupied = (desc != 0.0).to(torch.float32)
    return torch.sum(occupied, dim=-1) * (1.0 / desc.shape[-1])


def _shifted_distance(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Min-over-shifts cosine distance between the query (R, S) and each DB
    descriptor (N, R, S): returns (N,)."""
    s = q.shape[-1]
    # all S cyclic shifts of the query, (S, R, S): shifts[k] = roll(q, k, -1)
    ar = torch.arange(s, device=q.device)
    shifts = q[:, (ar[None, :] - ar[:, None]) % s].permute(1, 0, 2)
    # per-column cosine similarity, averaged over non-degenerate columns
    q_norm = torch.linalg.vector_norm(shifts, dim=-2)          # (S, S)
    qn = q_norm + 1e-12
    dn = torch.linalg.vector_norm(db, dim=-2) + 1e-12          # (N, S)
    dots = torch.einsum("krs,nrs->nks", shifts, db)            # (N, S, S)
    cos = dots / (qn[None] * dn[:, None])
    valid = (q_norm[None] > 1e-9) & (dn[:, None] > 1e-9)
    sim = torch.sum(torch.where(valid, cos, 0.0), dim=-1) / torch.clamp(
        torch.sum(valid, dim=-1), min=1)
    return 1.0 - torch.amax(sim, dim=-1)                       # (N,)


class LoopResult(NamedTuple):
    index: torch.Tensor      # int32 matched insertion id, -1 if none
    distance: torch.Tensor   # float32 descriptor distance
    found: torch.Tensor      # bool


def _smallest(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries, the lower index first among equal
    ones (jax.lax.top_k's order on -x)."""
    return torch.sort(x, stable=True).indices[:k]


def detect_loop_topk(query_desc: torch.Tensor, db_desc: torch.Tensor, db_keys: torch.Tensor,
                     db_ids: torch.Tensor, db_count: int,
                     opts: ScanContextOptions = ScanContextOptions(), topk: int = 1
                     ) -> LoopResult:
    """The `topk` best matches, best first: every field has a leading (topk,)
    axis; entries past the acceptable matches carry index -1 / found False.
    db_desc (N, R, S) padded database, db_keys (N, R), db_ids (N,) insertion
    id per slot (-1: empty; the DB is a ring buffer, so slot order is not
    insertion order), db_count the number of descriptors ever inserted. The
    most recent `exclude_recent` insertions are not matched."""
    eligible = (db_ids >= 0) & (db_ids < db_count - opts.exclude_recent)
    key_d2 = torch.sum((db_keys - ring_key(query_desc)) ** 2, dim=-1)
    key_d2 = torch.where(eligible, key_d2, math.inf)

    # ring-key gate: keep the best ~search_ratio * N candidates
    n = db_desc.shape[0]
    k = max(1, int(opts.search_ratio * n))
    top_idx = _smallest(key_d2, k)
    cand_ok = torch.isfinite(key_d2[top_idx])

    dist = _shifted_distance(query_desc, db_desc[top_idx])   # (k,)
    dist = torch.where(cand_ok, dist, math.inf)
    kk = min(topk, k)
    order = _smallest(dist, kk)
    best_dist = dist[order]                                    # (kk,) ascending
    found = torch.isfinite(best_dist) & (best_dist < opts.dist_threshold)
    ids = torch.where(found, db_ids[top_idx[order]], -1).to(torch.int32)
    if kk < topk:   # DB smaller than the ask: pad with not-found lanes
        pad = topk - kk
        dev = ids.device
        ids = torch.cat([ids, torch.full((pad,), -1, dtype=torch.int32, device=dev)])
        best_dist = torch.cat([best_dist, torch.full((pad,), math.inf, device=dev)])
        found = torch.cat([found, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return LoopResult(index=ids, distance=best_dist, found=found)


def detect_loop(query_desc, db_desc, db_keys, db_ids, db_count: int,
                opts: ScanContextOptions = ScanContextOptions()) -> LoopResult:
    """The best match (`detect_loop_topk` at topk = 1, without the axis).
    `index` is the matched INSERTION id."""
    res = detect_loop_topk(query_desc, db_desc, db_keys, db_ids, db_count, opts, topk=1)
    return LoopResult(index=res.index[0], distance=res.distance[0], found=res.found[0])


class ScanContextDb:
    """Descriptor database: a ring buffer of `capacity` descriptors on the
    device (default: the card, see `pointcloud.card_device`). At capacity
    the oldest descriptor is overwritten and counted in `evicted`; `add`
    returns the insertion id and queries report insertion ids, so callers'
    ids (keyframe indices) stay stable across evictions."""

    def __init__(self, capacity: int = 4096, opts: ScanContextOptions = ScanContextOptions(),
                 *, device=None):
        self.opts = opts
        self.capacity = capacity
        dev = card_device(device)
        self.desc = torch.zeros((capacity, opts.num_ring, opts.num_sector),
                                dtype=torch.float32, device=dev)
        self.keys = torch.zeros((capacity, opts.num_ring), dtype=torch.float32, device=dev)
        self.ids = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
        self.count = 0        # descriptors ever inserted
        self.evicted = 0      # descriptors overwritten after saturation

    def add(self, pc: PointCloud) -> int:
        slot = self.count % self.capacity
        if self.count >= self.capacity:
            self.evicted += 1
        d = descriptor(pc, self.opts)
        self.desc[slot] = d
        self.keys[slot] = ring_key(d)
        self.ids[slot] = self.count
        self.count += 1
        return self.count - 1

    def query(self, pc: PointCloud) -> LoopResult:
        return detect_loop(descriptor(pc, self.opts), self.desc, self.keys, self.ids,
                           self.count, self.opts)

    def query_topk(self, pc: PointCloud, topk: int) -> LoopResult:
        """The `topk` best matches, best first."""
        return detect_loop_topk(descriptor(pc, self.opts), self.desc, self.keys, self.ids,
                                self.count, self.opts, topk=topk)
