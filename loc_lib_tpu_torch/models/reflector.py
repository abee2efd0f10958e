"""2D reflective-marker detection, matching and pose recovery (port of
loc_lib_tpu/models/reflector.py).

  * `detect_markers`: beams above the range-banded intensity threshold are
    clustered by angular adjacency (runs of hot beams), the cluster's arc
    width is gated to the reflective-target width band, and the
    `max_markers` clusters with the most beams come out padded and masked;
  * `match_markers`: pairwise-distance voting, the vectorized triangle
    match: a detected pair whose separation matches a map pair's within
    `matching_error` votes for both endpoint assignments, and a marker
    needs `min_pair_votes` (two consistent pairs: a triangle);
  * `estimate_pose`: closed-form SE(2) Kabsch over the matched centres.

Fixed shapes throughout. Float per-cluster sums go through
`voxel.segment_sum` over the beams sorted (stably) by cluster, the order
jax.ops.segment_sum adds them in on the CPU; the cluster's angular extent
is a `scatter_reduce` amin / amax, which does not depend on order; the top
`max_markers` by beam count keep the lower cluster first among equal
counts, as jax.lax.top_k does (a stable sort).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..ops import voxel


@dataclasses.dataclass(frozen=True)
class ReflectorOptions:
    """Mirror of the JAX package's ReflectorOptions (same names and
    defaults)."""

    # range-banded minimum intensity: (max_range_of_band, min_intensity)
    intensity_bands: tuple = ((0.5, 105.0), (2.0, 70.0), (4.0, 50.0),
                              (6.0, 40.0), (math.inf, 30.0))
    width_min: float = 0.025          # target width band (m)
    width_max: float = 0.085
    matching_error: float = 0.03      # pair-length tolerance (m)
    min_pair_votes: int = 2           # triangle criterion
    recognition_distance: float = 6.0
    max_markers: int = 16             # detection capacity (fixed shape)


class Markers(NamedTuple):
    xy: torch.Tensor      # (K, 2) marker centres, lidar frame
    weight: torch.Tensor  # (K,) beams per marker
    valid: torch.Tensor   # (K,)


def _band_threshold(opts: ReflectorOptions, rng: torch.Tensor) -> torch.Tensor:
    th = torch.full_like(rng, torch.inf)
    # far bands first, so the nearer (stricter) bands overwrite them
    for max_r, min_int in reversed(opts.intensity_bands):
        th = torch.where(rng <= max_r, min_int, th)
    return th


def detect_markers(ranges: torch.Tensor, angles: torch.Tensor, intensity: torch.Tensor,
                   valid: torch.Tensor, opts: ReflectorOptions = ReflectorOptions()) -> Markers:
    """Cluster retro-reflective beams into marker centres. ranges, angles,
    intensity, valid: (B,) beams, angles ascending."""
    n = ranges.shape[0]
    dev = ranges.device
    hot = (valid & (ranges > 0.0) & (ranges <= opts.recognition_distance)
           & (intensity >= _band_threshold(opts, ranges)))

    # contiguous runs: cluster id = running count of run starts
    prev_hot = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev), hot[:-1]])
    start = hot & ~prev_hot
    run_id = torch.where(hot, torch.cumsum(start.to(torch.int64), 0) - 1, n)

    xy = torch.stack([ranges * torch.cos(angles), ranges * torch.sin(angles)], -1)
    w = hot.to(torch.float32)
    # hot beams in cluster order (run ids never decrease along the scan),
    # the cold ones after them in no segment
    order = torch.argsort(run_id, stable=True)
    off = voxel.segment_offsets(run_id[order], n, hot[order])
    sums = voxel.segment_sum(torch.stack([w, xy[:, 0] * w, xy[:, 1] * w, ranges * w],
                                         dim=1)[order], off)
    cnt, cx, rsum = sums[:, 0], sums[:, 1:3], sums[:, 3]
    centers = cx / torch.clamp(cnt, min=1.0)[:, None]
    amin = torch.full((n + 1,), torch.inf, dtype=torch.float32, device=dev).scatter_reduce(
        0, run_id, torch.where(hot, angles, torch.inf), "amin")[:-1]
    amax = torch.full((n + 1,), -torch.inf, dtype=torch.float32, device=dev).scatter_reduce(
        0, run_id, torch.where(hot, angles, -torch.inf), "amax")[:-1]
    rmean = rsum / torch.clamp(cnt, min=1.0)
    # the cluster's arc width plus one beam step
    step = torch.abs(angles[1] - angles[0]) if n > 1 else torch.zeros((), device=dev)
    arc = (amax - amin + step) * rmean
    ok = (cnt > 0) & (arc >= opts.width_min) & (arc <= opts.width_max)

    # the max_markers clusters with the most beams, the lower id first on ties
    score = torch.where(ok, cnt, -1.0)
    top = torch.sort(score, descending=True, stable=True).indices[:opts.max_markers]
    return Markers(xy=centers[top], weight=cnt[top], valid=score[top] > 0)


class MatchResult(NamedTuple):
    pairs: torch.Tensor        # (K,) int32 map index per detected marker (-1 none)
    votes: torch.Tensor        # (K,) int32 consistency votes
    num_matched: torch.Tensor  # () int32


def _pair_dists(xy: torch.Tensor) -> torch.Tensor:
    d = xy[:, None, :] - xy[None, :, :]
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def match_markers(det: Markers, map_xy: torch.Tensor, map_valid: torch.Tensor,
                  opts: ReflectorOptions = ReflectorOptions()) -> MatchResult:
    """Pairwise-distance voting. det.xy (K, 2) in the lidar frame, map_xy
    (M, 2) in the map frame: detected pair (i, j) whose length matches map
    pair (a, b) within matching_error votes for i -> a (and, as (j, i), for
    j -> b); each marker takes its best-voted map marker (the first on
    ties) if it has at least min_pair_votes."""
    K, M = det.xy.shape[0], map_xy.shape[0]
    dev = det.xy.device
    ddet = _pair_dists(det.xy)
    dmap = _pair_dists(map_xy)
    vdet = det.valid[:, None] & det.valid[None, :] & ~torch.eye(K, dtype=torch.bool, device=dev)
    vmap = map_valid[:, None] & map_valid[None, :] & ~torch.eye(M, dtype=torch.bool, device=dev)
    consistent = (torch.abs(ddet[:, :, None, None] - dmap[None, None, :, :])
                  <= opts.matching_error)
    consistent = consistent & vdet[:, :, None, None] & vmap[None, None, :, :]
    votes = consistent.to(torch.int32).sum(dim=(1, 3))            # (K, M)
    best = torch.argmax(votes, dim=1)                               # first maximum
    best_v = torch.gather(votes, 1, best[:, None])[:, 0]
    matched = det.valid & (best_v >= opts.min_pair_votes)
    pairs = torch.where(matched, best, -1).to(torch.int32)
    return MatchResult(pairs=pairs, votes=best_v.to(torch.int32),
                       num_matched=matched.to(torch.int32).sum())


class PoseFix(NamedTuple):
    theta: torch.Tensor
    t: torch.Tensor            # (2,)
    num_inliers: torch.Tensor
    rmse: torch.Tensor
    ok: torch.Tensor


def estimate_pose(det: Markers, map_xy: torch.Tensor, match: MatchResult) -> PoseFix:
    """SE(2) Kabsch over the matched pairs: T maps lidar-frame detections
    onto their map markers."""
    matched = match.pairs >= 0
    w = matched.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    src = det.xy
    dst = map_xy[torch.clamp(match.pairs, min=0).long()]
    mu_s = torch.sum(src * w[:, None], 0) / n
    mu_d = torch.sum(dst * w[:, None], 0) / n
    s = src - mu_s
    d = dst - mu_d
    # theta = atan2(sum cross, sum dot)
    dot = torch.sum((s[:, 0] * d[:, 0] + s[:, 1] * d[:, 1]) * w)
    crs = torch.sum((s[:, 0] * d[:, 1] - s[:, 1] * d[:, 0]) * w)
    theta = torch.atan2(crs, dot)
    c, si = torch.cos(theta), torch.sin(theta)
    R = torch.stack([torch.stack([c, -si]), torch.stack([si, c])])
    t = mu_d - R @ mu_s
    res = (src @ R.T + t - dst) * w[:, None]
    rmse = torch.sqrt(torch.sum(res * res) / n)
    k = matched.to(torch.int32).sum()
    return PoseFix(theta=theta, t=t, num_inliers=k, rmse=rmse,
                   ok=(k >= 2) & torch.isfinite(rmse))


def process_scan(ranges, angles, intensity, valid, map_xy, map_valid,
                 opts: ReflectorOptions = ReflectorOptions()) -> PoseFix:
    """One scan: detect, match, pose."""
    det = detect_markers(ranges, angles, intensity, valid, opts)
    return estimate_pose(det, map_xy, match_markers(det, map_xy, map_valid, opts))
