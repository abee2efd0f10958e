"""LOAM: curvature feature extraction + fused edge/surf registration (port of
loc_lib_tpu/models/loam.py).

Feature extraction is the JAX package's batched program over a ring-sorted
point array: curvature is the squared norm of the 11-point second
difference along the ring; each ring is split into 6 index-range sectors;
per sector at most 20 local-maximum points with curvature > 0.1 become
edges, suppressing their +-5 ring neighbors; the remaining eligible points
are surf. The JAX package's documented deviations from the reference are
kept as they are (they are the parity target): (a) edge picks are top-k by
curvature among points that are the maximum of their +-5 ring window, in
place of the reference's sequential pick-then-suppress loop; (b) the
suppression stop at depth gaps > 0.05 is not replicated.

Registration: per Gauss-Newton iteration one surf linearization
(`p2plane_vox`, kernel K2) and one edge linearization (`p2line_vox`,
kernel K3 at S = 1), summed into one 6x6 system, one joint solve; a host
loop that reads `converged` back once per iteration, as icp.scan_match.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.pointcloud import PointCloud
from ..ops import kernels, voxel
from ..utils import timing
from . import icp


@dataclasses.dataclass(frozen=True)
class LoamFeatureOptions:
    """Mirror of the JAX package's LoamFeatureOptions."""

    num_scan: int = 16
    min_ring_pts: int = 131        # rings shorter than this are skipped
    edge_curvature_th: float = 0.1
    max_edge_per_sector: int = 20
    num_sectors: int = 6
    suppress_radius: int = 5


@dataclasses.dataclass(frozen=True)
class LoamOption:
    """Mirror of the JAX package's LoamOption, with the fields its matcher
    reads: surf on p2plane_vox, edge on p2line_vox, eps 1e-3 (the knn
    methods "p2plane" / "p2line" are the per-probe 5-NN oracle). A feature
    kind switched off by `use_surf_points` / `use_edge_points` adds nothing
    to the system and launches no kernel; the step threshold stays the sum
    of both matchers' min_effective_pts."""

    feature: LoamFeatureOptions = LoamFeatureOptions()
    surf_icp: icp.IcpOptions = icp.IcpOptions(method="p2plane_vox")
    edge_icp: icp.IcpOptions = icp.IcpOptions(method="p2line_vox")
    min_edge_pts: int = 20          # read by nothing, as in JAX
    min_surf_pts: int = 20
    max_iteration: int = 20
    use_edge_points: bool = True
    use_surf_points: bool = True
    eps: float = 1e-3


class LoamFeatures(NamedTuple):
    edge: PointCloud
    surf: PointCloud


def _ring_position(ring_sorted: torch.Tensor, valid: torch.Tensor):
    """Index of each row within its ring and the ring's valid size, for rows
    sorted by ring (valid rows first). Returns (idx_in_ring, ring_size)."""
    n = ring_sorted.shape[0]
    dev = ring_sorted.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    is_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          ring_sorted[1:] != ring_sorted[:-1]]) & valid
    start_pos = torch.cummax(torch.where(is_start, idx, 0), 0).values
    seg_id = torch.clamp(torch.cumsum(is_start.to(torch.int64), 0) - 1, min=0)
    off = voxel.segment_offsets(seg_id, n, valid)
    return idx - start_pos, (off[1:] - off[:-1])[seg_id]


def extract_features(pc: PointCloud, opts: LoamFeatureOptions = LoamFeatureOptions()
                     ) -> LoamFeatures:
    """Edge/surf split of a ring-annotated cloud. Output clouds keep the
    input rows (coordinates unchanged); masks select the features."""
    if pc.ring is None:
        raise ValueError("LOAM extraction needs per-point ring indices")
    n = pc.capacity
    r = opts.suppress_radius
    dev = pc.device

    # sort by ring, stable in scan order
    ring_key = torch.where(pc.mask, pc.ring.to(torch.int32), 1 << 20)
    order = torch.argsort(ring_key, stable=True)
    xyz = pc.xyz[order]
    ring = ring_key[order]
    valid = pc.mask[order]

    # 11-point second difference along the sorted axis
    deltas = [s for s in range(-r, r + 1) if s != 0]
    acc = -2.0 * r * xyz
    same_ring = valid
    for s in deltas:
        acc = acc + torch.roll(xyz, -s, 0)
        same_ring = same_ring & (torch.roll(ring, -s, 0) == ring) & torch.roll(valid, -s, 0)
    curvature = torch.sum(acc * acc, dim=-1)

    idx_in_ring, ring_size = _ring_position(ring, valid)
    in_window = same_ring & (idx_in_ring >= r) & (idx_in_ring < ring_size - r)
    eligible = valid & in_window & (ring_size >= opts.min_ring_pts)

    # index-range sectors over total = ring_size - 2r (floor division)
    total = torch.clamp(ring_size - 2 * r, min=1)
    sector = torch.clamp(torch.div((idx_in_ring - r) * opts.num_sectors, total,
                                   rounding_mode="floor"), 0, opts.num_sectors - 1)

    # edge = top-k curvature per (ring, sector) among local maxima above the
    # threshold
    win_max = curvature
    for s in deltas:
        win_max = torch.maximum(win_max, torch.where(torch.roll(ring, -s, 0) == ring,
                                                     torch.roll(curvature, -s, 0), -torch.inf))
    cand = eligible & (curvature >= win_max) & (curvature > opts.edge_curvature_th)

    sector_key = torch.where(cand, ring.to(torch.int64) * opts.num_sectors + sector, 1 << 24)
    # jnp.lexsort((-curvature, sector_key)): stable sorts, secondary key first
    by_curv = torch.argsort(-curvature, stable=True)
    rank_order = by_curv[torch.argsort(sector_key[by_curv], stable=True)]
    rk_sector = sector_key[rank_order]
    idx2 = torch.arange(n, dtype=torch.int64, device=dev)
    sec_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           rk_sector[1:] != rk_sector[:-1]])
    rank_sorted = idx2 - torch.cummax(torch.where(sec_start, idx2, 0), 0).values
    rank = torch.empty_like(rank_sorted)
    rank[rank_order] = rank_sorted
    edge_mask = cand & (rank < opts.max_edge_per_sector)

    # +-r ring neighbors of an edge are excluded from surf
    suppressed = edge_mask
    for s in deltas:
        suppressed = suppressed | (torch.roll(edge_mask, s, 0) & (torch.roll(ring, s, 0) == ring))
    surf_mask = eligible & ~suppressed

    # un-sort back to the input row order
    inv = torch.empty_like(order)
    inv[order] = idx2
    return LoamFeatures(edge=pc._replace(mask=edge_mask[inv]),
                        surf=pc._replace(mask=surf_mask[inv]))


class LoamTarget(NamedTuple):
    edge: icp.IcpTarget
    surf: icp.IcpTarget


def set_target(edge_pc: PointCloud, surf_pc: PointCloud, opts: LoamOption,
               origin=None) -> LoamTarget:
    """A line target over the edge cloud and a plane target over the surf
    cloud, on one key-window origin."""
    return LoamTarget(edge=icp.set_target(edge_pc, opts.edge_icp, origin),
                      surf=icp.set_target(surf_pc, opts.surf_icp, origin))


def scan_match(target: LoamTarget, opts: LoamOption, edge_src: PointCloud,
               surf_src: PointCloud, R0, t0) -> icp.MatchResult:
    """Joint Gauss-Newton alignment: H = H_surf + H_edge, b = b_surf +
    b_edge per iteration; a step is taken when the summed effective count
    reaches both matchers' min_effective_pts; stop at |dx| < eps."""
    dev = surf_src.device
    loop = kernels.GnLoop(torch.as_tensor(R0, dtype=torch.float32, device=dev),
                          torch.as_tensor(t0, dtype=torch.float32, device=dev),
                          opts.surf_icp.min_effective_pts + opts.edge_icp.min_effective_pts,
                          opts.eps)
    parts = []
    if opts.use_surf_points:
        parts.append((target.surf, opts.surf_icp, surf_src))
    if opts.use_edge_points:
        parts.append((target.edge, opts.edge_icp, edge_src))
    it = 0
    while it < opts.max_iteration:
        lins = [icp.compute_h_and_b(tgt, o, src, loop.R, loop.t) for tgt, o, src in parts]
        if not lins:        # nothing to match: the reference's zero system
            lins = [(torch.zeros((6, 6), dtype=torch.float32, device=dev),
                     torch.zeros((6,), dtype=torch.float32, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev),
                     torch.zeros((), dtype=torch.float32, device=dev))]
        it += 1
        # the two systems summed (0 + Hs + He), the solve, filters,
        # retraction and stop test: one launch
        if not timing.host_bool(loop.step(lins[0], lin2=lins[1] if len(lins) > 1 else None)):
            break
    R, t, converged, n_eff, chi2, _ = loop.result()
    return icp.MatchResult(R=R, t=t, converged=converged, num_effective=n_eff, iterations=it,
                           chi2=chi2)
