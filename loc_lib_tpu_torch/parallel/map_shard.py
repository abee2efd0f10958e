"""Spatially sharded target maps: the voxel table split over the ranks (port
of loc_lib_tpu/parallel/map_shard.py).

  * The target cloud is cut into slabs along voxel-x over the mesh's "mp"
    axis. Slab bounds are point-count percentiles floored to whole voxels,
    so no voxel straddles two shards and shards stay balanced. Every rank
    computes all bounds from the replicated cloud (cheap, the same bits on
    every rank) and builds ONLY its own slab's structures, so map memory
    per rank is O(total / mp).
  * ICP voxel-plane shards take a one-voxel HALO of points past their slab
    (the plane of a voxel merges its 6 face neighbours), and the halo
    voxels are built but NOT OWNED: exactly one shard answers for any
    voxel. Each shard's key window is anchored at its own voxel-x origin
    `kx` (floor binning is shift-consistent), so a sharded map can span mp
    key windows along x.
  * NDT shards need no halo (voxel statistics are per voxel) and keep the
    global origin: trunc binning is not shift-invariant.
  * Matching: the source rows are split over "dp" and replicated over
    "mp". Per GN iteration each shard elects its nearest valid plane voxel
    per point; two all_reduce MIN over "mp" (the distance, then the shard
    index) pick one winner per point, whose shard folds the point into K1
    (plane given). NDT needs no election: each stencil voxel lives on one
    shard, so the shards' K3 sums just add. One all_reduce SUM of (H, b,
    count, chi2) over the whole mesh closes the iteration.

The election computes each point's transformed position op by op
(kernels.transform_plain), the bits K1 computes inside the kernel (it is
built with -fmad=false), so a point elects and linearizes against the same
voxel. The JAX package elects with `xyz @ R.T + t`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import icp, ndt
from ..ops import kernels, voxel
from ..ops.pointcloud import PointCloud, PAD_COORD
from . import mesh as mesh_mod
from .match import local_cloud, psum_terms

_BIG = 2 ** 30


# ---------------------------------------------------------------------------
# Slab partition
# ---------------------------------------------------------------------------

class SlabPartition(NamedTuple):
    """Point slabs, one row of the leading axis per shard held here.

    xyz      : (S, cap, 3) shard points (halo included), PAD padded
    mask     : (S, cap) bool
    lo, hi   : (mp,) int32 OWNED voxel-x range [lo, hi): tiles the axis
    kx       : (mp,) int32 each shard's key-window origin in voxel-x units
    overflow : (mp,) int32 points each shard dropped at its capacity
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    kx: torch.Tensor
    overflow: torch.Tensor


def _percentiles(mp: int, device) -> torch.Tensor:
    """jnp.linspace(0, 100, mp + 1) / 100 in float32."""
    q = torch.from_numpy(np.linspace(0.0, 100.0, mp + 1).astype(np.float32)).to(device)
    return q / 100.0


def _floored_percentiles(vx: torch.Tensor, live: torch.Tensor, mp: int) -> torch.Tensor:
    """floor(nanpercentile(vx over the live rows, linspace(0, 100, mp + 1)))
    as int32 (mp + 1,): JAX's linear-interpolation formula written out in
    float32, lo * (1 - w) + hi * w at position q (count - 1), so the bounds
    have its bits."""
    vals = torch.sort(torch.where(live, vx.to(torch.float32), torch.inf)).values
    count = live.to(torch.float32).sum()
    pos = _percentiles(mp, vx.device) * (count - 1.0)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    last = count - 1.0
    low = torch.clamp(torch.minimum(low, last), min=0.0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, last), min=0.0).to(torch.int64)
    return torch.floor(vals[low] * lw + vals[high] * hw).to(torch.int32)


def _ownership(b: torch.Tensor):
    """(lo, hi, kx) of each shard from the floored bounds b (mp + 1,): the
    outer shards own the open tails; kx is the middle of the finite slab."""
    fb = b.clone()
    fb[-1] = b[-1] + 1
    kx = torch.div(fb[:-1] + fb[1:], 2, rounding_mode="floor")
    lo, hi = b[:-1].clone(), b[1:].clone()
    lo[0], hi[-1] = -_BIG, _BIG
    return lo, hi, kx


def _in_slab(mask, vx, lo_s, hi_s, halo: int):
    return mask & (vx >= lo_s - halo) & (vx < hi_s + halo)


def _select(xyz, inr, cap: int):
    """The first `cap` rows in the slab (stable), PAD padded."""
    order = torch.argsort((~inr).to(torch.int32), stable=True)[:cap]
    m = inr[order]
    return torch.where(m[:, None], xyz[order], PAD_COORD), m


def _slabs(pc: PointCloud, leaf: float, mp: int, cap: int, halo: int, mode: str,
           shards) -> SlabPartition:
    vx = voxel.voxel_coords(pc.xyz, 1.0 / leaf, None, mode)[:, 0]
    lo, hi, kx = _ownership(_floored_percentiles(vx, pc.mask, mp))
    overflow = torch.stack([
        torch.clamp(_in_slab(pc.mask, vx, lo[s], hi[s], halo).to(torch.int32).sum() - cap,
                    min=0) for s in range(mp)])
    picked = [_select(pc.xyz, _in_slab(pc.mask, vx, lo[s], hi[s], halo), cap) for s in shards]
    return SlabPartition(xyz=torch.stack([p[0] for p in picked]),
                         mask=torch.stack([p[1] for p in picked]),
                         lo=lo, hi=hi, kx=kx, overflow=overflow)


def partition_slabs(pc: PointCloud, leaf: float, mp: int, cap: int, halo: int = 0,
                    mode: str = "floor") -> SlabPartition:
    """Split a cloud into mp voxel-aligned slabs along x, every shard's
    points (the sharded builders take only their own, `_own_slab`).
    Boundaries are percentiles of the points' voxel-x, floored; `halo`
    extends each shard's POINTS by that many voxels on each side without
    extending its ownership."""
    return _slabs(pc, leaf, mp, cap, halo, mode, range(mp))


def _own_slab(mesh: DeviceMesh, pc: PointCloud, leaf: float, cap: int, halo: int,
              mode: str) -> SlabPartition:
    me = mesh_mod.axis_index(mesh, "mp")
    return _slabs(pc, leaf, mesh_mod.axis_size(mesh, "mp"), cap, halo, mode, (me,))


# ---------------------------------------------------------------------------
# Sharded voxel-plane ICP
# ---------------------------------------------------------------------------

class ShardedIcpTarget(NamedTuple):
    """This rank's shard of the target, with every shard's bounds."""

    target: icp.IcpTarget     # the own shard's grid, plane table and dense index
    lo: torch.Tensor          # (mp,)
    hi: torch.Tensor          # (mp,)
    kx: torch.Tensor          # (mp,)
    overflow: torch.Tensor    # (mp,)


def _build_icp_shard(xyz, mask, lo, hi, kx, opts: icp.IcpOptions) -> icp.IcpTarget:
    """One shard's grid and plane table, ownership-masked. The key window
    is anchored kx voxels along x; only voxels whose GLOBAL voxel-x lies in
    [lo, hi) answer, the halo voxels serve their neighbours' merges."""
    origin = torch.stack([kx.to(torch.float32) * opts.grid_leaf,
                          torch.zeros((), device=xyz.device), torch.zeros((), device=xyz.device)])
    pcs = PointCloud(xyz=xyz, mask=mask)
    grid, stats = voxel.build_hash_grid_with_stats(pcs, opts.grid_leaf, opts.bucket_size,
                                                   origin)
    dense = voxel.build_dense_index(grid.voxel_keys, dims=opts.dense_dims)
    plane, mu, valid = icp._build_plane_table(opts, dense, stats)
    gvx = voxel.key_to_coords(grid.voxel_keys)[:, 0] + kx
    valid = valid & (gvx >= lo) & (gvx < hi)
    plane = torch.where(valid[:, None], plane, 0.0)
    packed = torch.cat([plane, mu, valid[:, None].to(torch.float32)], dim=1)
    return icp.IcpTarget(grid=grid, packed=packed, plane=plane, plane_mu=mu,
                         plane_valid=valid, dense=dense)


def set_target_sharded(mesh: DeviceMesh, pc: PointCloud, opts: icp.IcpOptions,
                       shard_capacity: int) -> ShardedIcpTarget:
    """The sharded voxel-plane target (method p2plane_vox): this rank builds
    its own slab (one-voxel halo, floor binning) only."""
    if opts.method != "p2plane_vox":
        raise ValueError(f"the sharded target is p2plane_vox's, got {opts.method!r}")
    part = _own_slab(mesh, pc, opts.grid_leaf, shard_capacity, 1, "floor")
    me = mesh_mod.axis_index(mesh, "mp")
    target = _build_icp_shard(part.xyz[0], part.mask[0], part.lo[me], part.hi[me],
                              part.kx[me], opts)
    return ShardedIcpTarget(target=target, lo=part.lo, hi=part.hi, kx=part.kx,
                            overflow=part.overflow)


def elect(mesh: DeviceMesh, tgt: icp.IcpTarget, src: PointCloud, R, t, index):
    """The cross-shard election of `icp_scan_match_sharded` at pose (R, t):
    this shard's nearest valid plane voxel per point among the point's
    voxel and its 6 face neighbours (the first stencil entry on ties), then
    the global winner by two all_reduce MIN over "mp" (least distance, then
    least shard index). Returns (plane (N, 4), w (N,)): each point's plane
    on this shard and 1 where this shard won it."""
    me = mesh_mod.axis_index(mesh, "mp")
    rows7 = kernels.stencil_rows_plain(src.xyz, src.mask, R, t, tgt.packed, index)
    qs = kernels.transform_plain(src.xyz, R, t)
    d2 = torch.where(rows7[..., 7] > 0.5,
                     torch.sum((rows7[..., 4:7] - qs[:, None, :]) ** 2, dim=-1), torch.inf)
    d2_loc, pick = torch.min(d2, dim=1)
    plane = torch.take_along_dim(rows7[..., 0:4], pick[:, None, None], dim=1)[:, 0]
    d2_min = mesh_mod.pmin(d2_loc, mesh, "mp")
    cand = torch.where((d2_loc == d2_min) & torch.isfinite(d2_loc), me, _BIG).to(torch.int32)
    winner = mesh_mod.pmin(cand, mesh, "mp")
    return plane, ((cand == winner) & (cand < _BIG) & src.mask).to(torch.float32)


def _sharded_p2plane_terms(mesh: DeviceMesh):
    """The linearization of `icp_scan_match_sharded` in the signature of
    icp._TERM_FNS: the election, then K1 with the plane given over the
    points this shard won."""
    def terms(tgt: icp.IcpTarget, opts, src: PointCloud, R, t, gate=None):
        plane, w = elect(mesh, tgt, src, R, t, icp._index(tgt, opts, tgt.dense))
        return kernels.p2plane_fused_terms(src.xyz, plane, w, R, t, icp._gate(opts, gate))
    return terms


def icp_scan_match_sharded(mesh: DeviceMesh, st: ShardedIcpTarget, opts: icp.IcpOptions,
                           src: PointCloud, R0, t0) -> icp.MatchResult:
    """Distributed voxel-plane ICP over a (dp, mp) mesh: source rows over
    "dp", the plane table over "mp"; the port's GN loop with one all_reduce
    of (H, b, count, chi2) over the mesh per iteration."""
    return icp._gauss_newton(_sharded_p2plane_terms(mesh), st.target, opts,
                             local_cloud(src, mesh), R0, t0,
                             reduce=psum_terms(mesh, ("dp", "mp")))


# ---------------------------------------------------------------------------
# Sharded NDT (direct and incremental)
# ---------------------------------------------------------------------------

class ShardedNdtMap(NamedTuple):
    map: ndt.NdtMap           # this rank's shard
    lo: torch.Tensor          # (mp,)
    hi: torch.Tensor          # (mp,)
    overflow: torch.Tensor    # (mp,)


def build_direct_sharded(mesh: DeviceMesh, pc: PointCloud, opts: ndt.NdtOptions,
                         shard_capacity: int) -> ShardedNdtMap:
    """Sharded direct NDT target: this rank's Gaussian table over its own
    voxel slab (trunc binning, the global origin, no halo)."""
    part = _own_slab(mesh, pc, opts.voxel_size, shard_capacity, 0, "trunc")
    m = ndt.build_direct(PointCloud(xyz=part.xyz[0], mask=part.mask[0]), opts)
    return ShardedNdtMap(map=m, lo=part.lo, hi=part.hi, overflow=part.overflow)


def build_incremental_sharded(mesh: DeviceMesh, pc: PointCloud,
                              opts: ndt.NdtOptions) -> ShardedNdtMap:
    """Start a sharded INCREMENTAL NDT map from the first scan: the slab
    bounds come from its points and stay fixed for the map's life (each
    voxel has one owner), and each shard holds its own table of
    opts.map_capacity voxels."""
    part = _own_slab(mesh, pc, opts.voxel_size, pc.capacity, 0, "trunc")
    m0 = ndt.empty_incremental(opts, device=pc.device)
    m = ndt.update_incremental(m0, PointCloud(xyz=part.xyz[0], mask=part.mask[0]), opts)
    return ShardedNdtMap(map=m, lo=part.lo, hi=part.hi, overflow=part.overflow)


def update_incremental_sharded(mesh: DeviceMesh, sm: ShardedNdtMap, pc: PointCloud,
                               opts: ndt.NdtOptions) -> ShardedNdtMap:
    """Absorb a scan: this shard merges the points whose voxel lies in its
    slab (fixed bounds), with the usual order-free, age-evicting merge."""
    me = mesh_mod.axis_index(mesh, "mp")
    vx = voxel.voxel_coords(pc.xyz, 1.0 / opts.voxel_size, None, "trunc")[:, 0]
    own = pc.mask & (vx >= sm.lo[me]) & (vx < sm.hi[me])
    return sm._replace(map=ndt.update_incremental(sm.map, PointCloud(xyz=pc.xyz, mask=own),
                                                  opts))


def ndt_scan_match_sharded(mesh: DeviceMesh, sm: ShardedNdtMap, opts: ndt.NdtOptions,
                           src: PointCloud, R0, t0) -> ndt.MatchResult:
    """Distributed NDT: source rows over "dp", the Gaussian table over "mp".
    Each (point, stencil voxel) residual exists on exactly one shard, so
    the sum over both axes is the single-device system. Direct mode gates
    on the source count over "dp" (the reference's per-point quirk; points
    are replicated over "mp")."""
    local = local_cloud(src, mesh)
    return ndt.scan_match(sm.map, opts, local, R0, t0, reduce=psum_terms(mesh, ("dp", "mp")),
                          n_points=mesh_mod.psum(local.count(), mesh, "dp"))


# ---------------------------------------------------------------------------
# Pose-graph correction written through the sharded map
# ---------------------------------------------------------------------------

_ROW_WORDS = 16      # key, count, mean (3), cov (9), estimated, age: int32 words


def _corrected_rows(m: ndt.NdtMap, dR, dt, opts: ndt.NdtOptions) -> torch.Tensor:
    """This shard's live voxel moments moved by the rigid correction, one
    (V, 16) int32 row of words each: mean' = dR mu + dt (op by op),
    cov' = dR cov dR^T, key' re-binned from the moved mean (trunc, the
    global origin). A rotated voxel's mass goes to the cell its centroid
    lands in: the documented approximation of the JAX package."""
    live = m.keys != voxel.INVALID_KEY
    mu2 = kernels.transform_plain(m.mean, dR, dt)
    cov2 = torch.einsum("ij,vjk,lk->vil", dR, m.cov, dR)
    keys2 = voxel.coords_to_key(voxel.voxel_coords(mu2, 1.0 / opts.voxel_size, None, "trunc"),
                                live)
    return torch.cat([keys2[:, None], m.count[:, None].view(torch.int32),
                      mu2.contiguous().view(torch.int32),
                      cov2.reshape(-1, 9).contiguous().view(torch.int32),
                      m.estimated[:, None].to(torch.int32), m.age[:, None]], dim=1)


def apply_correction_sharded(mesh: DeviceMesh, sm: ShardedNdtMap, dR, dt,
                             opts: ndt.NdtOptions) -> ShardedNdtMap:
    """Write a pose-graph rigid correction THROUGH the sharded map: every
    shard moves its live Gaussians (`_corrected_rows`), every rank gets all
    shards' rows (one all_reduce of a zero-filled buffer of int32 words
    over "mp"), new slab bounds come from the moved map (percentiles of the
    live rows' voxel-x: this also re-balances a skewed partition), and each
    shard rebuilds its table from the rows it now owns
    (`ndt.rebuild_from_moments`, exact on key collisions) at the latest
    epoch over the shards. The overflow counters are carried over
    unchanged, as in the JAX package."""
    dev = sm.map.keys.device
    dR = torch.as_tensor(dR, dtype=torch.float32, device=dev)
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    words = mesh_mod.gather_slots(_corrected_rows(sm.map, dR, dt, opts), mesh, "mp")
    words = words.reshape(-1, _ROW_WORDS)
    keys = words[:, 0].contiguous()
    cnt = words[:, 1].contiguous().view(torch.float32)
    mean = words[:, 2:5].contiguous().view(torch.float32)
    cov = words[:, 5:14].contiguous().view(torch.float32).reshape(-1, 3, 3)
    est = words[:, 14] != 0
    age = words[:, 15].contiguous()

    mp = mesh_mod.axis_size(mesh, "mp")
    me = mesh_mod.axis_index(mesh, "mp")
    vx = voxel.voxel_coords(mean, 1.0 / opts.voxel_size, None, "trunc")[:, 0]
    live = keys != voxel.INVALID_KEY
    lo, hi, _ = _ownership(_floored_percentiles(vx, live, mp))
    own = live & (vx >= lo[me]) & (vx < hi[me])
    # the latest epoch over the shards (max = -min(-x))
    epoch = -int(mesh_mod.pmin(torch.tensor([-sm.map.epoch], dtype=torch.int32, device=dev),
                               mesh, "mp"))
    m = ndt.rebuild_from_moments(torch.where(own, keys, voxel.INVALID_KEY),
                                 torch.where(own, cnt, 0.0), mean, cov, est & own, age,
                                 epoch, torch.zeros(3, device=dev), opts)
    return ShardedNdtMap(map=m, lo=lo, hi=hi, overflow=sm.overflow)


def live_voxels(mesh: DeviceMesh, sm: Optional[ShardedNdtMap]) -> torch.Tensor:
    """(mp,) live voxel count of every shard, on every rank."""
    own = (sm.map.keys != voxel.INVALID_KEY).sum().to(torch.int32)
    return mesh_mod.gather_slots(own.reshape(1), mesh, "mp")[:, 0]
