"""NDT scan matching: direct and incremental voxelized-Gaussian alignment
(port of loc_lib_tpu/models/ndt.py).

Direct mode: one `voxel_stats` segment reduce builds per-voxel (count, mean,
cov); voxels with count > min_pts_in_voxel keep an information matrix from
the eigenvalue-clamped covariance inverse. Alignment gathers the NEARBY6
stencil per point, gates residuals at the chi2 threshold res_outlier_th and
accumulates the UNWEIGHTED system (the information only gates), counting
every source point as effective (a reference quirk kept as in JAX).

Incremental mode: a bounded voxel table updated per keyframe by a
moment-matched merge, frozen past max_pts_in_voxel, estimated once count >
min_pts_in_voxel, with epoch-stamped least-recently-touched eviction; the
information-WEIGHTED system H += J^T info J.

Voxel membership uses C++ truncation (mode="trunc") unless `bin_mode` says
floor. The fused path (use_fused=True) is ONE call of kernel K3 from the map
(ops/kernels.ndt_fused_terms_from_map) per linearization: the kernel
transforms the point, takes its voxel (trunc or floor), looks the S = 7 (or
1) stencil voxels up in the dense table, reads their packed rows and sums
the normal equations, so no (N, S, 13) row tensor is made. On the H100 a
call is bounded by bytes (the points and the distinct table cells and rows
they touch, under 1 MB) and costs a launch and a chain of four dependent
loads; on the CPU the wrapper takes the plain version (the same gather in
torch ops, kernels.ndt_stencil_rows_plain, then K3's rows). use_fused=False
keeps the searchsorted + einsum oracle the fused path is held to.

Differences from the JAX package, semantics kept:
  * `NdtMap.epoch` is a host int (the first-scan rule branches on it);
  * `jnp.lexsort((tag, keys))` becomes one stable sort on keys * 2 + tag,
    and every sort whose ties reach the output is stable;
  * `segment_sum` / `segment_max` become `voxel.segment_sum` (a serial
    sum per run, the same bits on every run) / `scatter_reduce(amax)`;
  * the Gauss-Newton loop is a host loop that reads `converged` back once
    per iteration.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from ..ops.pointcloud import PointCloud, card_device
from ..ops import kernels, voxel
from ..utils import lie, mathx, timing

_INT32_MAX = torch.iinfo(torch.int32).max
_INT32_MIN = torch.iinfo(torch.int32).min


@dataclasses.dataclass(frozen=True)
class NdtOptions:
    """Mirror of the JAX package's NdtOptions (same names and defaults)."""

    method: str = "direct"            # direct | incremental
    voxel_size: float = 1.0
    min_pts_in_voxel: int = 3         # strictly greater-than gate
    max_pts_in_voxel: int = 50
    nearby: str = "nearby6"           # center | nearby6
    max_iteration: int = 20
    eps: float = 1e-2
    res_outlier_th: float = 20.0
    min_effective_pts: int = 10
    map_capacity: int = 65536         # incremental voxel table rows
    use_fused: bool = True            # dense lookup + kernel K3
    dense_dims: tuple = (256, 256, 64)
    bin_mode: str = "trunc"           # trunc (reference cast) | floor


def _stencil(opts: NdtOptions, device) -> torch.Tensor:
    return voxel.nearby6(device) if opts.nearby == "nearby6" else voxel.center1(device)


class NdtMap(NamedTuple):
    """Sorted voxel-Gaussian table (both modes).

    keys      : (V,) int32 sorted (INVALID_KEY padded)
    count     : (V,) float32 total points absorbed
    mean      : (V, 3)
    cov       : (V, 3, 3)
    info      : (V, 3, 3)
    estimated : (V,) bool, Gaussian ready for matching
    age       : (V,) int32 epoch last touched (incremental eviction)
    epoch     : host int, number of updates applied
    origin    : (3,) float32 key-window origin
    packed    : (V, 13) [mu(3), W(9) row-major sqrt factor, est(1)]: one
                row gather per stencil probe feeds K3 (None when
                use_fused=False)
    dense_table, dense_lo : the voxel.DenseIndex fields
    """

    keys: torch.Tensor
    count: torch.Tensor
    mean: torch.Tensor
    cov: torch.Tensor
    info: torch.Tensor
    estimated: torch.Tensor
    age: torch.Tensor
    epoch: int
    origin: torch.Tensor
    packed: Optional[torch.Tensor] = None
    dense_table: Optional[torch.Tensor] = None
    dense_lo: Optional[torch.Tensor] = None


def _finalize_map(m: NdtMap, opts: NdtOptions) -> NdtMap:
    """Attach the fused path's structures: square-root-factored rows (info =
    W W^T by Cholesky, so K3's |W^T e|^2 is the chi2 gate e^T info e) and
    the dense O(1) slot index."""
    if not opts.use_fused:
        return m
    L = mathx.cholesky_3x3(torch.where(m.estimated[:, None, None], m.info, 0.0))
    W = mathx.cholesky_3x3_unpack(L).reshape(-1, 9)
    packed = torch.cat([m.mean, W, m.estimated[:, None].to(torch.float32)], dim=1)
    dense = voxel.build_dense_index(m.keys, dims=opts.dense_dims)
    return m._replace(packed=packed, dense_table=dense.table, dense_lo=dense.lo)


def _origin(origin, device) -> torch.Tensor:
    if origin is None:
        return torch.zeros((3,), dtype=torch.float32, device=device)
    return torch.as_tensor(origin, dtype=torch.float32, device=device)


def _info_of(count, cov, est):
    """Per-voxel information: 1e2 I for single-point voxels, else the
    clamped inverse; 0 where not estimated. Selected, never multiplied, so
    a non-finite inverse of a degenerate covariance never reaches the map."""
    eye = torch.eye(3, dtype=torch.float32, device=cov.device)
    info = torch.where((count <= 1.0)[:, None, None], eye * 1e2,
                       mathx.clamped_inverse_3x3(cov))
    return torch.where(est[:, None, None], info, 0.0)


# ---------------------------------------------------------------------------
# Direct map build
# ---------------------------------------------------------------------------

def build_direct(pc: PointCloud, opts: NdtOptions, origin=None) -> NdtMap:
    """Direct target: one segment reduce over the cloud."""
    origin = _origin(origin, pc.device)
    stats = voxel.voxel_stats(pc, opts.voxel_size, origin, mode=opts.bin_mode)
    keep = stats.count > opts.min_pts_in_voxel        # strict >
    info = mathx.clamped_inverse_3x3(stats.cov)
    keys = torch.where(keep, stats.keys, voxel.INVALID_KEY)
    # dropped voxels sink to the end; keys stay sorted for searchsorted
    order = torch.argsort(keys, stable=True)
    return _finalize_map(NdtMap(
        keys=keys[order], count=stats.count[order], mean=stats.mean[order],
        cov=stats.cov[order], info=info[order], estimated=keep[order],
        age=torch.zeros(stats.count.shape, dtype=torch.int32, device=pc.device),
        epoch=1, origin=origin), opts)


# ---------------------------------------------------------------------------
# Incremental map update
# ---------------------------------------------------------------------------

def empty_incremental(opts: NdtOptions, origin=None, *, device=None) -> NdtMap:
    """An empty incremental table of opts.map_capacity rows on `device`, or
    on the origin's device when it is a tensor, else on the card
    (`pointcloud.card_device`: it raises without one)."""
    if device is None:
        device = origin.device if isinstance(origin, torch.Tensor) else card_device()
    v = opts.map_capacity
    f32 = dict(dtype=torch.float32, device=device)
    return _finalize_map(NdtMap(
        keys=torch.full((v,), voxel.INVALID_KEY, dtype=torch.int32, device=device),
        count=torch.zeros((v,), **f32),
        mean=torch.zeros((v, 3), **f32),
        cov=torch.zeros((v, 3, 3), **f32),
        info=torch.zeros((v, 3, 3), **f32),
        estimated=torch.zeros((v,), dtype=torch.bool, device=device),
        age=torch.zeros((v,), dtype=torch.int32, device=device),
        epoch=0,
        origin=_origin(origin, device),
    ), opts)


def _evict_and_sort(v, keys, live, age, fields):
    """Keep the `v` most recently touched live rows (stable among equal
    ages, so the survivors at capacity follow the key order), then sort the
    survivors by key. Returns (keys, fields...)."""
    rank = torch.where(live, -age, _INT32_MAX)
    keep = torch.argsort(rank, stable=True)[:v]
    keys3 = keys[keep]
    final = torch.argsort(keys3, stable=True)
    return (keys3[final],) + tuple(x[keep][final] for x in fields)


def update_incremental(m: NdtMap, pc: PointCloud, opts: NdtOptions) -> NdtMap:
    """Absorb a new scan into the bounded voxel table: concat (map rows,
    scan-voxel stats) -> sort by key -> pairwise moment merge of equal-key
    neighbors -> evict by age down to capacity -> re-sort by key."""
    v = opts.map_capacity
    dev = m.keys.device
    epoch = m.epoch + 1
    stats = voxel.voxel_stats(pc, opts.voxel_size, m.origin, mode=opts.bin_mode)
    s_valid = stats.count > 0

    # map rows then scan rows; a scan row (tag 1) sorts right after an
    # equal-key map row
    keys = torch.cat([m.keys, torch.where(s_valid, stats.keys, voxel.INVALID_KEY)])
    cnt = torch.cat([m.count, stats.count])
    mean = torch.cat([m.mean, stats.mean])
    cov = torch.cat([m.cov, stats.cov])
    est = torch.cat([m.estimated, torch.zeros_like(s_valid)])
    age = torch.cat([m.age, s_valid.to(torch.int32) * epoch])
    tag = torch.cat([torch.zeros(m.keys.shape, dtype=torch.int64, device=dev),
                     torch.ones(stats.keys.shape, dtype=torch.int64, device=dev)])

    # jnp.lexsort((tag, keys)): one stable sort on a combined key
    order = torch.argsort(keys.to(torch.int64) * 2 + tag, stable=True)
    keys, cnt, mean, cov, est, age, tag = (x[order] for x in (keys, cnt, mean, cov, est, age, tag))

    # a scan row whose left neighbor has the same key merges into it
    false1 = torch.zeros((1,), dtype=torch.bool, device=dev)
    prev_same = torch.cat([false1, (keys[1:] == keys[:-1]) & (keys[1:] != voxel.INVALID_KEY)])
    merge_into_prev = prev_same & (tag == 1)

    # shift the scan rows' stats onto the map row to their left
    def nxt(x):
        return torch.cat([x[1:], torch.zeros_like(x[:1])])

    nm_cnt, nm_mean, nm_cov = nxt(cnt), nxt(mean), nxt(cov)
    absorb = torch.cat([merge_into_prev[1:], false1])

    # frozen voxels (estimated and over the point cap) ignore new points
    frozen = est & (cnt > opts.max_pts_in_voxel)
    do_merge = absorb & ~frozen
    new_mean, new_cov = mathx.merge_gaussian(cnt, mean, cov, torch.clamp(nm_cnt, min=1.0),
                                             nm_mean, nm_cov)
    cnt2 = torch.where(do_merge, cnt + nm_cnt, cnt)
    mean2 = torch.where(do_merge[:, None], new_mean, mean)
    cov2 = torch.where(do_merge[:, None, None], new_cov, cov)
    touched = absorb | (tag == 1)
    age2 = torch.where(touched, epoch, age).to(torch.int32)

    # kill the merged-away scan rows, evict, re-sort
    keys2 = torch.where(merge_into_prev, voxel.INVALID_KEY, keys)
    keys4, cnt4, mean4, cov4, age4, est_c = _evict_and_sort(
        v, keys2, keys2 != voxel.INVALID_KEY, age2, (cnt2, mean2, cov2, age2, est))

    # once estimated, stays estimated; the first scan estimates everything,
    # single-point voxels included
    first = m.epoch == 0
    est4 = (keys4 != voxel.INVALID_KEY) & (
        est_c | (cnt4 > opts.min_pts_in_voxel) | ((cnt4 >= 1) & first))
    return _finalize_map(
        NdtMap(keys=keys4, count=cnt4, mean=mean4, cov=cov4,
               info=_info_of(cnt4, cov4, est4), estimated=est4, age=age4,
               epoch=epoch, origin=m.origin), opts)


def _segment_max(values, seg, n):
    """jax.ops.segment_max: empty segments hold the dtype's minimum."""
    out = torch.full((n,), _INT32_MIN, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg, values, "amax", include_self=False)


def rebuild_from_moments(keys, cnt, mean, cov, est, age, epoch, origin,
                         opts: NdtOptions) -> NdtMap:
    """Re-assemble a bounded voxel table from any multiset of moment rows
    (keys may repeat; INVALID_KEY rows are dropped): sort by key, merge the
    count-weighted first and second moments of equal-key runs exactly, evict
    by age to opts.map_capacity, and recompute info / packed / dense."""
    v = opts.map_capacity
    n = keys.shape[0]
    dev = keys.device
    order = torch.argsort(keys, stable=True)
    k, c, mu, cv, e, a = (x[order] for x in (keys, cnt, mean, cov, est, age))
    c = torch.where(k != voxel.INVALID_KEY, c, 0.0)
    new_seg = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev), k[1:] != k[:-1]])
    seg = torch.cumsum(new_seg.to(torch.int64), 0) - 1

    # unbiased covariances throughout: a row's raw second moment is
    # (c - 1) cov + c mu mu^T, and the merged cov divides by (c_sum - 1).
    # The INVALID_KEY rows trail and are summed into no segment (c is 0
    # there, and their run is dropped below).
    s2_rows = (torch.clamp(c - 1.0, min=0.0)[:, None, None] * cv
               + c[:, None, None] * mu[:, :, None] * mu[:, None, :])
    sums = voxel.segment_sum(torch.cat([c[:, None], c[:, None] * mu, s2_rows.reshape(-1, 9)], dim=1),
                             voxel.segment_offsets(seg, n, k != voxel.INVALID_KEY))
    c_sum, s1, s2 = sums[:, 0], sums[:, 1:4], sums[:, 4:13].reshape(-1, 3, 3)
    mean_m = s1 / torch.clamp(c_sum, min=1.0)[:, None]
    cov_m = (s2 - c_sum[:, None, None] * mean_m[:, :, None] * mean_m[:, None, :]) \
        / torch.clamp(c_sum - 1.0, min=1.0)[:, None, None]
    key_m = _segment_max(k, seg, n)
    est_m = _segment_max(e.to(torch.int32), seg, n) > 0
    age_m = _segment_max(a, seg, n)
    live = (key_m != voxel.INVALID_KEY) & (c_sum > 0)
    key_m = torch.where(live, key_m, voxel.INVALID_KEY)

    k4, c4, mu4, cv4, e4, a4 = _evict_and_sort(v, key_m, live, age_m,
                                               (c_sum, mean_m, cov_m, est_m, age_m))
    e4 = (k4 != voxel.INVALID_KEY) & (e4 | (c4 > opts.min_pts_in_voxel))
    return _finalize_map(
        NdtMap(keys=k4, count=c4, mean=mu4, cov=cv4, info=_info_of(c4, cv4, e4),
               estimated=e4, age=a4, epoch=int(epoch), origin=_origin(origin, dev)), opts)


# ---------------------------------------------------------------------------
# Alignment
# ---------------------------------------------------------------------------

class MatchResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    converged: torch.Tensor      # () bool
    num_effective: torch.Tensor  # () int32 residuals at the last iteration
    iterations: int              # GN iterations run (known on the host)
    chi2: torch.Tensor


def _lookup(m: NdtMap, query_keys: torch.Tensor):
    """Binary search in the sorted keys: (slot, found)."""
    slot = torch.searchsorted(m.keys, query_keys, side="left")
    slot = torch.clamp(slot, max=m.keys.shape[0] - 1)
    found = (m.keys[slot] == query_keys) & (query_keys != voxel.INVALID_KEY)
    return slot, found


def _stencil_keys(m: NdtMap, opts: NdtOptions, src: PointCloud, qs):
    qc = voxel.voxel_coords(qs, 1.0 / opts.voxel_size, m.origin, mode=opts.bin_mode)
    st = _stencil(opts, qs.device)
    return voxel.coords_to_key(qc[:, None, :] + st[None, :, :], src.mask[:, None])


@functools.lru_cache(maxsize=None)
def _inv_leaf(voxel_size: float, device: torch.device) -> torch.Tensor:
    """1 / voxel_size as a float32 scalar on `device`, made once per size and
    device so the hot loop never copies it from the host."""
    return torch.full((), 1.0 / voxel_size, dtype=torch.float32, device=device)


def _index(m: NdtMap, opts: NdtOptions) -> kernels.TargetIndex:
    """What K3 from the map needs to find a point's voxel in the map."""
    return kernels.TargetIndex(m.dense_table, m.dense_lo, m.origin,
                               _inv_leaf(opts.voxel_size, m.origin.device), opts.dense_dims)


def _from_map_args(m: NdtMap, opts: NdtOptions, src: PointCloud, R, t, weighted: bool):
    """The arguments of kernels.ndt_fused_terms_from_map (and of its plain
    versions) for one linearization."""
    return (src.xyz, src.mask, R, t, opts.res_outlier_th, weighted, m.packed, _index(m, opts),
            kernels.STENCIL if opts.nearby == "nearby6" else 1, opts.bin_mode)


def _ndt_terms(m: NdtMap, opts: NdtOptions, src: PointCloud, R, t, weighted: bool):
    """All residuals of one GN iteration, batched over points x stencil.
    Returns (H, b, n_res, chi2)."""
    if opts.use_fused and m.packed is not None:
        return kernels.ndt_fused_terms_from_map(*_from_map_args(m, opts, src, R, t, weighted))

    q = src.xyz
    qs = q @ R.T + t
    slot, found = _lookup(m, _stencil_keys(m, opts, src, qs))     # (N, S)
    found = found & m.estimated[slot]
    mu = m.mean[slot]                                             # (N, S, 3)
    info = m.info[slot]                                           # (N, S, 3, 3)
    e = qs[:, None, :] - mu
    res = torch.einsum("nsi,nsij,nsj->ns", e, info, e)
    ok = found & torch.isfinite(res) & (res <= opts.res_outlier_th)

    # J = [-R hat(q), I] per point, shared across the stencil
    Rhatq = torch.einsum("ij,njk->nik", R, lie.hat(q))            # (N, 3, 3)
    J = torch.cat([-Rhatq, torch.eye(3, dtype=q.dtype, device=q.device).expand_as(Rhatq)],
                  dim=-1)                                         # (N, 3, 6)
    w = ok.to(q.dtype)
    if weighted:
        infoJ = torch.einsum("nsij,njk->nsik", info, J) * w[:, :, None, None]
        H = torch.einsum("nij,nsik->jk", J, infoJ)
        b = -torch.einsum("nsij,nsi->j", infoJ, e)
        chi2 = torch.sum(res * w)
    else:
        Jw = J[:, None, :, :] * w[:, :, None, None]               # (N, S, 3, 6)
        H = torch.einsum("nij,nsik->jk", J, Jw)
        b = -torch.einsum("nsij,nsi->j", Jw, e)
        chi2 = torch.sum(torch.sum(e * e, dim=-1) * w)
    return H, b, torch.sum(ok).to(torch.int32), chi2


def scan_match(m: NdtMap, opts: NdtOptions, src: PointCloud, R0, t0, reduce=None,
               n_points=None) -> MatchResult:
    """Gauss-Newton NDT alignment of `src` to the map from (R0, t0).

    The distributed matchers (parallel/) pass `reduce`, which maps each
    iteration's local (H, b, n_res, chi2) to the global one, and
    `n_points`, the source point count over all ranks that direct mode
    gates on (default: src.count())."""
    weighted = opts.method == "incremental"
    dev = src.device
    loop = kernels.GnLoop(torch.as_tensor(R0, dtype=torch.float32, device=dev),
                          torch.as_tensor(t0, dtype=torch.float32, device=dev),
                          opts.min_effective_pts, opts.eps)
    # weighted: gate on the per-residual count; direct: every source point
    # (the reference's quirk), while the result reports the residual count
    gate_count = None if weighted else (src.count() if n_points is None else n_points)
    it = 0
    while it < opts.max_iteration:
        lin = _ndt_terms(m, opts, src, loop.R, loop.t, weighted)
        if reduce is not None:
            lin = reduce(*lin)
        it += 1
        # damping-free solve, filters, retraction, stop test: one launch
        if not timing.host_bool(loop.step(lin, gate_count=gate_count)):    # the one host sync
            break
    R, t, converged, n_res, chi2, _ = loop.result()
    return MatchResult(R=R, t=t, converged=converged, num_effective=n_res, iterations=it,
                       chi2=chi2)


def get_fitness_score(m: NdtMap, opts: NdtOptions, src: PointCloud, R, t,
                      max_range: float = 1.0):
    """Mean squared distance of each transformed source point to its nearest
    estimated voxel centroid among the NEARBY6 stencil, over matches within
    `max_range`; +inf when nothing matches. Lower is better."""
    qs = src.xyz @ R.T + t
    qc = voxel.voxel_coords(qs, 1.0 / opts.voxel_size, m.origin, mode=opts.bin_mode)
    nb_keys = voxel.coords_to_key(qc[:, None, :] + voxel.nearby6(qs.device)[None, :, :],
                                  src.mask[:, None])
    slot, found = _lookup(m, nb_keys)
    found = found & m.estimated[slot]
    d2 = torch.sum((m.mean[slot] - qs[:, None, :]) ** 2, dim=-1)
    d2min = torch.min(torch.where(found, d2, torch.inf), dim=1).values
    eff = torch.isfinite(d2min) & (d2min <= max_range * max_range) & src.mask
    n = torch.sum(eff.to(torch.float32))
    return torch.where(n > 0, torch.sum(torch.where(eff, d2min, 0.0)) / torch.clamp(n, min=1.0),
                       torch.inf)
