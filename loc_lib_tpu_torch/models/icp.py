"""Voxel ICP scan matching (port of the p2plane_vox, p2plane_vox_oct and
p2line_vox paths of loc_lib_tpu/models/icp.py).

Target side: per-voxel planes (or lines) from neighbor-merged Gaussian
moments (VGICP-style) are precomputed once at `set_target`, plus (for
p2plane_vox_oct) the correspondence pre-elected per (voxel, octant) cell.
Match side: each Gauss-Newton iteration is one fused kernel (ops/kernels.py)
that does the dense O(1) voxel lookup and the row reads itself: K2 from the
target for p2plane_vox (7-voxel gather and election inside the kernel), K1
from the target for p2plane_vox_oct (one (voxel, octant) lookup inside the
kernel). For p2line_vox the gather and the nearest-valid-centroid election
(an argmin) stay in torch ops, then K3 at S = 1 in weighted mode. The outer
loop is a Python loop with the reference's stop rule (|dx| < eps, at most
max_iteration, never during gate warm-up); it reads one flag back per
iteration.

P2Plane residual and Jacobian (right perturbation):
    e = n.(R q + t) + d      J = [-n^T R hat(q), n^T]
P2Line: the generalized-Gaussian form with information I - d d^T, whose
|W^T e|^2 is the squared distance to the voxel's line.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops.pointcloud import PointCloud
from ..ops import kernels, voxel
from ..utils import lie, mathx

_VOX_METHODS = ("p2plane_vox", "p2plane_vox_oct", "p2line_vox")


def not_ported(what: str, slice_: str):
    """Raise for a part of the reference this port does not run yet."""
    raise NotImplementedError(
        f"{what} is not ported yet; it waits for ROADMAP.md slice {slice_}")


@dataclasses.dataclass(frozen=True)
class IcpOptions:
    """Mirror of the JAX package's IcpOptions (same names and defaults) for
    the fields the ported methods read; the fields of the other methods
    (max_nn_distance, elect_*) come with them.

    This port runs method="p2plane_vox", "p2plane_vox_oct" and
    "p2line_vox"; the knn methods (p2p, p2line, p2plane) and
    freeze_election_after > 0 raise NotImplementedError naming the roadmap
    slice they wait for."""

    method: str = "p2plane"
    use_initial_translation: bool = True
    max_iteration: int = 20
    max_plane_distance: float = 0.1
    max_line_distance: float = 0.5
    min_effective_pts: int = 10
    eps: float = 1e-2
    grid_leaf: float = 1.0
    bucket_size: int = 8
    plane_fit_eps: float = 1e-2
    plane_min_pts: int = 5
    # p2line_vox: the principal eigenvalue must dominate the cross-section
    # by this ratio for a voxel to carry a line
    line_ratio: float = 3.0
    dense_dims: tuple = (256, 256, 64)
    freeze_election_after: int = 0
    gate_warmup_iters: int = 0
    gate_warmup_scale: float = 5.0


def _check_method(opts: IcpOptions):
    if opts.method not in _VOX_METHODS:
        not_ported(f"ICP method {opts.method!r}", "2")


class IcpTarget(NamedTuple):
    grid: voxel.HashGrid
    centroid: Optional[torch.Tensor] = None
    # rows [n(3), d, mu(3), valid]: one 32-byte row gather per candidate voxel
    packed: Optional[torch.Tensor] = None        # (V, 8)
    plane: Optional[torch.Tensor] = None         # (V, 4) [n, d] per grid slot
    plane_mu: Optional[torch.Tensor] = None      # (V, 3) merged centroid
    plane_valid: Optional[torch.Tensor] = None   # (V,) bool
    dense: Optional[voxel.DenseIndex] = None
    # p2line_vox: rows [mu(3), W(9 row-major), valid], W W^T = I - d d^T
    line_packed: Optional[torch.Tensor] = None   # (V, 13)
    line_dir: Optional[torch.Tensor] = None      # (V, 3) d, kept for tests
    # p2plane_vox_oct: correspondences pre-elected per (voxel, octant)
    dense_oct: Optional[voxel.DenseIndex] = None  # over the DILATED key set
    oct_table: Optional[torch.Tensor] = None     # (V7, 8) int32 -> packed_ext row
    packed_ext: Optional[torch.Tensor] = None    # (V+1, 8); last row invalid


def _merge_neighbor_moments(keys, count, mean, cov, dense, dims):
    """Merge each voxel's count-weighted moments with its 6 face neighbors
    (rows stay slot-aligned with `keys`). Returns (n, mu, cov). Moments are
    raw second moments about the window origin, as in the reference."""
    coords = voxel.key_to_coords(keys)                          # (V, 3)
    nb_keys = voxel.coords_to_key(
        coords[:, None, :] + voxel.nearby6(keys.device)[None, :, :],
        (keys != voxel.INVALID_KEY)[:, None])                   # (V, 7)
    slot, found = voxel.lookup_dense(dense, dims, nb_keys)
    slot = slot.to(torch.int64)
    n_k = torch.where(found, count[slot], 0.0)                  # (V, 7)
    mu_k = mean[slot]                                           # (V, 7, 3)
    s2_k = n_k[..., None, None] * (cov[slot] + mu_k[..., :, None] * mu_k[..., None, :])
    n = torch.sum(n_k, dim=1)
    s1 = torch.sum(n_k[..., None] * mu_k, dim=1)
    s2 = torch.sum(s2_k, dim=1)
    mu = s1 / torch.clamp(n, min=1.0)[:, None]
    cov_m = s2 / torch.clamp(n, min=1.0)[:, None, None] - mu[:, :, None] * mu[:, None, :]
    return n, mu, cov_m


def _merged_moments(opts: IcpOptions, dense: voxel.DenseIndex, stats: voxel.VoxelStats):
    """Neighbor-merged Gaussian moments per voxel, rows aligned with the
    grid's voxel keys (the stats share its key sort). Returns
    (n, mu, cov, keys)."""
    n, mu, cov = _merge_neighbor_moments(stats.keys, stats.count, stats.mean,
                                         stats.cov, dense, opts.dense_dims)
    return n, mu, cov, stats.keys


def _planes_from_moments(n, mu, cov, keys, opts: IcpOptions):
    """Planes + validity from merged moments: normal = smallest eigenvector;
    valid = enough support, thin along the normal, and genuinely planar."""
    vals, vecs = mathx.eigh_sym3x3(cov)
    nvec = vecs[..., :, 0]
    d = -torch.sum(nvec * mu, dim=-1, keepdim=True)
    plane = torch.cat([nvec, d], dim=-1)                        # (V, 4)
    valid = ((n >= opts.plane_min_pts)
             & (vals[..., 0] <= opts.plane_fit_eps)
             & (vals[..., 1] >= 3.0 * vals[..., 0])
             & (keys != voxel.INVALID_KEY)
             & torch.isfinite(plane).all(dim=-1))
    return torch.where(valid[:, None], plane, 0.0), mu, valid


def _build_plane_table(opts: IcpOptions, dense: voxel.DenseIndex, stats: voxel.VoxelStats):
    n, mu, cov, keys = _merged_moments(opts, dense, stats)
    return _planes_from_moments(n, mu, cov, keys, opts)


def _build_line_table(opts: IcpOptions, dense: voxel.DenseIndex, stats: voxel.VoxelStats):
    """Per-voxel line from the merged moments: direction d = principal
    eigenvector; valid with >= plane_min_pts support where the principal
    eigenvalue dominates the cross-section by line_ratio. W = [v0 v1 0]
    (row-major) is the exact square-root factor of the projector I - d d^T,
    so K3's |W^T e|^2 is the squared line distance. Returns
    (line_packed (V, 13), line_dir (V, 3))."""
    n, mu, cov, keys = _merged_moments(opts, dense, stats)
    vals, vecs = mathx.eigh_sym3x3(cov)
    d = vecs[..., :, 2]
    valid = ((n >= opts.plane_min_pts)
             & (vals[..., 2] >= opts.line_ratio * (vals[..., 0] + vals[..., 1]))
             & (keys != voxel.INVALID_KEY)
             & torch.isfinite(vecs).all(dim=-1).all(dim=-1))
    v0, v1 = vecs[..., :, 0], vecs[..., :, 1]
    zero = torch.zeros_like(v0[:, 0])
    W = torch.stack([v0[:, 0], v1[:, 0], zero, v0[:, 1], v1[:, 1], zero,
                     v0[:, 2], v1[:, 2], zero], dim=-1)               # (V, 9)
    W = torch.where(valid[:, None], W, 0.0)
    packed = torch.cat([mu, W, valid[:, None].to(torch.float32)], dim=1)
    return packed, torch.where(valid[:, None], d, 0.0)


def target_from_moment_table(keys, count, mean, cov, dense_table, dense_lo, origin,
                             opts: IcpOptions, dims) -> IcpTarget:
    """A p2plane_vox target derived from an incrementally maintained voxel
    moment table (an ndt.NdtMap built with bin_mode="floor" at
    voxel_size = opts.grid_leaf): the neighbor merge, closed-form eigh and
    repack of `set_target`, in O(V), with no re-sort of a local-map window.
    `dims` must equal the table's dense-index dims. The grid is a minimal
    carrier: the vox matcher reads only its inv_leaf and origin."""
    dense = voxel.DenseIndex(table=dense_table, lo=dense_lo)
    n, mu, cov_m = _merge_neighbor_moments(keys, count, mean, cov, dense, dims)
    plane, mu, valid = _planes_from_moments(n, mu, cov_m, keys, opts)
    packed = torch.cat([plane, mu, valid[:, None].to(torch.float32)], dim=1)
    v, dev = keys.shape[0], keys.device
    grid = voxel.HashGrid(
        voxel_keys=keys,
        bucket_xyz=torch.zeros((v, 3), dtype=torch.float32, device=dev),
        bucket_idx=torch.full((v, 1), -1, dtype=torch.int32, device=dev),
        bucket_cnt=torch.zeros((v,), dtype=torch.int32, device=dev),
        num_voxels=(keys != voxel.INVALID_KEY).to(torch.int32).sum(),
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        inv_leaf=torch.full((), 1.0 / opts.grid_leaf, dtype=torch.float32, device=dev),
        origin=torch.as_tensor(origin, dtype=torch.float32, device=dev),
    )
    return IcpTarget(grid=grid, packed=packed, plane=plane, plane_mu=mu,
                     plane_valid=valid, dense=dense)


def _build_oct_tables(grid: voxel.HashGrid, dense: voxel.DenseIndex,
                      packed: torch.Tensor, opts: IcpOptions):
    """Pre-elect the correspondence for every (voxel, octant) cell of the
    DILATED voxel set (occupied voxels + their face neighbors): the same
    nearest-valid-centroid election over the NEARBY6+self stencil, evaluated
    at the 8 octant centers, first stencil hit winning ties.

    Returns (dense_oct, oct_table (7V, 8) int32, packed_ext (V+1, 8))."""
    keys = grid.voxel_keys
    dev = keys.device
    v = keys.shape[0]
    st = voxel.nearby6(dev)
    coords = voxel.key_to_coords(keys)
    nb = voxel.coords_to_key(coords[:, None, :] + st[None, :, :],
                             (keys != voxel.INVALID_KEY)[:, None])   # (V, 7)
    allk = torch.sort(nb.reshape(-1)).values                        # (7V,)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       allk[1:] != allk[:-1]])
    dk = torch.sort(torch.where(first & (allk != voxel.INVALID_KEY), allk,
                                voxel.INVALID_KEY)).values          # deduped keys
    dense_oct = voxel.build_dense_index(dk, dims=opts.dense_dims)

    dc = voxel.key_to_coords(dk)                                    # (7V, 3)
    stencil = voxel.coords_to_key(dc[:, None, :] + st[None, :, :],
                                  (dk != voxel.INVALID_KEY)[:, None])  # (7V, 7)
    slot7, found7 = voxel.lookup_dense(dense, opts.dense_dims, stencil)
    slot7 = slot7.to(torch.int64)
    # octant-center offsets (8, 3): bit k of the octant index -> axis k
    octs = torch.arange(8, device=dev)
    offs = ((octs[:, None] >> torch.arange(3, device=dev)[None, :]) & 1).to(torch.float32) \
        * 0.5 + 0.25
    leaf = 1.0 / grid.inv_leaf
    # pos[c, o, j] = world coord c of octant o's center in dilated voxel j
    pos = (dc.T[:, None, :].to(torch.float32) + offs.T[:, :, None]) * leaf \
        + grid.origin[:, None, None]                                # (3, 8, 7V)
    packed_t = packed.T                                             # (8, V)
    n7 = dk.shape[0]
    best_d2 = torch.full((8, n7), float("inf"), dtype=torch.float32, device=dev)
    best_slot = torch.zeros((8, n7), dtype=torch.int64, device=dev)
    for s in range(7):
        slot_s = slot7[:, s]
        row_s = packed_t[:, slot_s]                                 # (8, 7V)
        valid_s = found7[:, s] & (row_s[7] > 0.5)
        diff = row_s[4:7, None, :] - pos                            # (3, 8, 7V)
        d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        d2 = torch.where(valid_s[None, :], d2, float("inf"))
        take = d2 < best_d2
        best_d2 = torch.where(take, d2, best_d2)
        best_slot = torch.where(take, slot_s[None, :], best_slot)
    has = torch.isfinite(best_d2)
    oct_table = torch.where(has, best_slot, v).T.to(torch.int32).contiguous()
    packed_ext = torch.cat([packed, torch.zeros((1, 8), dtype=packed.dtype, device=dev)])
    return dense_oct, oct_table, packed_ext


def _masked_centroid(pc: PointCloud) -> torch.Tensor:
    n = torch.clamp(torch.sum(pc.mask.to(torch.float32)), min=1.0)
    return torch.sum(torch.where(pc.mask[:, None], pc.xyz, 0.0), dim=0) / n


def set_target(pc: PointCloud, opts: IcpOptions, origin=None) -> IcpTarget:
    """Build the voxel-plane target over a cloud (on the cloud's device)."""
    _check_method(opts)
    cen = _masked_centroid(pc)
    # the grid and the per-voxel Gaussians share floor binning and origin:
    # one key sort feeds both
    grid, stats = voxel.build_hash_grid_with_stats(pc, opts.grid_leaf,
                                                   opts.bucket_size, origin)
    dense = voxel.build_dense_index(grid.voxel_keys, dims=opts.dense_dims)
    if opts.method == "p2line_vox":
        line_packed, line_dir = _build_line_table(opts, dense, stats)
        return IcpTarget(grid=grid, centroid=cen, dense=dense,
                         line_packed=line_packed, line_dir=line_dir)
    plane, plane_mu, plane_valid = _build_plane_table(opts, dense, stats)
    packed = torch.cat([plane, plane_mu, plane_valid[:, None].to(torch.float32)], dim=1)
    tgt = IcpTarget(grid=grid, centroid=cen, packed=packed, plane=plane,
                    plane_mu=plane_mu, plane_valid=plane_valid, dense=dense)
    if opts.method == "p2plane_vox_oct":
        dense_oct, oct_table, packed_ext = _build_oct_tables(grid, dense, packed, opts)
        tgt = tgt._replace(dense_oct=dense_oct, oct_table=oct_table,
                           packed_ext=packed_ext)
    return tgt


class MatchResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    converged: torch.Tensor      # () bool: |dx| < eps reached
    num_effective: torch.Tensor  # () int32 effective points at the last iteration
    iterations: int              # GN iterations run (known on the host)
    chi2: torch.Tensor           # () sum of squared residuals at the last iteration


# ---------------------------------------------------------------------------
# Per-method linearization (one pass over all source points)
# ---------------------------------------------------------------------------

def _transform(src: PointCloud, R, t):
    return src.xyz @ R.T + t


def _stencil_rows(table, target: IcpTarget, opts: IcpOptions, src: PointCloud, qs):
    """The rows of `table` for the point's voxel + 6 face neighbors: 7-key
    dense lookup + (N, 7, C) row gather. Returns (rows7, found7)."""
    qcoords = voxel.voxel_coords(qs, target.grid.inv_leaf, target.grid.origin)
    keys7 = voxel.coords_to_key(qcoords[:, None, :] + voxel.nearby6(qs.device)[None],
                                src.mask[:, None])
    slot7, found7 = voxel.lookup_dense(target.dense, opts.dense_dims, keys7)
    return table[slot7.to(torch.int64)], found7


def _elect(rows7, valid7, mu7, qs, mask):
    """Nearest valid centroid among the 7 candidates (argmin: the first
    stencil entry wins ties). Returns (the picked rows (N, 1, C), w (N,))."""
    d2 = torch.where(valid7, torch.sum((mu7 - qs[:, None, :]) ** 2, dim=-1), float("inf"))
    pick = torch.argmin(d2, dim=1)
    w = (torch.any(valid7, dim=1) & mask).to(qs.dtype)
    return torch.take_along_dim(rows7, pick[:, None, None], dim=1), w


def _index(target: IcpTarget, opts: IcpOptions,
           dense: voxel.DenseIndex) -> kernels.TargetIndex:
    """What a from-target kernel needs to find a point's voxel in `dense`."""
    return kernels.TargetIndex(dense.table, dense.lo, target.grid.origin,
                               target.grid.inv_leaf, opts.dense_dims)


def _gate(opts: IcpOptions, gate):
    return opts.max_plane_distance if gate is None else gate


def _p2plane_vox_rows7(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """Candidate gather at the current pose in torch ops: (N, 7, 8) packed
    plane rows, validity (and the dense-lookup hit) folded into column 7.
    What K2 does inside the kernel when it runs from the target; kept for
    the election oracle and for holding the kernel against it."""
    return kernels.stencil_rows_plain(src.xyz, src.mask, R, t, target.packed,
                                      _index(target, opts, target.dense))


def _p2plane_vox_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                       gate=None):
    """Exact-election voxel-plane linearization: nearest-valid-centroid plane
    among the point's voxel + 6 face neighbors. One call of kernel K2 from
    the target: lookup, row reads, election and the normal equations."""
    return kernels.p2plane_pick_fused_terms_from_target(
        src.xyz, src.mask, R, t, _gate(opts, gate), target.packed,
        _index(target, opts, target.dense))


def _p2plane_vox_elect(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """Election only (argmin over the 7 candidates, first wins ties).
    Returns (plane (N, 4), w (N,))."""
    rows7 = _p2plane_vox_rows7(target, opts, src, R, t)
    picked, w = _elect(rows7, rows7[..., 7] > 0.5, rows7[..., 4:7],
                       kernels.transform_plain(src.xyz, R, t), src.mask)
    return picked[:, 0, 0:4], w


def _p2plane_vox_terms_unfused_pick(target: IcpTarget, opts: IcpOptions,
                                    src: PointCloud, R, t, gate=None):
    """Oracle of `_p2plane_vox_terms`: the gather in torch ops, the same
    election as an argmin outside the kernel, then kernel K1 with the plane
    given."""
    plane, w = _p2plane_vox_elect(target, opts, src, R, t)
    return kernels.p2plane_fused_terms(src.xyz, plane, w, R, t, _gate(opts, gate))


def _p2plane_vox_oct_rows(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """Per point one dense lookup of its (voxel, octant) cell + one row
    gather of the pre-elected plane, in torch ops: what K1 does inside the
    kernel when it runs from the target. Returns (rows (N, 8), w (N,))."""
    return kernels.oct_rows_plain(src.xyz, src.mask, R, t, target.packed_ext,
                                  target.oct_table, _index(target, opts, target.dense_oct))


def _p2plane_vox_oct_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud,
                           R, t, gate=None):
    """Octant-pre-elected linearization. One call of kernel K1 from the
    target: the (voxel, octant) lookup, the row read and the normal
    equations."""
    return kernels.p2plane_fused_terms_from_target(
        src.xyz, src.mask, R, t, _gate(opts, gate), target.packed_ext, target.oct_table,
        _index(target, opts, target.dense_oct))


def _p2line_vox_rows(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """The nearest-valid-centroid line voxel among the point's voxel + 6
    face neighbors (argmin, first stencil entry wins ties). Returns
    (qs (N, 3), rows (N, 1, 13), w (N, 1)): K3's S = 1 inputs."""
    qs = _transform(src, R, t)
    rows7, found7 = _stencil_rows(target.line_packed, target, opts, src, qs)   # (N, 7, 13)
    rows, w = _elect(rows7, found7 & (rows7[..., 12] > 0.5), rows7[..., 0:3], qs, src.mask)
    return qs, rows, w[:, None]


def _p2line_vox_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                      gate=None):
    """Voxel-line P2Line linearization: the election above, then K3 at
    S = 1, weighted, on strided views of the picked rows, gated at
    gate^2 (gate = max_line_distance by default): the squared line
    distance |W^T e|^2 against the reference's |e| <= max_line_distance."""
    qs, rows, w = _p2line_vox_rows(target, opts, src, R, t)
    g = float(opts.max_line_distance if gate is None else gate)
    return kernels.ndt_fused_terms(src.xyz, qs, rows[..., 0:3], rows[..., 3:12], w, R, t,
                                   g * g, weighted=True)


_TERM_FNS = {"p2plane_vox": _p2plane_vox_terms,
             "p2plane_vox_oct": _p2plane_vox_oct_terms,
             "p2line_vox": _p2line_vox_terms}


def compute_h_and_b(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """One linearization: (H, b, num_effective, chi2) at the given pose."""
    _check_method(opts)
    return _TERM_FNS[opts.method](target, opts, src, R, t)


def scan_match(target: IcpTarget, opts: IcpOptions, src: PointCloud, R0, t0) -> MatchResult:
    """Full Gauss-Newton alignment of `src` to the target from (R0, t0)."""
    _check_method(opts)
    if opts.method == "p2plane_vox" and opts.freeze_election_after > 0:
        not_ported("freeze_election_after > 0 (frozen election)", "2")
    return _gauss_newton(_TERM_FNS[opts.method], target, opts, src, R0, t0)


def _gauss_newton(terms, target: IcpTarget, opts: IcpOptions, src: PointCloud, R0,
                  t0) -> MatchResult:
    """The GN loop of `scan_match` over the linearization
    `terms(target, opts, src, R, t, gate=...)`."""
    dev = src.device
    if not opts.use_initial_translation:
        # translation init = target - source centroid difference
        t0 = target.centroid - _masked_centroid(src)
    warmup = opts.gate_warmup_iters
    if opts.method == "p2line_vox":
        # K3 takes its threshold by value: host floats, nothing to copy
        gate = opts.max_line_distance
        wide_gate = gate * opts.gate_warmup_scale
    else:
        gate = torch.full((1,), opts.max_plane_distance, dtype=torch.float32, device=dev)
        wide_gate = torch.full((1,), opts.max_plane_distance * opts.gate_warmup_scale,
                               dtype=torch.float32, device=dev)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    R = torch.as_tensor(R0, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    n_eff = torch.zeros((), dtype=torch.int32, device=dev)
    chi2 = torch.zeros((), dtype=torch.float32, device=dev)
    it = 0
    while it < opts.max_iteration:
        warm = it < warmup
        H, b, n_eff, chi2 = terms(target, opts, src, R, t,
                                  gate=wide_gate if warm else gate)
        ok = n_eff >= opts.min_effective_pts
        if warm:
            # Marquardt-damped step relative to the largest diagonal while
            # the wide warm-up gate may leave H near-singular
            lam = 1e-2 * torch.max(torch.diagonal(H)) + 1e-6
            dx = mathx.solve_gn_6x6(H + lam * eye6, b)
        else:
            dx = mathx.solve_gn_6x6(H, b)
        dx = torch.where(ok, dx, 0.0)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        R, t = lie.se3_retract(R, t, dx)
        converged = ok & (torch.sqrt(torch.sum(dx * dx)) < opts.eps) & (not warm)
        it += 1
        if bool(converged):     # the one host sync per iteration
            break
    # pin the output on SO(3) (lie.so3_renormalize)
    return MatchResult(R=lie.so3_renormalize(R), t=t, converged=converged,
                       num_effective=n_eff, iterations=it, chi2=chi2)
