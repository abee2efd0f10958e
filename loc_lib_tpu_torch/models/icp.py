"""Voxel-plane ICP scan matching (port of the p2plane_vox / p2plane_vox_oct
paths of loc_lib_tpu/models/icp.py).

Target side: per-voxel planes from neighbor-merged Gaussian moments
(VGICP-style) are precomputed once at `set_target`, plus (for
p2plane_vox_oct) the correspondence pre-elected per (voxel, octant) cell.
Match side: each Gauss-Newton iteration is one dense O(1) voxel lookup +
row gather + one fused kernel (ops/kernels.py): K2 for p2plane_vox (the
election is fused into the kernel), K1 for p2plane_vox_oct. The outer loop
is a Python loop with the reference's stop rule (|dx| < eps, at most
max_iteration, never during gate warm-up); it reads one flag back per
iteration.

P2Plane residual and Jacobian (right perturbation):
    e = n.(R q + t) + d      J = [-n^T R hat(q), n^T]
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..ops.pointcloud import PointCloud
from ..ops import kernels, voxel
from ..utils import lie, mathx

_VOX_METHODS = ("p2plane_vox", "p2plane_vox_oct")


def not_ported(what: str, slice_: str):
    """Raise for a part of the reference this port does not run yet."""
    raise NotImplementedError(
        f"{what} is not ported yet; it waits for ROADMAP.md slice {slice_}")


@dataclasses.dataclass(frozen=True)
class IcpOptions:
    """Mirror of the JAX package's IcpOptions (same names and defaults) for
    the fields the ported methods read; the fields of the other methods
    (max_nn_distance, max_line_distance, line_ratio, elect_*) come with
    them.

    This port runs method="p2plane_vox" and "p2plane_vox_oct"; the other
    methods, and freeze_election_after > 0, raise NotImplementedError
    naming the roadmap slice they wait for."""

    method: str = "p2plane"
    use_initial_translation: bool = True
    max_iteration: int = 20
    max_plane_distance: float = 0.1
    min_effective_pts: int = 10
    eps: float = 1e-2
    grid_leaf: float = 1.0
    bucket_size: int = 8
    plane_fit_eps: float = 1e-2
    plane_min_pts: int = 5
    dense_dims: tuple = (256, 256, 64)
    freeze_election_after: int = 0
    gate_warmup_iters: int = 0
    gate_warmup_scale: float = 5.0


def _check_method(opts: IcpOptions):
    if opts.method in _VOX_METHODS:
        return
    if opts.method == "p2line_vox":
        not_ported("ICP method 'p2line_vox' (kernel K3)", "4")
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


def _p2plane_vox_rows7(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """Candidate gather at the current pose: 7-key dense lookup + (N, 7, 8)
    packed-row gather, validity folded into column 7."""
    qs = _transform(src, R, t)
    qcoords = voxel.voxel_coords(qs, target.grid.inv_leaf, target.grid.origin)
    keys7 = voxel.coords_to_key(qcoords[:, None, :] + voxel.nearby6(qs.device)[None],
                                src.mask[:, None])
    slot7, found7 = voxel.lookup_dense(target.dense, opts.dense_dims, keys7)
    rows7 = target.packed[slot7.to(torch.int64)]                # (N, 7, 8)
    rows7[..., 7] = (found7 & (rows7[..., 7] > 0.5)).to(rows7.dtype)
    return rows7


def _p2plane_vox_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                       gate=None):
    """Exact-election voxel-plane linearization: nearest-valid-centroid plane
    among the point's voxel + 6 face neighbors, elected inside kernel K2."""
    rows7 = _p2plane_vox_rows7(target, opts, src, R, t)
    g = opts.max_plane_distance if gate is None else gate
    return kernels.p2plane_pick_fused_terms(
        src.xyz, rows7, src.mask.to(src.xyz.dtype), R, t, g)


def _p2plane_vox_elect(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """Election only (argmin over the 7 candidates, first wins ties).
    Returns (plane (N, 4), w (N,))."""
    rows7 = _p2plane_vox_rows7(target, opts, src, R, t)
    qs = _transform(src, R, t)
    valid7 = rows7[..., 7] > 0.5
    d2 = torch.sum((rows7[..., 4:7] - qs[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(valid7, d2, float("inf"))
    pick = torch.argmin(d2, dim=1)
    plane = torch.take_along_dim(rows7[..., 0:4], pick[:, None, None], dim=1)[:, 0]
    w = (torch.any(valid7, dim=1) & src.mask).to(src.xyz.dtype)
    return plane, w


def _p2plane_vox_terms_unfused_pick(target: IcpTarget, opts: IcpOptions,
                                    src: PointCloud, R, t, gate=None):
    """Oracle of `_p2plane_vox_terms`: the same election as an argmin outside
    the kernel, feeding the plane-only kernel K1."""
    plane, w = _p2plane_vox_elect(target, opts, src, R, t)
    g = opts.max_plane_distance if gate is None else gate
    return kernels.p2plane_fused_terms(src.xyz, plane, w, R, t, g)


def _p2plane_vox_oct_rows(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """Per point one dense lookup of its (voxel, octant) cell + one row
    gather of the pre-elected plane. Returns (rows (N, 8), w (N,))."""
    qs = _transform(src, R, t)
    u = (qs - target.grid.origin) * target.grid.inv_leaf
    fl = torch.floor(u)
    vc = fl.to(torch.int32)
    frac = u - fl
    octant = ((frac[:, 0] > 0.5).to(torch.int64)
              + 2 * (frac[:, 1] > 0.5).to(torch.int64)
              + 4 * (frac[:, 2] > 0.5).to(torch.int64))
    key = voxel.coords_to_key(vc, src.mask)
    slot, found = voxel.lookup_dense(target.dense_oct, opts.dense_dims, key)
    row_slot = torch.gather(target.oct_table[slot.to(torch.int64)], 1,
                            octant[:, None])[:, 0]
    rows = target.packed_ext[row_slot.to(torch.int64)]        # (N, 8)
    w = (found & (rows[:, 7] > 0.5) & src.mask).to(src.xyz.dtype)
    return rows, w


def _p2plane_vox_oct_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud,
                           R, t, gate=None):
    """Octant-pre-elected linearization: the (voxel, octant) row gather, then
    kernel K1 on the plane columns (a strided view, no copy)."""
    rows, w = _p2plane_vox_oct_rows(target, opts, src, R, t)
    g = opts.max_plane_distance if gate is None else gate
    return kernels.p2plane_fused_terms(src.xyz, rows[:, 0:4], w, R, t, g)


_TERM_FNS = {"p2plane_vox": _p2plane_vox_terms,
             "p2plane_vox_oct": _p2plane_vox_oct_terms}


def compute_h_and_b(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """One linearization: (H, b, num_effective, chi2) at the given pose."""
    _check_method(opts)
    return _TERM_FNS[opts.method](target, opts, src, R, t)


def scan_match(target: IcpTarget, opts: IcpOptions, src: PointCloud, R0, t0) -> MatchResult:
    """Full Gauss-Newton alignment of `src` to the target from (R0, t0)."""
    _check_method(opts)
    if opts.method == "p2plane_vox" and opts.freeze_election_after > 0:
        not_ported("freeze_election_after > 0 (frozen election)", "2")
    terms = _TERM_FNS[opts.method]
    dev = src.device
    if not opts.use_initial_translation:
        # translation init = target - source centroid difference
        t0 = target.centroid - _masked_centroid(src)
    warmup = opts.gate_warmup_iters
    base_gate = opts.max_plane_distance
    gate = torch.full((1,), base_gate, dtype=torch.float32, device=dev)
    wide_gate = torch.full((1,), base_gate * opts.gate_warmup_scale,
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
