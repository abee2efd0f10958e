"""ICP scan matching (port of loc_lib_tpu/models/icp.py): the voxel methods
p2plane_vox, p2plane_vox_oct and p2line_vox, the knn oracle methods p2p,
p2line and p2plane, the frozen election, and batched matching.

Voxel methods, target side: per-voxel planes (or lines) from neighbor-merged
Gaussian moments (VGICP-style) are precomputed once at `set_target`, plus (for
p2plane_vox_oct) the correspondence pre-elected per (voxel, octant) cell.
Match side: each Gauss-Newton iteration is one fused kernel (ops/kernels.py)
that does the dense O(1) voxel lookup and the row reads itself: K2 from the
target for p2plane_vox (7-voxel gather and election inside the kernel), K1
from the target for p2plane_vox_oct (one (voxel, octant) lookup inside the
kernel), K3 in p2line mode for p2line_vox (7-voxel gather on the line table,
nearest-valid-centroid election and the weighted rows of the elected voxel
inside the kernel). The outer
loop is a Python loop with the reference's stop rule (|dx| < eps, at most
max_iteration, never during gate warm-up); it reads one flag back per
iteration.

The knn methods search the target's hash grid per probe (voxel.knn: 3x3x3
bucket gather + top-k), fit a plane or a line to the 5 neighbours and
assemble H and b with a matrix product: plain torch ops, no kernel, as in
the reference, where they are the oracle the voxel methods are held to.

Batched matching (`set_target_batch`, `scan_match_batch`,
`scan_match_batch_chunked`): B independent (target, source, init) matches
with a leading B axis on every tensor run one GN loop; each iteration is ONE
launch of the batched K2 or K1 for all lanes, one batched 6x6 solve and
retraction, and one host read. A lane that has stopped keeps its state.
Lane b of the result has the bits of the scalar `scan_match` on lane b.

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
from ..utils import lie, mathx, timing

_VOX_METHODS = ("p2plane_vox", "p2plane_vox_oct", "p2line_vox")
_KNN_METHODS = ("p2p", "p2line", "p2plane")


@dataclasses.dataclass(frozen=True)
class IcpOptions:
    """Mirror of the JAX package's IcpOptions: same names and defaults.

    method: "p2plane_vox", "p2plane_vox_oct", "p2line_vox" (the fused voxel
    methods) or "p2p", "p2line", "p2plane" (per-probe knn search, the
    oracles). freeze_election_after > 0 (p2plane_vox only) re-elects
    correspondences for the first k iterations and whenever the pose has
    moved more than elect_dx_threshold (metres; rotation as angle *
    elect_rot_scale) since the last election, and otherwise reuses them: an
    opt-in for one-shot registrations, as in the reference."""

    method: str = "p2plane"
    use_initial_translation: bool = True
    max_iteration: int = 20
    max_nn_distance: float = 1.0     # SQUARED-distance gate of p2p
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
    elect_dx_threshold: float = 0.15
    elect_rot_scale: float = 30.0    # m of drift per rad at scene scale
    gate_warmup_iters: int = 0
    gate_warmup_scale: float = 5.0


def _check_method(opts: IcpOptions):
    if opts.method not in _VOX_METHODS + _KNN_METHODS:
        raise ValueError(f"unknown ICP method {opts.method!r}")


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
    """Build the target over a cloud (on the cloud's device): the hash grid
    for the knn methods, the voxel plane or line tables for the others."""
    _check_method(opts)
    cen = _masked_centroid(pc)
    if opts.method in _KNN_METHODS:
        return IcpTarget(grid=voxel.build_hash_grid(pc, opts.grid_leaf, opts.bucket_size,
                                                    origin), centroid=cen)
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
    """One match, or B of them (`scan_match_batch`): every tensor then has a
    leading B axis and `iterations` is a (B,) int32 tensor."""

    R: torch.Tensor
    t: torch.Tensor
    converged: torch.Tensor      # () bool: |dx| < eps reached
    num_effective: torch.Tensor  # () int32 effective points at the last iteration
    iterations: int              # GN iterations run (known on the host)
    chi2: torch.Tensor           # () sum of squared residuals at the last iteration


# ---------------------------------------------------------------------------
# Per-method linearization (one pass over all source points)
# ---------------------------------------------------------------------------

def _assemble(J: torch.Tensor, e: torch.Tensor, w: torch.Tensor):
    """Masked H = sum J^T J, b = -sum J^T e as float32 matrix products.
    J (N, r, 6), e (N, r), w (N,) validity weights."""
    n, r, _ = J.shape
    Jw = (J * w[:, None, None]).reshape(n * r, 6)
    ew = (e * w[:, None]).reshape(n * r)
    return Jw.T @ Jw, -(Jw.T @ ew)


def _R_hat_q(R, q):
    """R hat(q) per point: (N, 3, 3)."""
    return torch.einsum("ij,njk->nik", R, lie.hat(q))


def _count(eff: torch.Tensor) -> torch.Tensor:
    return eff.to(torch.int32).sum()


def _p2p_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t, gate=None):
    """Point-to-point: nearest target point within the 3x3x3 stencil, gated
    on the SQUARED distance (max_nn_distance)."""
    q = src.xyz
    qs = kernels.transform_plain(q, R, t)
    p, _, d2, valid = voxel.nn1(target.grid, qs, src.mask)
    eff = valid & (d2 <= opts.max_nn_distance)
    e = p - qs
    Rhatq = _R_hat_q(R, q)
    J = torch.cat([Rhatq, (-torch.eye(3, dtype=q.dtype, device=q.device)).expand(Rhatq.shape)],
                  dim=-1)                                           # (N, 3, 6)
    w = eff.to(q.dtype)
    H, b = _assemble(J, e, w)
    return H, b, _count(eff), torch.sum(torch.sum(e * e, dim=-1) * w)


def _p2line_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t, gate=None):
    """Point-to-line: a line fitted to the 5 nearest target points (all 5
    required); effective = found 5 and the fit holds; the norm gate only
    skips accumulation."""
    q = src.xyz
    qs = kernels.transform_plain(q, R, t)
    nn_pts, _, _, valid = voxel.knn(target.grid, qs, src.mask, 5)
    got5 = valid.to(torch.int32).sum(dim=1) == 5
    p0, d, fit_ok = mathx.fit_line(nn_pts, valid, eps=opts.max_line_distance)
    hat_d = lie.hat(d)                                              # (N, 3, 3)
    e = torch.einsum("nij,nj->ni", hat_d, qs - p0)
    eff = got5 & fit_ok
    accum = eff & (torch.sqrt(torch.sum(e * e, dim=-1)) <= opts.max_line_distance)
    Jrot = -torch.einsum("nij,njk->nik", hat_d, _R_hat_q(R, q))
    J = torch.cat([Jrot, hat_d], dim=-1)                            # (N, 3, 6)
    w = accum.to(q.dtype)
    H, b = _assemble(J, e, w)
    return H, b, _count(eff), torch.sum(torch.sum(e * e, dim=-1) * w)


def _p2plane_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t, gate=None):
    """Point-to-plane: a plane fitted to the 5 nearest target points (more
    than 3 required); the plane-distance gate only skips accumulation."""
    q = src.xyz
    qs = kernels.transform_plain(q, R, t)
    nn_pts, _, _, valid = voxel.knn(target.grid, qs, src.mask, 5)
    got = valid.to(torch.int32).sum(dim=1) > 3
    coeffs, fit_ok = mathx.fit_plane(nn_pts, valid)                 # (N, 4)
    nvec = coeffs[:, :3]
    dis = torch.sum(nvec * qs, dim=-1) + coeffs[:, 3]
    eff = got & fit_ok
    accum = eff & (torch.abs(dis) <= opts.max_plane_distance)
    Jrot = -torch.einsum("ni,nik->nk", nvec, _R_hat_q(R, q))
    J = torch.cat([Jrot, nvec], dim=-1)[:, None, :]                 # (N, 1, 6)
    w = accum.to(q.dtype)
    H, b = _assemble(J, dis[:, None], w)
    return H, b, _count(eff), torch.sum(dis * dis * w)


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
    face neighbors (first stencil entry wins ties), in torch ops: what K3
    does inside the kernel in p2line mode; kept for holding the kernel
    against it. Returns (qs (N, 3), mu (N, 1, 3), W (N, 1, 9), w (N, 1)):
    K3's S = 1 inputs with the rows given."""
    return kernels.p2line_elect_plain(src.xyz, src.mask, R, t, target.line_packed,
                                      _index(target, opts, target.dense))


def _p2line_vox_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                      gate=None):
    """Voxel-line P2Line linearization. One call of kernel K3 in p2line
    mode: lookup, election, the elected voxel's weighted rows gated at
    gate^2 (gate = max_line_distance by default: the squared line distance
    |W^T e|^2 against the reference's |e| <= max_line_distance) and the
    normal equations."""
    return kernels.p2line_fused_terms_from_target(
        src.xyz, src.mask, R, t, opts.max_line_distance if gate is None else gate,
        target.line_packed, _index(target, opts, target.dense))


_TERM_FNS = {"p2p": _p2p_terms, "p2line": _p2line_terms, "p2plane": _p2plane_terms,
             "p2plane_vox": _p2plane_vox_terms,
             "p2plane_vox_oct": _p2plane_vox_oct_terms,
             "p2line_vox": _p2line_vox_terms}


def compute_h_and_b(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """One linearization: (H, b, num_effective, chi2) at the given pose."""
    _check_method(opts)
    return _TERM_FNS[opts.method](target, opts, src, R, t)


def get_fitness_score(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                      max_range: float = 1.0) -> torch.Tensor:
    """The PCL-convention fitness: mean squared nearest-neighbour distance of
    the transformed source against the target cloud, over correspondences
    within `max_range`. Lower is better; +inf when nothing matches. Works for
    every method: the hash grid is always built at `set_target`."""
    qs = kernels.transform_plain(src.xyz, R, t)
    _, _, d2, valid = voxel.nn1(target.grid, qs, src.mask)
    eff = valid & (d2 <= max_range * max_range)
    n = torch.sum(eff.to(torch.float32))
    return torch.where(n > 0, torch.sum(torch.where(eff, d2, 0.0)) / torch.clamp(n, min=1.0),
                       float("inf"))


def scan_match(target: IcpTarget, opts: IcpOptions, src: PointCloud, R0, t0) -> MatchResult:
    """Full Gauss-Newton alignment of `src` to the target from (R0, t0)."""
    _check_method(opts)
    if not opts.use_initial_translation:
        # translation init = target - source centroid difference
        t0 = target.centroid - _masked_centroid(src)
    if opts.method == "p2plane_vox" and opts.freeze_election_after > 0:
        return _scan_match_vox_frozen(target, opts, src, R0, t0)
    return _gauss_newton(_TERM_FNS[opts.method], target, opts, src, R0, t0)


def _gates(opts: IcpOptions, dev):
    """(gate, wide warm-up gate, warm-up iterations) of a GN loop. The knn
    methods read their gates from the options and have no warm-up."""
    if opts.method in _KNN_METHODS:
        return None, None, 0
    if opts.method == "p2line_vox":
        # K3 takes its threshold by value: host floats, nothing to copy
        gate = opts.max_line_distance
        return gate, gate * opts.gate_warmup_scale, opts.gate_warmup_iters
    gate = torch.full((1,), opts.max_plane_distance, dtype=torch.float32, device=dev)
    wide_gate = torch.full((1,), opts.max_plane_distance * opts.gate_warmup_scale,
                           dtype=torch.float32, device=dev)
    return gate, wide_gate, opts.gate_warmup_iters


def _gauss_newton(terms, target: IcpTarget, opts: IcpOptions, src: PointCloud, R0,
                  t0, reduce=None) -> MatchResult:
    """The GN loop of `scan_match` over the linearization
    `terms(target, opts, src, R, t, gate=...)`. `reduce`, when given, maps
    each iteration's local (H, b, count, chi2) to the global one (the
    distributed matchers' all-reduce, parallel/match.py); every rank then
    takes the same step. An iteration is the linearization, ONE launch of
    `kernels.gn_step` (damping, solve, filters, retraction, stop test and the
    output's projection onto SO(3)) and the host's one read of its flag."""
    dev = src.device
    gate, wide_gate, warmup = _gates(opts, dev)
    loop = kernels.GnLoop(torch.as_tensor(R0, dtype=torch.float32, device=dev),
                          torch.as_tensor(t0, dtype=torch.float32, device=dev),
                          opts.min_effective_pts, opts.eps)
    it = 0
    while it < opts.max_iteration:
        warm = it < warmup
        lin = terms(target, opts, src, loop.R, loop.t, gate=wide_gate if warm else gate)
        if reduce is not None:
            lin = reduce(*lin)
        it += 1
        if not timing.host_bool(loop.step(lin, warm)):     # the one host sync per iteration
            break
    R, t, converged, n_eff, chi2, _ = loop.result()
    return MatchResult(R=R, t=t, converged=converged, num_effective=n_eff, iterations=it,
                       chi2=chi2)


def _scan_match_vox_frozen(target: IcpTarget, opts: IcpOptions, src: PointCloud, R0,
                           t0) -> MatchResult:
    """p2plane_vox GN with election freezing (freeze_election_after > 0):
    the first k iterations elect correspondences at the current pose
    (`_p2plane_vox_elect`); later ones reuse the (plane, weight) assignment
    unless the pose has moved more than elect_dx_threshold since the last
    election (|t - t_e| + elect_rot_scale |log(R_e^T R)|). Every iteration
    linearizes with kernel K1, plane given, whose plane-distance gate stays
    live. No gate warm-up on this path, as in the reference.

    Past the first k iterations the `elect` decision is one more host read
    per iteration (the alternative, computing both branches and selecting,
    would run the election every time, which is what freezing avoids)."""
    dev = src.device
    n = src.capacity
    loop = kernels.GnLoop(torch.as_tensor(R0, dtype=torch.float32, device=dev),
                          torch.as_tensor(t0, dtype=torch.float32, device=dev),
                          opts.min_effective_pts, opts.eps)
    plane = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    w = torch.zeros((n,), dtype=torch.float32, device=dev)
    R_e = torch.eye(3, dtype=torch.float32, device=dev)
    t_e = torch.full((3,), 1e9, dtype=torch.float32, device=dev)   # far: iteration 0 elects
    it = 0
    while it < opts.max_iteration:
        elect = it < opts.freeze_election_after
        if not elect:
            dt = loop.t - t_e
            rot = lie.so3_log(R_e.T @ loop.R)
            moved = torch.sqrt(torch.sum(dt * dt)) \
                + opts.elect_rot_scale * torch.sqrt(torch.sum(rot * rot))
            elect = timing.host_bool(moved > opts.elect_dx_threshold)
        if elect:
            plane, w = _p2plane_vox_elect(target, opts, src, loop.R, loop.t)
            # the loop updates its pose in place: keep the election's own copy
            R_e, t_e = loop.R.clone(), loop.t.clone()
        lin = kernels.p2plane_fused_terms(src.xyz, plane, w, loop.R, loop.t,
                                          opts.max_plane_distance)
        it += 1
        if not timing.host_bool(loop.step(lin)):
            break
    R, t, converged, n_eff, chi2, _ = loop.result()
    return MatchResult(R=R, t=t, converged=converged, num_effective=n_eff, iterations=it,
                       chi2=chi2)


# ---------------------------------------------------------------------------
# Batched matching: B independent matches in one GN loop
# ---------------------------------------------------------------------------

def tree_map(fn, *trees):
    """`fn` over the tensor leaves of (nested) NamedTuples of one structure;
    a None leaf stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    return type(first)(*(tree_map(fn, *leaves) for leaves in zip(*trees)))


def stack_lanes(trees):
    """B same-shape NamedTuples (targets, clouds) -> one with a leading B
    axis on every leaf."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def take_lane(tree, b: int):
    """Lane b of a stacked NamedTuple."""
    return tree_map(lambda x: x[b], tree)


def set_target_batch(pcs: PointCloud, opts: IcpOptions, origins=None) -> IcpTarget:
    """B independent targets with a leading B axis on every leaf: `pcs` has
    xyz (B, N, 3) and mask (B, N), `origins` None or (B, 3). Lane b equals
    `set_target(lane b of pcs, opts, origins[b])`: the lanes are built one
    after the other by `set_target` (its moments summed through
    voxel.segment_sum, so the tables repeat bit for bit) and stacked."""
    B = pcs.xyz.shape[0]
    return stack_lanes([set_target(take_lane(pcs, b), opts,
                                   None if origins is None else origins[b])
                        for b in range(B)])


def _index_batch(targets: IcpTarget, opts: IcpOptions,
                 dense: voxel.DenseIndex) -> kernels.TargetIndex:
    """`_index` of a stacked target: every tensor with the B axis."""
    return kernels.TargetIndex(dense.table, dense.lo, targets.grid.origin,
                               targets.grid.inv_leaf, opts.dense_dims)


def _p2plane_vox_terms_batch(targets, opts, srcs, R, t, gate, active):
    """B p2plane_vox linearizations: one launch of the batched K2."""
    return kernels.p2plane_pick_fused_terms_from_target_batch(
        srcs.xyz, srcs.mask, R, t, _gate(opts, gate), targets.packed,
        _index_batch(targets, opts, targets.dense), active)


def _p2plane_vox_oct_terms_batch(targets, opts, srcs, R, t, gate, active):
    """B p2plane_vox_oct linearizations: one launch of the batched K1."""
    return kernels.p2plane_fused_terms_from_target_batch(
        srcs.xyz, srcs.mask, R, t, _gate(opts, gate), targets.packed_ext, targets.oct_table,
        _index_batch(targets, opts, targets.dense_oct), active)


def _lane_by_lane(terms):
    """A batched linearization out of a scalar one: the active lanes one
    after the other, zeros for a lane that has stopped, as the batched
    kernels give (one host read of `active` per iteration). For the methods
    with no batched kernel: p2line_vox (a launch of the scalar K3 per active
    lane; the reference has no batched caller of it) and the knn methods."""
    def batched(targets, opts, srcs, R, t, gate, active):
        outs = [terms(take_lane(targets, b), opts, take_lane(srcs, b), R[b], t[b], gate=gate)
                if on else None for b, on in enumerate(timing.host_numpy(active).tolist())]
        zeros = tuple(torch.zeros_like(x) for x in next(o for o in outs if o is not None))
        return tuple(torch.stack(x) for x in zip(*(o or zeros for o in outs)))
    return batched


_BATCH_TERM_FNS = {"p2plane_vox": _p2plane_vox_terms_batch,
                   "p2plane_vox_oct": _p2plane_vox_oct_terms_batch}


def scan_match_batch(targets: IcpTarget, opts: IcpOptions, srcs: PointCloud, R0,
                     t0) -> MatchResult:
    """B independent scan matches in one GN loop.

    targets: an IcpTarget with a leading B axis on every leaf (from
    `set_target_batch`, or `stack_lanes` of same-shape targets); srcs: xyz
    (B, N, 3), mask (B, N); R0 (B, 3, 3); t0 (B, 3). Returns a MatchResult
    whose every leaf has the B axis (`iterations` a (B,) int32 tensor), lane b
    bit-identical to `scan_match` on lane b.

    For p2plane_vox and p2plane_vox_oct an iteration is one launch of the
    batched K2 / K1 for all lanes, then ONE launch of `kernels.gn_step` for
    all lanes (damping, the 6x6 solves, filters, retraction, stop test, the
    projection of R and the freeze of the lanes that have stopped), and one
    host read (is any lane still active). A lane is active while it has iterations
    left and has not converged; an inactive lane's state stops changing.
    All active lanes share the iteration number, so one gate serves a call.
    The other methods run the same loop with their scalar linearization
    lane by lane. A frozen election (freeze_election_after > 0) is, on
    purpose, B scalar `scan_match` calls stacked: whether an iteration elects
    is a host decision per lane, which no shared loop can take, and the
    election buys nothing on this card (it is inside K2)."""
    _check_method(opts)
    B = R0.shape[0]
    dev = srcs.xyz.device
    if not opts.use_initial_translation:
        t0 = torch.stack([targets.centroid[b] - _masked_centroid(take_lane(srcs, b))
                          for b in range(B)])
    if opts.method == "p2plane_vox" and opts.freeze_election_after > 0:
        fixed = dataclasses.replace(opts, use_initial_translation=True)
        lanes = [scan_match(take_lane(targets, b), fixed, take_lane(srcs, b), R0[b], t0[b])
                 for b in range(B)]
        return stack_lanes([r._replace(iterations=torch.tensor(
            r.iterations, dtype=torch.int32, device=dev)) for r in lanes])
    terms = _BATCH_TERM_FNS.get(opts.method) or _lane_by_lane(_TERM_FNS[opts.method])
    gate, wide_gate, warmup = _gates(opts, dev)
    loop = kernels.GnLoop(torch.as_tensor(R0, dtype=torch.float32, device=dev),
                          torch.as_tensor(t0, dtype=torch.float32, device=dev),
                          opts.min_effective_pts, opts.eps)
    every = torch.ones((B,), dtype=torch.bool, device=dev)     # before the first step
    it = 0
    while it < opts.max_iteration:
        warm = it < warmup
        lin = terms(targets, opts, srcs, loop.R, loop.t, wide_gate if warm else gate,
                    every if loop.active is None else loop.active)
        it += 1
        if not timing.host_bool(loop.step(lin, warm)):     # the one host read per iteration
            break
    R, t, converged, n_eff, chi2, iterations = loop.result()
    return MatchResult(R=R, t=t, converged=converged, num_effective=n_eff,
                       iterations=iterations, chi2=chi2)


def scan_match_batch_chunked(targets: IcpTarget, opts: IcpOptions, srcs: PointCloud, R0, t0,
                             chunk: int = 8) -> MatchResult:
    """`scan_match_batch` over sub-batches of `chunk` lanes, one after the
    other, re-stacked: the last sub-batch is padded with lanes from the
    front (wrap-around) and the padding dropped. B <= chunk falls through to
    the direct call. It bounds what one call holds at a time (a lane's dense
    tables are 16 MB at the default dense_dims, twice that with the octant
    tables), for sweeps over many large targets off the hot path."""
    B = R0.shape[0]
    if B <= chunk:
        return scan_match_batch(targets, opts, srcs, R0, t0)
    outs = []
    for s0 in range(0, B, chunk):
        idx = torch.tensor([(s0 + i) % B for i in range(chunk)], device=R0.device)
        take = lambda tree: tree_map(lambda x: x[idx], tree)
        outs.append(scan_match_batch(take(targets), opts, take(srcs), R0[idx], t0[idx]))
    return tree_map(lambda *xs: torch.cat(xs)[:B], *outs)
