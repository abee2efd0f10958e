"""Batched geometry/statistics helpers (port of loc_lib_tpu/utils/mathx.py).

Masked mean/covariance reductions, the closed-form symmetric 3x3
eigendecomposition the plane tables are built from, the 5-NN plane and line
fits of the knn matchers, and the 6x6 Gauss-Newton solve. All functions are
vectorized over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch

G_M_S2 = 9.81  # gravity magnitude used throughout the reference


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=-2, eps: float = 1e-9):
    """Mean over `dim` counting only mask==True rows. mask: (..., N)."""
    m = mask[..., None].to(x.dtype)
    n = torch.sum(m, dim=dim)
    return torch.sum(x * m, dim=dim) / torch.clamp(n, min=eps), n[..., 0]


def masked_mean_and_cov(pts: torch.Tensor, mask: torch.Tensor):
    """Masked mean and unbiased (/(n-1)) covariance of point sets.
    pts (..., N, 3), mask (..., N) -> mean (..., 3), cov (..., 3, 3), n (...)."""
    mean, n = masked_mean(pts, mask)
    d = (pts - mean[..., None, :]) * mask[..., None].to(pts.dtype)
    cov = torch.einsum("...ni,...nj->...ij", d, d) \
        / torch.clamp(n - 1.0, min=1.0)[..., None, None]
    return mean, cov, n


def masked_mean_and_cov_diag(x: torch.Tensor, mask: torch.Tensor):
    """Diagonal-covariance masked statistics (/(n-1)). x: (..., N, D)."""
    mean, n = masked_mean(x, mask)
    d = (x - mean[..., None, :]) * mask[..., None].to(x.dtype)
    var = torch.sum(d * d, dim=-2) / torch.clamp(n - 1.0, min=1.0)[..., None]
    return mean, var, n


def eigh_sym3x3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 3, 3) matrices.

    Analytic eigenvalues (Cardano, ascending) and eigenvectors by the
    matrix-product trick: for eigenvalue li the columns of (A - lj I)(A - lk I)
    span its eigenspace; the column of largest norm is taken. Branch-free
    arithmetic, identical in formula to the JAX package so the plane tables
    agree to float32 rounding.
    """
    a00 = A[..., 0, 0]; a01 = A[..., 0, 1]; a02 = A[..., 0, 2]
    a11 = A[..., 1, 1]; a12 = A[..., 1, 2]; a22 = A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e2 = q + 2.0 * p * torch.cos(phi)                         # largest
    e0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)   # smallest
    e1 = 3.0 * q - e0 - e2
    vals = torch.stack([e0, e1, e2], dim=-1)

    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    cols = torch.arange(3, device=A.device)

    def vec_for(lj, lk):
        M = (A - lj[..., None, None] * eye) @ (A - lk[..., None, None] * eye)
        n2 = torch.sum(M * M, dim=-2)                         # (..., 3)
        # one-hot contraction (not a gather) so non-finite inputs propagate
        # exactly as in the reference formula
        onehot = (torch.argmax(n2, dim=-1)[..., None] == cols).to(A.dtype)
        v = torch.sum(M * onehot[..., None, :], dim=-1)
        nrm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        fallback = torch.zeros_like(v)
        fallback[..., 0] = 1.0
        return torch.where(nrm > 1e-20, v / torch.clamp(nrm, min=1e-20), fallback)

    v0 = vec_for(e1, e2)
    v2 = vec_for(e0, e1)
    # middle vector: orthogonal completion (exact for symmetric A)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    v1 = v1 / torch.clamp(torch.sqrt(torch.sum(v1 * v1, dim=-1, keepdim=True)), min=1e-20)
    vecs = torch.stack([v0, v1, v2], dim=-1)                  # columns
    return vals, vecs


def fit_plane(pts: torch.Tensor, mask: torch.Tensor, eps: float = 1e-2):
    """Batched plane fit by centred PCA: unit normal = smallest eigenvector
    of the centred scatter, offset -n.c, the 4-vector (n, d) then rescaled to
    unit norm. pts (..., K, 3), mask (..., K) -> coeffs (..., 4), valid (...):
    at least 3 points and residual^2 <= eps for every real neighbour."""
    centroid, n = masked_mean(pts, mask)
    d = (pts - centroid[..., None, :]) * mask[..., None].to(pts.dtype)
    S = torch.einsum("...ki,...kj->...ij", d, d)
    _, vecs = eigh_sym3x3(S)
    nvec = vecs[..., :, 0]
    d0 = -torch.sum(nvec * centroid, dim=-1, keepdim=True)
    coeffs = torch.cat([nvec, d0], dim=-1)
    coeffs = coeffs / torch.clamp(
        torch.sqrt(torch.sum(coeffs * coeffs, dim=-1, keepdim=True)), min=1e-12)
    resid = torch.einsum("...ki,...i->...k", pts, coeffs[..., :3]) + coeffs[..., 3][..., None]
    ok = torch.all(torch.where(mask, resid * resid <= eps, True), dim=-1)
    valid = (n >= 3) & ok & torch.isfinite(coeffs).all(dim=-1)
    return coeffs, valid


def fit_line(pts: torch.Tensor, mask: torch.Tensor, eps: float = 0.2):
    """Batched line fit: centroid + principal eigenvector of the scatter.
    pts (..., K, 3), mask (..., K) -> origin (..., 3), unit dir (..., 3),
    valid (...): at least 2 points and |dir x (p - origin)|^2 <= eps for
    every real neighbour."""
    origin, n = masked_mean(pts, mask)
    d = (pts - origin[..., None, :]) * mask[..., None].to(pts.dtype)
    S = torch.einsum("...ki,...kj->...ij", d, d)
    _, vecs = eigh_sym3x3(S)
    direction = vecs[..., :, 2]
    cr = torch.linalg.cross(direction[..., None, :].expand(d.shape), d, dim=-1)
    cr2 = torch.sum(cr * cr, dim=-1)
    ok = torch.all(torch.where(mask, cr2 <= eps, True), dim=-1)
    valid = (n >= 2) & ok & torch.isfinite(direction).all(dim=-1)
    return origin, direction, valid


def solve_gn_6x6(H: torch.Tensor, b: torch.Tensor, damping: float = 0.0):
    """Solve H dx = b for the 6-DoF GN step (LU with partial pivoting), for
    one system or a batch (..., 6, 6), (..., 6).

    `solve_ex` neither raises nor synchronizes on a singular H; like the
    reference's `jnp.linalg.solve` it then returns non-finite entries, which
    the GN loop zeroes. A system's solution does not depend on the batch it
    is solved in: measured bit-equal on an H100 between (6, 6) and lane k of
    (B, 6, 6) for B = 1, 2, 3, 8, 64 (chip_smoke.py holds it on every run)."""
    if damping:
        H = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(H, b, check_errors=False).result


def schur_marginalize(H: torch.Tensor, b: torch.Tensor, k: int):
    """Schur-complement marginalization of the first k states: the reduced
    (H', b') over the remaining block after eliminating block [0:k], with
    1e-9 on the eliminated block's diagonal. H: (n, n), b: (n,)."""
    Haa, Hab = H[:k, :k], H[:k, k:]
    Hba, Hbb = H[k:, :k], H[k:, k:]
    Haa_inv = torch.linalg.inv(Haa + 1e-9 * torch.eye(k, dtype=H.dtype, device=H.device))
    return Hbb - Hba @ Haa_inv @ Hab, b[k:] - Hba @ Haa_inv @ b[:k]


def merge_gaussian(hist_n, hist_mean, hist_cov, cur_n, cur_mean, cur_cov):
    """Moment-matched merge of two Gaussians (the incremental NDT voxel
    update). Counts (...,), means (..., 3), covariances (..., 3, 3)."""
    total = hist_n + cur_n
    new_mean = (hist_n[..., None] * hist_mean + cur_n[..., None] * cur_mean) / total[..., None]
    dh = hist_mean - new_mean
    dc = cur_mean - new_mean
    new_cov = (
        hist_n[..., None, None] * (hist_cov + dh[..., :, None] * dh[..., None, :])
        + cur_n[..., None, None] * (cur_cov + dc[..., :, None] * dc[..., None, :])
    ) / total[..., None, None]
    return new_mean, new_cov


def clamped_inverse_3x3(cov: torch.Tensor, rel_floor: float = 1e-3):
    """NDT voxel information from a covariance: eigenvalues floored at
    rel_floor times the largest, then inverted (on the closed-form
    `eigh_sym3x3`). cov (..., 3, 3) symmetric PSD -> info (..., 3, 3)."""
    vals, vecs = eigh_sym3x3(cov)                             # ascending
    floor = vals[..., 2:3] * rel_floor
    inv = 1.0 / torch.clamp(torch.maximum(vals, floor), min=1e-12)
    return torch.einsum("...ij,...j,...kj->...ik", vecs, inv, vecs)


def regularized_inverse_3x3(cov: torch.Tensor, jitter: float = 1e-3):
    """info = (sigma + jitter*I)^-1, the incremental-NDT first-scan variant."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return torch.linalg.inv(cov + jitter * eye)


def cholesky_3x3(A: torch.Tensor):
    """Closed-form lower Cholesky of batched SPD (..., 3, 3) matrices ->
    six packed factors (..., 6) [L00, L10, L11, L20, L21, L22].

    Off-diagonal solves are clipped to their exact-arithmetic PSD bounds, so
    a rank-deficient input whose tiny diagonal cancels to 0 in float32 does
    not blow up; an exactly zero input gives an exactly zero factor (voxels
    that are not estimated carry info = 0)."""
    eps = 1e-12
    a00 = torch.clamp(A[..., 0, 0], min=0.0)
    a11 = torch.clamp(A[..., 1, 1], min=0.0)
    a22 = torch.clamp(A[..., 2, 2], min=0.0)
    l00 = torch.sqrt(a00 + eps)

    def clip(x, bound):
        return torch.minimum(torch.maximum(x, -bound), bound)

    l10 = clip(A[..., 1, 0] / l00, torch.sqrt(a11 + eps))
    l20 = clip(A[..., 2, 0] / l00, torch.sqrt(a22 + eps))
    d11 = torch.clamp(a11 - l10 * l10, min=0.0)
    l11 = torch.sqrt(d11 + eps)
    d22_bound = torch.sqrt(torch.clamp(a22 - l20 * l20, min=0.0) + eps)
    l21 = clip((A[..., 2, 1] - l20 * l10) / l11, d22_bound)
    d22 = torch.clamp(a22 - l20 * l20 - l21 * l21, min=0.0)
    l22 = torch.sqrt(d22 + eps)
    packed = torch.stack([l00, l10, l11, l20, l21, l22], dim=-1)
    zero = torch.all((A == 0.0).flatten(-2), dim=-1)
    return torch.where(zero[..., None], 0.0, packed)


def cholesky_3x3_unpack(packed: torch.Tensor) -> torch.Tensor:
    """(..., 6) packed factors -> (..., 3, 3) lower-triangular L."""
    z = torch.zeros_like(packed[..., 0])
    return torch.stack([
        torch.stack([packed[..., 0], z, z], dim=-1),
        torch.stack([packed[..., 1], packed[..., 2], z], dim=-1),
        torch.stack([packed[..., 3], packed[..., 4], packed[..., 5]], dim=-1),
    ], dim=-2)
