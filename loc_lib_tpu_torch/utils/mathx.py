"""Batched geometry/statistics helpers (port of loc_lib_tpu/utils/mathx.py).

Masked mean/variance reductions, the closed-form symmetric 3x3
eigendecomposition the plane tables are built from, and the 6x6 Gauss-Newton
solve. All functions are vectorized over leading batch dimensions.
"""

from __future__ import annotations

import math

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=-2, eps: float = 1e-9):
    """Mean over `dim` counting only mask==True rows. mask: (..., N)."""
    m = mask[..., None].to(x.dtype)
    n = torch.sum(m, dim=dim)
    return torch.sum(x * m, dim=dim) / torch.clamp(n, min=eps), n[..., 0]


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


def solve_gn_6x6(H: torch.Tensor, b: torch.Tensor, damping: float = 0.0):
    """Solve H dx = b for the 6-DoF GN step (LU with partial pivoting).

    `solve_ex` neither raises nor synchronizes on a singular H; like the
    reference's `jnp.linalg.solve` it then returns non-finite entries, which
    the GN loop zeroes."""
    if damping:
        H = H + damping * torch.eye(6, dtype=H.dtype, device=H.device)
    return torch.linalg.solve_ex(H, b, check_errors=False).result
