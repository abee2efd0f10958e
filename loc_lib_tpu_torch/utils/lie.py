"""Batched SO(3)/SE(3) operations (port of loc_lib_tpu/utils/lie.py).

Plain torch functions over float32 tensors, broadcastable over leading batch
dimensions and Taylor-safe at theta -> 0. Conventions match the JAX package:
rotations are 3x3 matrices acting on column vectors, poses are (R, t) pairs
with `apply(R, t, x) = R @ x + t`, and the Gauss-Newton retraction is the
right perturbation on SO(3) with an additive translation update.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3); Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map (..., 3, 3) -> (..., 3); Taylor-safe near identity and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w_sin = 0.5 * vee(R - R.transpose(-1, -2))
    sin2 = torch.sum(w_sin * w_sin, dim=-1)
    small = (sin2 < 1e-12) & (cos_t > 0)
    sin2_safe = torch.where(small, 1.0, sin2)
    sin_t = torch.sqrt(sin2_safe)
    theta_gen = torch.atan2(sin_t, cos_t)
    theta = torch.where(small, torch.sqrt(torch.clamp(sin2, min=0.0)), theta_gen)
    scale_small = 1.0 + sin2 / 6.0
    scale_gen = theta_gen / sin_t
    scale = torch.where(small, scale_small, scale_gen)
    w_gen = w_sin * scale[..., None]

    # near theta = pi the antisymmetric part vanishes; recover the axis from
    # the symmetric part, repairing relative signs from off-diagonal sums
    near_pi = theta > 3.0
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_sq = torch.clamp((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS),
                          min=0.0)
    axis_abs = torch.sqrt(axis_sq)
    sign_hint = torch.where(torch.abs(w_sin) > 1e-6, torch.sign(w_sin), 1.0)
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    ax = axis_abs[..., 0] * sign_hint[..., 0]
    ay = torch.where(torch.abs(sxy) > 1e-6, torch.sign(sxy) * torch.sign(ax),
                     sign_hint[..., 1]) * axis_abs[..., 1]
    az = torch.where(torch.abs(sxz) > 1e-6, torch.sign(sxz) * torch.sign(ax),
                     sign_hint[..., 2]) * axis_abs[..., 2]
    w_pi = torch.stack([ax, ay, az], dim=-1) * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_gen)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", A, x)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, ta + _matvec(Ra, tb)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_retract(R, t, dx):
    """The reference GN update: right-multiply SO3 by exp(dx[:3]), add dx[3:]
    to the translation."""
    return R @ so3_exp(dx[..., :3]), t + dx[..., 3:]


def so3_renormalize(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation matrix back onto SO(3) (two Newton-Schulz
    polar iterations). Every matcher projects its output rotation once per
    solve so float32 retraction defects cannot feed back through the
    constant-velocity / ESKF prediction and grow."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        RtR = R.transpose(-1, -2) @ R
        R = 0.5 * (R @ (3.0 * eye - RtR))
    return R
