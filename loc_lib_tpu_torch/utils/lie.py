"""Batched SO(3)/SE(3) operations (port of loc_lib_tpu/utils/lie.py).

Plain torch functions over float32 tensors, broadcastable over leading batch
dimensions and Taylor-safe at theta -> 0. Conventions match the JAX package:
rotations are 3x3 matrices acting on column vectors, poses are (R, t) pairs
with `apply(R, t, x) = R @ x + t`, and the Gauss-Newton retraction is the
right perturbation on SO(3) with an additive translation update. Twists are
[w, v], rotation first. The SE(3) exp / log, adjoint and closed-form inverse
Jacobians serve the pose graph (graph/pose_graph.py); the quaternion and
roll-pitch-yaw helpers serve the trajectory writers and the config
(io/trajectory.py, io/config.py); the SE(2) functions at the end serve the
2D stack.
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


def matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (..., 3, 3) matrices, written op by op over the leading
    axes: entry (i, j) is (a_i0 b_0j + a_i1 b_1j) + a_i2 b_2j, each product
    and sum rounded on its own (one multiply for all 27 products, two adds).
    On CUDA `@` takes one library route for a (3, 3) pair and another for a
    (B, 3, 3) batch, and the two differ in the last bit (measured on an H100:
    R @ so3_exp(w) and so3_renormalize differ between the two, and the
    batched route's bits depend on B); here a matrix's bits do not depend on
    how many others are multiplied with it, which is what lets a batched
    match equal B scalar ones bit for bit. It is three launches where `@` is
    one, so it is the product of the plain versions of the pose-update
    kernels (ops/kernels.py: `gn_step_plain`, `so3_renormalize_plain`) and
    of nothing that runs on the card: `so3_exp`, `se3_retract` and
    `so3_renormalize` take it as `matmul=` and default to `@`."""
    P = A[..., :, :, None] * B[..., None, :, :]        # P[..., i, k, j] = a_ik b_kj
    return (P[..., :, 0, :] + P[..., :, 1, :]) + P[..., :, 2, :]


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w: torch.Tensor, matmul=torch.matmul) -> torch.Tensor:
    """Rodrigues formula, (..., 3) -> (..., 3, 3); Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta_safe = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta_safe) / theta_safe)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta_safe)) / theta2_safe)
    W = hat(w)
    W2 = matmul(W, W)
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


def se3_identity(dtype=torch.float32, device=None):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros((3,), dtype=dtype, device=device))


def se3_apply(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points: (..., 3, 3), (..., 3), (N, 3) -> (N, 3)."""
    return pts @ R.transpose(-1, -2) + t


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, ta + _matvec(Ra, tb)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, t)


def se3_exp(xi: torch.Tensor):
    """Exp map of a (..., 6) twist [w, v] (rotation first, like the solver
    state dx = [dtheta, dt]) -> (R, t), with the full SE(3) V matrix."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    eye = _eye_like(W)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2_safe * theta))
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return R, _matvec(V, v)


def so3_jl_inv(w: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse LEFT Jacobian of SO(3) (the V^-1 of the SE(3)
    exp), (..., 3) -> (..., 3, 3); Taylor-safe near 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    # V^-1 = I - W/2 + (1/theta^2 - (1+cos)/(2 theta sin)) W^2
    half_theta = 0.5 * theta
    cot = torch.cos(half_theta) / torch.sin(half_theta)   # theta >= 1 when "small"
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - half_theta * cot) / theta2_safe)
    return _eye_like(W) - 0.5 * W + coef[..., None, None] * W2


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Log map -> (..., 6) twist [w, v]."""
    w = so3_log(R)
    return torch.cat([w, _matvec(so3_jl_inv(w), t)], dim=-1)


def se3_adjoint(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """6x6 Ad(T) for the [w, v] twist ordering: Ad(T) [w; v] =
    [R w; hat(t) R w + R v], so that T Exp(xi) T^-1 = Exp(Ad(T) xi)."""
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([hat(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _se3_Q(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q matrix (State Estimation for Robotics eq. 7.86b, rho = v,
    phi = w): the translation-rotation block of the SE(3) left Jacobian.
    Taylor-safe near theta = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    s, c = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - s) / (theta2_safe * theta))
    c2 = torch.where(small, 1.0 / 24.0 - theta2 / 720.0,
                     (theta2 + 2.0 * c - 2.0) / (2.0 * theta2_safe ** 2))
    c3 = torch.where(small, 1.0 / 120.0 - theta2 / 2520.0,
                     (2.0 * theta - 3.0 * s + theta * c) / (2.0 * theta2_safe ** 2 * theta))
    W = hat(w)
    V_ = hat(v)
    WV, VW = W @ V_, V_ @ W
    WVW = WV @ W
    c1, c2, c3 = c1[..., None, None], c2[..., None, None], c3[..., None, None]
    return (0.5 * V_
            + c1 * (WV + VW + W @ VW)
            + c2 * (W @ WV + VW @ W - 3.0 * WVW)
            + c3 * (WVW @ W + W @ WVW))


def se3_jl_inv(xi: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse LEFT Jacobian of SE(3), (..., 6) -> (..., 6, 6),
    twist ordering [w, v]: Jl = [[J, 0], [Q, J]], so
    Jl^-1 = [[J^-1, 0], [-J^-1 Q J^-1, J^-1]]; the exact derivative
    d/d_eps Log(Exp(eps) Exp(xi)) at eps = 0."""
    w, v = xi[..., :3], xi[..., 3:]
    Jinv = so3_jl_inv(w)
    JQJ = -Jinv @ _se3_Q(w, v) @ Jinv
    top = torch.cat([Jinv, torch.zeros_like(Jinv)], dim=-1)
    bot = torch.cat([JQJ, Jinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_jr_inv(xi: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse RIGHT Jacobian of SE(3): Jr^-1(xi) = Jl^-1(-xi),
    the exact derivative d/d_eps Log(Exp(xi) Exp(eps)) at eps = 0."""
    return se3_jl_inv(-xi)


def se3_retract(R, t, dx, matmul=torch.matmul):
    """The reference GN update: right-multiply SO3 by exp(dx[:3]), add dx[3:]
    to the translation."""
    return matmul(R, so3_exp(dx[..., :3], matmul)), t + dx[..., 3:]


def so3_renormalize(R: torch.Tensor, matmul=torch.matmul) -> torch.Tensor:
    """Project a near-rotation matrix back onto SO(3) (two Newton-Schulz
    polar iterations). Every matcher projects its output rotation once per
    solve so float32 retraction defects cannot feed back through the
    constant-velocity / ESKF prediction and grow."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    for _ in range(2):
        RtR = matmul(R.transpose(-1, -2), R)
        R = 0.5 * matmul(R, 3.0 * eye - RtR)
    return R


def se3_retract_full(R, t, dx):
    """Full right-multiplicative retraction T * Exp(dx) (the pose graph's,
    whose residual is linearized with respect to this perturbation)."""
    return se3_compose(R, t, *se3_exp(dx))


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> 4x4 homogeneous matrix."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    M = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    M[..., :3, :3] = R
    M[..., :3, 3] = t
    M[..., 3, 3] = 1.0
    return M


def se3_from_matrix(M: torch.Tensor):
    return M[..., :3, :3], M[..., :3, 3]


# ---------------------------------------------------------------------------
# Quaternions / Euler (for I/O: TUM trajectories, extrinsic configs)
# ---------------------------------------------------------------------------

def quat_from_rotm(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), Shepperd's method:
    four candidate constructions, the one with the largest score wins
    (`torch.argmax`, like `jnp.argmax`, returns the first of equal
    maxima)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) * 0.5
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) * 0.5
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) * 0.5
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) * 0.5
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)               # (..., 4, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotm_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, alpha) -> torch.Tensor:
    """Normalized spherical lerp (the measurement synchronizer's quaternion
    interpolation): q1 flipped into q0's hemisphere, lerped, normalized."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    q = q0 + (q1 - q0) * alpha
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def rotm_from_rpy(roll, pitch, yaw) -> torch.Tensor:
    """ZYX Euler (applied Rz @ Ry @ Rx) -> float32 rotation matrix, the
    convention of the T_imu_lidar extrinsic."""
    roll, pitch, yaw = (torch.as_tensor(v, dtype=torch.float32) for v in (roll, pitch, yaw))
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(cy), torch.ones_like(cy)
    Rz = torch.stack([torch.stack([cy, -sy, z], -1), torch.stack([sy, cy, z], -1),
                      torch.stack([z, z, o], -1)], -2)
    Ry = torch.stack([torch.stack([cp, z, sp], -1), torch.stack([z, o, z], -1),
                      torch.stack([-sp, z, cp], -1)], -2)
    Rx = torch.stack([torch.stack([o, z, z], -1), torch.stack([z, cr, -sr], -1),
                      torch.stack([z, sr, cr], -1)], -2)
    return Rz @ Ry @ Rx


# ---------------------------------------------------------------------------
# SE(2) (the 2D stack): a pose is (theta, t) with t (..., 2)
# ---------------------------------------------------------------------------

def se2_apply(theta, t, pts):
    """(...,), (..., 2), (..., N, 2) -> the points rotated by theta and
    translated by t."""
    c, s = torch.cos(theta), torch.sin(theta)
    x = c[..., None] * pts[..., 0] - s[..., None] * pts[..., 1]
    y = s[..., None] * pts[..., 0] + c[..., None] * pts[..., 1]
    return torch.stack([x, y], dim=-1) + t[..., None, :]


def se2_compose(th_a, t_a, th_b, t_b):
    """(th_a, t_a) * (th_b, t_b); the angle is not wrapped."""
    c, s = torch.cos(th_a), torch.sin(th_a)
    tx = t_a[..., 0] + c * t_b[..., 0] - s * t_b[..., 1]
    ty = t_a[..., 1] + s * t_b[..., 0] + c * t_b[..., 1]
    return th_a + th_b, torch.stack([tx, ty], dim=-1)


def se2_inverse(theta, t):
    c, s = torch.cos(theta), torch.sin(theta)
    tx = -(c * t[..., 0] + s * t[..., 1])
    ty = -(-s * t[..., 0] + c * t[..., 1])
    return -theta, torch.stack([tx, ty], dim=-1)


def wrap_angle(a):
    """Wrap angle(s) to (-pi, pi], the reference's KeepAngleInPI."""
    return torch.atan2(torch.sin(a), torch.cos(a))
