"""Plain reference of one LIO / Loc step: the scan filter, the voxel-plane
target, the Gauss-Newton point-to-plane match with its exact 7-voxel
election, and the 18-state error-state Kalman filter (propagation through an
IMU packet, the pose update). Written from the algorithm's description in
plain PyTorch; it imports nothing of the program.

`Prec` chooses the arithmetic: float64 (the reference), or float32 with the
operands of every matrix product rounded to TF32 (10-bit mantissa), the
product then exact and summed in float32: what a matrix product gives with
TF32 on. The second is the control that a correct check has to refuse.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

WINDOW, HALF = 1024, 512          # voxel keys: +-512 cells about the binning origin
STENCIL = ((0, 0, 0), (-1, 0, 0), (1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, -1), (0, 0, 1))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    r = ((i + 0x1000) & ~0x1FFF).to(torch.int32)
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


class Prec:
    """The arithmetic of one reference run (see the module docstring)."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        self.dtype = torch.float32 if tf32 else torch.float64

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return round_tf32(a.to(torch.float32)) @ round_tf32(b.to(torch.float32))
        return a @ b

    def t(self, x, device=None) -> torch.Tensor:
        return torch.as_tensor(x, device=device).to(self.dtype)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    th = torch.linalg.vector_norm(w)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(th) < 1e-12:
        return eye + W
    return eye + torch.sin(th) / th * W + (1 - torch.cos(th)) / th ** 2 * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    c = torch.clamp((torch.trace(R) - 1) / 2, -1.0, 1.0)
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]) / 2
    s = torch.linalg.vector_norm(w)
    if float(s) < 1e-12:
        return w
    return torch.atan2(s, c) / s * w


def project_so3(R: torch.Tensor) -> torch.Tensor:
    """The nearest rotation (polar factor)."""
    U, _, Vh = torch.linalg.svd(R)
    return U @ Vh


# ---------------------------------------------------------------------------
# Voxels
# ---------------------------------------------------------------------------

def voxel_coords(xyz: torch.Tensor, origin: torch.Tensor, leaf: float) -> torch.Tensor:
    """floor((p - origin) / leaf) as int64; the key window is +-512 cells."""
    return torch.floor((xyz - origin) / leaf).to(torch.int64)


def in_window(c: torch.Tensor) -> torch.Tensor:
    return torch.all((c >= -HALF) & (c < WINDOW - HALF), dim=-1)


def keys_of(c: torch.Tensor) -> torch.Tensor:
    """Key order: x slowest, then y, then z."""
    s = c + HALF
    return (s[..., 0] * WINDOW + s[..., 1]) * WINDOW + s[..., 2]


def _group(keys: torch.Tensor):
    """(unique sorted keys, order of the rows by key, run lengths)."""
    order = torch.argsort(keys, stable=True)
    uniq, counts = torch.unique_consecutive(keys[order], return_counts=True)
    return uniq, order, counts


def voxel_filter(xyz: torch.Tensor, origin: torch.Tensor, leaf: float, keep: int):
    """The centroid of each occupied voxel (points outside the key window
    drop out), in key order, the first `keep` of them."""
    c = voxel_coords(xyz, origin, leaf)
    ok = in_window(c)
    xyz, c = xyz[ok], c[ok]
    uniq, order, counts = _group(keys_of(c))
    sums = torch.segment_reduce(xyz[order], "sum", lengths=counts, axis=0)
    cen = sums / counts[:, None].to(xyz.dtype)
    return cen[:keep]


def filter_scan(raw: torch.Tensor, prec: Prec, leaf: float, capacity: int) -> torch.Tensor:
    """A raw scan (all rows valid) filtered as the engines' front end does:
    voxels of `leaf` about the scan's centroid, the first `capacity` in key
    order."""
    x = raw.to(prec.dtype)
    return voxel_filter(x, x.mean(dim=0), leaf, capacity)


# ---------------------------------------------------------------------------
# The voxel-plane target
# ---------------------------------------------------------------------------

class Target(NamedTuple):
    origin: torch.Tensor       # (3,) binning origin
    leaf: float
    lo: torch.Tensor           # (3,) int64 corner of the indexed block
    dims: tuple
    table: torch.Tensor        # flat block -> plane row, -1 empty
    normal: torch.Tensor       # (V, 3)
    d: torch.Tensor            # (V,)
    mu: torch.Tensor           # (V, 3) merged centroid
    valid: torch.Tensor        # (V,) bool
    keys: torch.Tensor         # (V,) voxel keys


def _lookup(lo, dims, table, c):
    """Row of voxel coords c (..., 3) in the block, -1 where not indexed."""
    rel = c - lo
    dims_t = torch.tensor(dims, device=c.device)
    inside = in_window(c) & torch.all((rel >= 0) & (rel < dims_t), dim=-1)
    flat = (rel[..., 0] * dims[1] + rel[..., 1]) * dims[2] + rel[..., 2]
    row = table[torch.where(inside, flat, 0)]
    return torch.where(inside, row, -1)


def empty_target(prec: Prec, device, dims) -> Target:
    """A target with no voxel: every lookup misses (one invalid row stands in
    for the rows a miss would read)."""
    z = torch.zeros((1, 3), dtype=prec.dtype, device=device)
    return Target(torch.zeros(3, dtype=prec.dtype, device=device), 1.0,
                  torch.zeros(3, dtype=torch.int64, device=device), tuple(dims),
                  torch.full((dims[0] * dims[1] * dims[2],), -1, dtype=torch.int64, device=device),
                  z, z[:, 0], z, torch.zeros(1, dtype=torch.bool, device=device),
                  torch.zeros(1, dtype=torch.int64, device=device))


def build_target(cloud: torch.Tensor, origin: torch.Tensor, prec: Prec, leaf: float,
                 dims: tuple, min_pts: int, fit_eps: float) -> Target:
    """Per voxel of `leaf` (floor binning about `origin`) the points' count,
    mean and unbiased covariance; each voxel's moments merged with those of
    its 6 face neighbours (count-weighted, each neighbour's covariance taken
    as its spread about its mean); the plane through the merged centroid
    along the smallest eigenvector, valid with >= min_pts points, smallest
    eigenvalue <= fit_eps and the middle one >= 3 times it. Only voxels in
    the block of `dims` cells from the smallest occupied corner exist."""
    x = cloud.to(prec.dtype)
    c = voxel_coords(x, origin, leaf)
    ok = in_window(c)
    x, c = x[ok], c[ok]
    if x.shape[0] == 0:
        return empty_target(prec, x.device, dims)
    keys = keys_of(c)
    uniq, order, counts = _group(keys)
    xs = x[order]
    seg = torch.repeat_interleave(torch.arange(len(uniq), device=x.device), counts)
    n = counts.to(prec.dtype)
    mean = torch.segment_reduce(xs, "sum", lengths=counts, axis=0) / n[:, None]
    dev = xs - mean[seg]
    outer = (dev[:, :, None] * dev[:, None, :]).reshape(-1, 9)
    cov = (torch.segment_reduce(outer, "sum", lengths=counts, axis=0).reshape(-1, 3, 3)
           / torch.clamp(n - 1, min=1.0)[:, None, None])
    vc = c[order][torch.cumsum(counts, 0) - counts]                 # each voxel's coords
    lo = vc.min(dim=0).values
    total = dims[0] * dims[1] * dims[2]
    rel = vc - lo
    inside = torch.all(rel < torch.tensor(dims, device=x.device), dim=-1)
    table = torch.full((total,), -1, dtype=torch.int64, device=x.device)
    flat = (rel[:, 0] * dims[1] + rel[:, 1]) * dims[2] + rel[:, 2]
    table[flat[inside]] = torch.arange(len(uniq), device=x.device)[inside]
    # neighbour merge: the 7-voxel stencil, the voxel itself included
    st = torch.tensor(STENCIL, device=x.device)
    rows = _lookup(lo, dims, table, vc[:, None, :] + st[None])       # (V, 7)
    found = rows >= 0
    r = torch.clamp(rows, min=0)
    nk = torch.where(found, n[r], 0.0)
    N = nk.sum(dim=1)
    mu = (nk[..., None] * mean[r]).sum(dim=1) / torch.clamp(N, min=1.0)[:, None]
    dmu = mean[r] - mu[:, None, :]
    cov_m = (nk[..., None, None] * (cov[r] + dmu[..., :, None] * dmu[..., None, :])).sum(dim=1) \
        / torch.clamp(N, min=1.0)[:, None, None]
    # batched in pieces: the card's batched symmetric solver takes a bounded batch
    parts = [torch.linalg.eigh(c) for c in torch.split(cov_m, 8192)]
    vals, vecs = torch.cat([v for v, _ in parts]), torch.cat([w for _, w in parts])
    normal = vecs[..., :, 0]
    d = -(normal * mu).sum(dim=-1)
    valid = (found[:, 0] & (N >= min_pts) & (vals[:, 0] <= fit_eps) & (vals[:, 1] >= 3.0 * vals[:, 0])
             & torch.isfinite(normal).all(dim=-1) & torch.isfinite(d))
    return Target(origin.to(prec.dtype), leaf, lo, tuple(dims), table, normal, d, mu, valid, uniq)


# ---------------------------------------------------------------------------
# Gauss-Newton point-to-plane match
# ---------------------------------------------------------------------------

class Lin(NamedTuple):
    H: torch.Tensor
    b: torch.Tensor
    count: int
    chi2: float


def p2plane_terms(tgt: Target, q: torch.Tensor, R, t, gate: float, prec: Prec) -> Lin:
    """One linearization at (R, t): each point's plane is the valid one, among
    its voxel and the 6 face neighbours (in STENCIL order), whose merged
    centroid is nearest (strictly: the first wins ties); a point counts where
    its residual n.(Rq + t) + d is within the gate. H = sum J^T J, b = -sum
    J^T e with J = [-(R^T n) x q, n]."""
    qs = prec.mm(q, R.T) + t
    c = voxel_coords(qs, tgt.origin, tgt.leaf)
    st = torch.tensor(STENCIL, device=q.device)
    rows = _lookup(tgt.lo, tgt.dims, tgt.table, c[:, None, :] + st[None])    # (N, 7)
    r = torch.clamp(rows, min=0)
    ok = (rows >= 0) & tgt.valid[r]
    d2 = torch.where(ok, ((tgt.mu[r] - qs[:, None, :]) ** 2).sum(dim=-1), math.inf)
    pick = torch.argmin(d2, dim=1)                 # the first minimum: the first stencil entry
    row = r.gather(1, pick[:, None])[:, 0]
    n = tgt.normal[row]
    dis = (n * qs).sum(dim=-1) + tgt.d[row]
    w = (ok.any(dim=1) & (torch.abs(dis) <= gate)).to(q.dtype)
    rn = prec.mm(n, R)                             # R^T n, row by row
    A = torch.cat([-torch.linalg.cross(rn, q), n, dis[:, None], torch.ones_like(dis)[:, None]],
                  dim=1)
    A = torch.where(w[:, None] > 0, A, 0.0)
    G = prec.mm(A.T, A)
    return Lin(G[:6, :6], -G[:6, 6], int(round(float(G[7, 7]))), float(G[6, 6]))


class Match(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    converged: bool
    count: int
    chi2: float
    iterations: int
    H: torch.Tensor            # (6, 6) the linearization the returned pose came from
    n: int                     # its count


def gauss_newton(tgt: Target, q: torch.Tensor, R0, t0, opts: dict, prec: Prec,
                 linearizations=None) -> Match:
    """The match's GN loop: at most max_iteration linearizations; a step is
    taken where the count reaches min_effective (dx = H^-1 b, zeroed where
    not finite), R <- R exp(dx[:3]), t <- t + dx[3:]; the loop stops once a
    step is shorter than eps. R is returned projected onto SO(3).

    `linearizations` (the other side's iteration count for this match), when
    given, picks the linearization whose count and chi2 are returned, the
    loop running on past its own stop if need be; the pose is still the one
    its own stop rule gives. So the two sides' sums are compared at the same
    iteration where one side's last step fell just under eps and the other's
    just over."""
    R, t = R0.clone(), t0.clone()
    stats, out, it = [], None, 0
    while it < opts["max_iteration"]:
        lin = p2plane_terms(tgt, q, R, t, opts["max_plane_distance"], prec)
        it += 1
        stats.append((lin.count, lin.chi2))
        ok = lin.count >= opts["min_effective_pts"]
        dx = torch.linalg.solve_ex(lin.H, lin.b)[0] if ok else torch.zeros_like(lin.b)
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        R = prec.mm(R, so3_exp(dx[:3]))
        t = t + dx[3:]
        if out is None and ok and float(torch.linalg.vector_norm(dx)) < opts["eps"]:
            out = (project_so3(R), t.clone(), True, it, lin.H, lin.count)
        if out is not None and (linearizations is None or it >= linearizations):
            break
    if out is None:
        out = (project_so3(R), t, False, it, lin.H, lin.count)
    count, chi2 = stats[min(linearizations or out[3], len(stats)) - 1]
    return Match(out[0], out[1], out[2], count, chi2, out[3], out[4], out[5])


# ---------------------------------------------------------------------------
# The error-state Kalman filter (p, v, R, bg, ba, g; 18x18 covariance)
# ---------------------------------------------------------------------------

class Eskf(NamedTuple):
    p: torch.Tensor
    v: torch.Tensor
    R: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    g: torch.Tensor
    cov: torch.Tensor
    time: torch.Tensor

    @staticmethod
    def of(state, prec: Prec, device="cpu") -> "Eskf":
        """A filter state (any NamedTuple with these fields) in `prec`."""
        return Eskf(*(prec.t(getattr(state, f).detach().cpu(), device) for f in Eskf._fields))


def process_noise(eskf_opts: dict, prec: Prec, device="cpu") -> torch.Tensor:
    q = [0.0] * 3 + [eskf_opts["acce_var"]] * 3 + [eskf_opts["gyro_var"]] * 3 \
        + [eskf_opts["bias_gyro_var"]] * 3 + [eskf_opts["bias_acce_var"]] * 3 + [0.0] * 3
    return torch.diag(prec.t(q, device))


def predict(s: Eskf, gyros, acces, stamps, valid, eskf_opts: dict, prec: Prec) -> Eskf:
    """Propagate through an IMU packet, sample by sample: dt = stamp - time;
    a sample with dt outside [0, 5 imu_dt] leaves p, v, R and the covariance
    and moves the time; F is built from the new rotation; cov <- F cov F^T
    + Q. Padding rows (valid False) are skipped."""
    dev, dt_max = s.p.device, 5.0 * eskf_opts["imu_dt"]
    Q = process_noise(eskf_opts, prec, dev)
    eye = torch.eye(3, dtype=prec.dtype, device=dev)
    p, v, R, cov, time = s.p, s.v, s.R, s.cov, s.time
    for k in range(len(stamps)):
        if not valid[k]:
            continue
        stamp = prec.t(float(stamps[k]), dev)
        dt = stamp - time
        time = stamp
        if not (0.0 <= float(dt) <= dt_max):
            continue
        w = prec.t(gyros[k], dev) - s.bg
        a = prec.t(acces[k], dev) - s.ba
        acc = prec.mm(R, a[:, None])[:, 0]
        p = p + v * dt + 0.5 * acc * dt * dt + 0.5 * s.g * dt * dt
        v = v + acc * dt + s.g * dt
        R = prec.mm(R, so3_exp(w * dt))
        F = torch.eye(18, dtype=prec.dtype, device=dev)
        F[0:3, 3:6] = eye * dt
        F[3:6, 6:9] = -prec.mm(R, hat(a)) * dt
        F[3:6, 12:15] = -R * dt
        F[3:6, 15:18] = eye * dt
        F[6:9, 6:9] = so3_exp(-w * dt)
        F[6:9, 9:12] = -eye * dt
        cov = prec.mm(prec.mm(F, cov), F.T) + Q
    return s._replace(p=p, v=v, R=R, cov=cov, time=time)


def _gain(s: Eskf, eskf_opts: dict, prec: Prec):
    """(K, H) of the pose update of `s`: H selects p and the rotation error,
    V = diag(trans noise x3, angle noise x3) (the noise values themselves,
    not squared), K = P H^T (H P H^T + V)^-1."""
    dev = s.p.device
    H = torch.zeros((6, 18), dtype=prec.dtype, device=dev)
    H[0:3, 0:3] = torch.eye(3)
    H[3:6, 6:9] = torch.eye(3)
    V = torch.diag(prec.t([eskf_opts["trans_noise"]] * 3 + [eskf_opts["ang_noise_rad"]] * 3, dev))
    PHt = prec.mm(s.cov, H.T)
    return prec.mm(PHt, torch.linalg.inv(prec.mm(H, PHt) + V)), H


def observe_pose(s: Eskf, R_obs, t_obs, eskf_opts: dict, prec: Prec) -> Eskf:
    """The pose update: innovation [t_obs - p, log(R^T R_obs)], dx = K innov
    (`_gain`), cov = (I - K H) P; the nominal state takes dx (R <- R
    exp(dtheta)), and cov <- J cov J^T with J = I but I - hat(dtheta) / 2 on
    the rotation block."""
    dev = s.p.device
    K, H = _gain(s, eskf_opts, prec)
    R_obs, t_obs = prec.t(R_obs, dev), prec.t(t_obs, dev)
    innov = torch.cat([t_obs - s.p, so3_log(prec.mm(s.R.T, R_obs))])
    dx = prec.mm(K, innov[:, None])[:, 0]
    cov = prec.mm(torch.eye(18, dtype=prec.dtype, device=dev) - prec.mm(K, H), s.cov)
    J = torch.eye(18, dtype=prec.dtype, device=dev)
    J[6:9, 6:9] = torch.eye(3, dtype=prec.dtype, device=dev) - 0.5 * hat(dx[6:9])
    return s._replace(p=s.p + dx[0:3], v=s.v + dx[3:6],
                      R=project_so3(prec.mm(s.R, so3_exp(dx[6:9]))),
                      bg=s.bg + dx[9:12], ba=s.ba + dx[12:15], g=s.g + dx[15:18],
                      cov=prec.mm(prec.mm(J, cov), J.T))


def implied_update(s: Eskf, R_after, p_after, eskf_opts: dict) -> Eskf:
    """The pose update of the predicted state `s` (float64) that leaves the
    nominal pose at (R_after, p_after): the innovation that K's pose rows
    turn into that pose's correction, then the velocity, the biases and
    gravity as the same innovation corrects them. It holds a side's
    velocity, biases and gravity to the update of the pose that side
    reported, whatever the match's rounding chose along a direction the
    scan leaves unconstrained."""
    K, _ = _gain(s, eskf_opts, Prec())
    f = lambda x: torch.as_tensor(x).detach().to(torch.float64).to(s.p.device)
    d = torch.cat([f(p_after) - s.p, so3_log(s.R.T @ f(R_after))])
    dx = K @ torch.linalg.solve(K[[0, 1, 2, 6, 7, 8]], d)
    return s._replace(v=s.v + dx[3:6], bg=s.bg + dx[9:12], ba=s.ba + dx[12:15],
                      g=s.g + dx[15:18])
