"""Synthetic LiDAR world / trajectory / scan generator (numpy; copy of
loc_lib_tpu/io/synthetic.py's 3D and 2D generators, kept here because the JAX
package cannot be imported without jax). The same seed gives bit-identical
arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.pointcloud import PointCloud, card_device, from_numpy


def make_world(num_points: int = 60000, extent: float = 120.0,
               seed: int = 0) -> np.ndarray:
    """Structured world: ground plane + walls + scattered pillars."""
    rng = np.random.default_rng(seed)
    n_ground = num_points // 3
    n_wall = num_points // 3
    n_pillar = num_points - n_ground - n_wall

    ground = np.stack([
        rng.uniform(-extent, extent, n_ground),
        rng.uniform(-extent, extent, n_ground),
        rng.normal(0.0, 0.02, n_ground),
    ], axis=1)

    # axis-aligned wall segments at random offsets
    walls = []
    n_seg = 24
    per = n_wall // n_seg
    for _ in range(n_seg):
        axis = rng.integers(0, 2)
        offset = rng.uniform(-extent, extent)
        lo, hi = sorted(rng.uniform(-extent, extent, 2))
        run = rng.uniform(lo, hi, per)
        z = rng.uniform(0.0, 4.0, per)
        jitter = rng.normal(0.0, 0.02, per)
        if axis == 0:
            walls.append(np.stack([run, offset + jitter, z], axis=1))
        else:
            walls.append(np.stack([offset + jitter, run, z], axis=1))
    walls = np.concatenate(walls)[:n_wall]

    centers = rng.uniform(-extent, extent, (40, 2))
    pick = rng.integers(0, 40, n_pillar)
    ang = rng.uniform(0, 2 * np.pi, n_pillar)
    r = 0.3 + rng.normal(0.0, 0.01, n_pillar)
    pillars = np.stack([
        centers[pick, 0] + r * np.cos(ang),
        centers[pick, 1] + r * np.sin(ang),
        rng.uniform(0.0, 5.0, n_pillar),
    ], axis=1)

    return np.concatenate([ground, walls, pillars]).astype(np.float32)


class Trajectory(NamedTuple):
    stamps: np.ndarray    # (T,)
    R: np.ndarray         # (T, 3, 3)
    t: np.ndarray         # (T, 3)


def make_trajectory(num_frames: int = 50, dt: float = 0.1, speed: float = 2.0,
                    yaw_rate: float = 0.15, height: float = 1.5) -> Trajectory:
    """Constant-speed arc at sensor height."""
    stamps = np.arange(num_frames) * dt
    yaw = yaw_rate * stamps
    x = np.cumsum(np.cos(yaw)) * speed * dt
    y = np.cumsum(np.sin(yaw)) * speed * dt
    t = np.stack([x, y, np.full_like(x, height)], axis=1)
    c, s = np.cos(yaw), np.sin(yaw)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    R = np.stack([
        np.stack([c, -s, z], axis=1),
        np.stack([s, c, z], axis=1),
        np.stack([z, z, o], axis=1),
    ], axis=1)
    return Trajectory(stamps=stamps.astype(np.float64),
                      R=R.astype(np.float32), t=t.astype(np.float32))


def render_scan_numpy(world: np.ndarray, R: np.ndarray, t: np.ndarray,
                      max_range: float = 40.0, max_points: int = 8192,
                      noise: float = 0.01, seed: int = 0) -> np.ndarray:
    """Range-limited sample of the world in the sensor frame, (n, 3) float32."""
    rng = np.random.default_rng(seed)
    d = world - t
    close = np.linalg.norm(d, axis=1) <= max_range
    pts = world[close]
    if pts.shape[0] > max_points:
        pts = pts[rng.choice(pts.shape[0], max_points, replace=False)]
    local = (pts - t) @ R  # R^T from the right
    local = local + rng.normal(0.0, noise, local.shape)
    return local.astype(np.float32)


def render_scan(world: np.ndarray, R: np.ndarray, t: np.ndarray,
                max_range: float = 40.0, max_points: int = 8192,
                noise: float = 0.01, seed: int = 0,
                capacity: int | None = None, device=None) -> PointCloud:
    """`render_scan_numpy` as a padded PointCloud on `device` (default: the
    card; `from_numpy` raises where there is none)."""
    local = render_scan_numpy(world, R, t, max_range, max_points, noise, seed)
    return from_numpy(local, capacity=capacity or max_points, device=device)


def annotate_rings(pc: PointCloud, num_rings: int = 16,
                   min_elev_deg: float = -16.0, max_elev_deg: float = 16.0, *,
                   device=None) -> PointCloud:
    """Attach spinning-lidar ring structure to a sensor-frame scan: ring =
    elevation-angle bin, rows re-ordered by (ring, azimuth), valid rows
    first, so each ring's points are azimuth-contiguous (the layout LOAM's
    curvature stencil assumes). Computed in numpy on the host; the result
    lies on `device` (default: the card)."""
    device = card_device(device)
    xyz = pc.xyz.cpu().numpy()
    mask = pc.mask.cpu().numpy()
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rho = np.sqrt(x * x + y * y) + 1e-9
    elev = np.degrees(np.arctan2(z, rho))
    ring = np.clip(((elev - min_elev_deg)
                    / max(max_elev_deg - min_elev_deg, 1e-6)
                    * num_rings).astype(np.int32), 0, num_rings - 1)
    azim = np.arctan2(y, x)
    order = np.lexsort((azim, ring, ~mask))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PointCloud(xyz=t(xyz[order]), mask=t(mask[order]),
                      ring=t(np.where(mask[order], ring[order], -1)))


def make_world_2d(extent: float = 15.0, points_per_wall: int = 600,
                  seed: int = 0) -> np.ndarray:
    """2D wall-point world for the 2D mapping stack: a room with inner walls."""
    rng = np.random.default_rng(seed)
    e = extent
    segs = [
        ((-e, -e), (e, -e)), ((e, -e), (e, e)), ((e, e), (-e, e)), ((-e, e), (-e, -e)),
        ((-e / 2, -e), (-e / 2, 0.0)), ((0.0, e), (0.0, e / 3)),
        ((e / 3, -e / 2), (e, -e / 2)),
    ]
    pts = []
    for (x0, y0), (x1, y1) in segs:
        s = rng.uniform(0, 1, points_per_wall)
        pts.append(np.stack([x0 + (x1 - x0) * s, y0 + (y1 - y0) * s], axis=1))
    out = np.concatenate(pts)
    return (out + rng.normal(0, 0.01, out.shape)).astype(np.float32)


def render_scan_2d(world2d: np.ndarray, theta: float, t: np.ndarray,
                   max_range: float = 12.0, max_points: int = 720,
                   noise: float = 0.01, seed: int = 0):
    """Range-limited 2D sample in the sensor frame. Returns (xy, valid) as
    numpy: (max_points, 2) float32 and (max_points,) bool."""
    rng = np.random.default_rng(seed)
    d = world2d - t
    close = np.linalg.norm(d, axis=1) <= max_range
    pts = world2d[close]
    if len(pts) > max_points:
        pts = pts[rng.choice(len(pts), max_points, replace=False)]
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, -s], [s, c]])
    local = (pts - t) @ R + rng.normal(0, noise, (len(pts), 2))
    xy = np.zeros((max_points, 2), np.float32)
    valid = np.zeros((max_points,), bool)
    xy[: len(local)] = local
    valid[: len(local)] = True
    return xy, valid


def ideal_imu(traj: Trajectory, rate_hz: float = 100.0,
              gravity: float = 9.81, gyro_noise: float = 1e-4,
              acce_noise: float = 1e-3, seed: int = 1,
              static_secs: float = 1.5):
    """IMU samples consistent with the trajectory (finite differences), in
    the body frame, gravity-reactive like a real accelerometer, with
    `static_secs` of stationary samples before the first scan stamp."""
    rng = np.random.default_rng(seed)
    t0, t1 = traj.stamps[0], traj.stamps[-1]
    stamps = np.arange(t0, t1, 1.0 / rate_hz)

    x = np.interp(stamps, traj.stamps, traj.t[:, 0])
    y = np.interp(stamps, traj.stamps, traj.t[:, 1])
    z = np.interp(stamps, traj.stamps, traj.t[:, 2])
    yaw = np.unwrap(np.arctan2(traj.R[:, 1, 0], traj.R[:, 0, 0]))
    yw = np.interp(stamps, traj.stamps, yaw)

    dt = 1.0 / rate_hz
    vel = np.gradient(np.stack([x, y, z], axis=1), dt, axis=0)
    acc_w = np.gradient(vel, dt, axis=0)
    omega = np.gradient(yw, dt)

    # body frame: R^T (a_w - g_w)
    g_w = np.array([0.0, 0.0, -gravity])
    c, s = np.cos(yw), np.sin(yw)
    ax = c * (acc_w[:, 0] - g_w[0]) + s * (acc_w[:, 1] - g_w[1])
    ay = -s * (acc_w[:, 0] - g_w[0]) + c * (acc_w[:, 1] - g_w[1])
    az = acc_w[:, 2] - g_w[2]
    acce = np.stack([ax, ay, az], axis=1) + rng.normal(0, acce_noise, (len(stamps), 3))
    gyro = np.stack([np.zeros_like(omega), np.zeros_like(omega), omega], axis=1) \
        + rng.normal(0, gyro_noise, (len(stamps), 3))
    if static_secs > 0.0:
        pre = np.arange(t0 - static_secs, t0 - 1e-9, 1.0 / rate_hz)
        # yaw(t0)=0 in make_trajectory, so body==world at rest: a = -g_w.
        pre_acce = np.tile([0.0, 0.0, gravity], (len(pre), 1)) \
            + rng.normal(0, acce_noise, (len(pre), 3))
        pre_gyro = rng.normal(0, gyro_noise, (len(pre), 3))
        stamps = np.concatenate([pre, stamps])
        gyro = np.concatenate([pre_gyro, gyro])
        acce = np.concatenate([pre_acce, acce])
    return stamps, gyro.astype(np.float32), acce.astype(np.float32)
