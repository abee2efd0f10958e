"""The benchmark's own generator: a synthetic world, a closed circuit through
it, the IMU stream a vehicle on that circuit would give, one lap of raw
64-beam scans rendered on the device, and a voxel-filtered prior map.

It is a PyTorch rewrite of the synthetic generator the program carries
(ground plane, axis-aligned walls, pillars; a scan is a random subset of the
world points within range, in the sensor frame, with Gaussian noise), kept
here so that the yardstick does not move when the program does. Everything
is drawn from one seed through one `torch.Generator` on the device, in a
fixed order: the same seed gives the same bits on the same device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SCAN_DT = 0.1          # s between scans (10 Hz)
IMU_DT = 0.01          # s between IMU samples (100 Hz)
IMU_PER_SCAN = 10
GRAVITY = 9.81
T_BASE = 2.0           # s: stamp of the first ramp scan; the static window lies before it


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 64))
    return g


def _uniform(g, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device, dtype=torch.float64)


def _normal(g, n, std, device):
    return std * torch.randn(n, generator=g, device=device, dtype=torch.float64)


def wall_layout(n_walls: int, e: float, g: torch.Generator, device):
    """(axis, offset, ends) of `n_walls` axis-aligned walls in +-e metres, as
    (n_walls, 1) int64, (n_walls, 1) and (n_walls, 2) float64: every other
    wall runs along each axis, the walls of one axis take one band each of
    the extent for their offsets (a uniform place in the band), and each wall
    is e to 2e long, placed uniformly within the extent. So every seed's
    world has walls of both directions spread over it, and a scan's kept
    half sees both wherever the route takes it: where it sees walls of one
    direction only, the match leaves the pose all but free along them, and
    float32 rounding alone then moves it by centimetres (the smallest
    eigenvalue of the match's normal matrix over its count fell to 1e-4 on
    some seeds' laps under walls of a random direction, offset and extent;
    under this layout it stayed above 0.03 on every lap measured)."""
    k = torch.arange(n_walls, device=device)[:, None]
    axis = k % 2
    per_axis = torch.where(axis == 0, (n_walls + 1) // 2, n_walls // 2).to(torch.float64)
    offset = -e + (k // 2 + _uniform(g, (n_walls, 1), 0.0, 1.0, device)) * (2.0 * e / per_axis)
    length = _uniform(g, (n_walls, 1), e, 2.0 * e, device)
    start = -e + (2.0 * e - length) * _uniform(g, (n_walls, 1), 0.0, 1.0, device)
    return axis, offset, torch.cat([start, start + length], dim=1)


def make_world(world: dict, g: torch.Generator, device) -> torch.Tensor:
    """(points, 3) float32 on `device`: a third ground plane (z ~ N(0, 2 cm)),
    a third on `walls` axis-aligned wall segments (4 m tall; `wall_layout`),
    the rest on `pillars` cylinders of radius 0.3 m (5 m tall), all in a box
    of +-extent metres."""
    n, e = int(world["points"]), float(world["extent_m"])
    n_walls, n_pillars = int(world["walls"]), int(world["pillars"])
    n_ground = n // 3
    per_wall = (n // 3) // n_walls
    n_pillar = n - n_ground - per_wall * n_walls
    ground = torch.stack([_uniform(g, n_ground, -e, e, device), _uniform(g, n_ground, -e, e, device),
                          _normal(g, n_ground, 0.02, device)], dim=1)
    axis, offset, ends = wall_layout(n_walls, e, g, device)
    run = ends[:, :1] + (ends[:, 1:] - ends[:, :1]) * torch.rand(
        (n_walls, per_wall), generator=g, device=device, dtype=torch.float64)
    z = _uniform(g, (n_walls, per_wall), 0.0, 4.0, device)
    across = offset + _normal(g, (n_walls, per_wall), 0.02, device)
    walls = torch.stack([torch.where(axis == 0, run, across), torch.where(axis == 0, across, run), z],
                        dim=-1).reshape(-1, 3)
    centers = _uniform(g, (n_pillars, 2), -e, e, device)
    pick = torch.randint(0, n_pillars, (n_pillar,), generator=g, device=device)
    ang = _uniform(g, n_pillar, 0.0, 2.0 * math.pi, device)
    r = 0.3 + _normal(g, n_pillar, 0.01, device)
    pillars = torch.stack([centers[pick, 0] + r * torch.cos(ang), centers[pick, 1] + r * torch.sin(ang),
                           _uniform(g, n_pillar, 0.0, 5.0, device)], dim=1)
    return torch.cat([ground, walls, pillars]).to(torch.float32)


class Route(NamedTuple):
    """A circuit of radius `radius` about the world's centre, driven
    counter-clockwise from rest: `ramp` scans of constant acceleration up to
    `speed`, then the lap, at `speed` plus `swing` sin(`swing_rate` t) (a
    whole number of swings a lap, so the lap closes at the speed it started
    with; the yaw rate follows the speed). Scan k is at T_BASE + k SCAN_DT;
    scan `ramp + f` is lap frame f (0 <= f < lap), and every later scan
    repeats one of them. Before scan 0 the vehicle stands still for `static`
    IMU samples."""

    speed: float
    swing: float           # m/s
    swing_rate: float      # rad/s
    accel: float
    radius: float
    height: float
    ramp: int              # scans before the constant-speed lap starts
    lap: int               # scans in one lap
    static: int            # IMU samples at rest before scan 0

    @property
    def lap_seconds(self) -> float:
        return self.lap * SCAN_DT


def make_route(traffic: dict, sensor: dict) -> Route:
    """The circuit of a traffic mix: the lap is a whole number of scans, and
    the radius is set so that the lap closes exactly."""
    v = float(traffic["speed_mps"])
    lap = int(round(2.0 * math.pi * float(traffic["radius_m"]) / (v * SCAN_DT)))
    ramp = int(round(float(traffic["ramp_s"]) / SCAN_DT))
    return Route(speed=v, swing=float(traffic["speed_swing_mps"]),
                 swing_rate=2.0 * math.pi * int(traffic["swings_per_lap"]) / (lap * SCAN_DT),
                 accel=v / (ramp * SCAN_DT), radius=v * lap * SCAN_DT / (2.0 * math.pi),
                 height=float(sensor["height_m"]), ramp=ramp, lap=lap,
                 static=int(round(float(traffic["static_s"]) / IMU_DT)))


def _arc(route: Route, tau: np.ndarray, steady: bool = False):
    """(arc length, speed, tangential acceleration) at times tau (s after
    scan 0; at rest before it). `steady`: as if the lap had always been
    driven (the samples of a replayed lap)."""
    t1 = route.ramp * SCAN_DT
    s1 = 0.5 * route.accel * t1 ** 2
    x, w, A = tau - t1, route.swing_rate, route.swing
    s_lap = s1 + route.speed * x + (A / w * (1.0 - np.cos(w * x)) if w else 0.0)
    u_lap = route.speed + A * np.sin(w * x)
    a_lap = A * w * np.cos(w * x)
    if steady:
        return s_lap, u_lap, a_lap
    rest, ramping = tau < 0, tau < t1
    tc = np.maximum(tau, 0.0)
    s = np.where(ramping, 0.5 * route.accel * tc ** 2, s_lap)
    u = np.where(ramping, route.accel * tc, u_lap)
    a = np.where(rest, 0.0, np.where(ramping, route.accel, a_lap))
    return s, u, a


def poses_at(route: Route, tau: np.ndarray) -> np.ndarray:
    """(n, 4, 4) float64 world poses of the sensor at times tau: on the
    circle, heading along it, level."""
    s, _, _ = _arc(route, tau)
    yaw = s / route.radius
    phi = yaw - 0.5 * math.pi
    T = np.tile(np.eye(4), (len(tau), 1, 1))
    c, sn = np.cos(yaw), np.sin(yaw)
    T[:, 0, 0], T[:, 0, 1], T[:, 1, 0], T[:, 1, 1] = c, -sn, sn, c
    T[:, 0, 3] = route.radius * np.cos(phi)
    T[:, 1, 3] = route.radius * np.sin(phi)
    T[:, 2, 3] = route.height
    return T


def ramp_times(route: Route) -> np.ndarray:
    """Times of the ramp's scans 0 .. ramp - 1."""
    return np.arange(route.ramp) * SCAN_DT


def lap_times(route: Route) -> np.ndarray:
    """Times of lap frames 0 .. lap - 1 in the first pass (frame 0 is the
    first scan at full speed)."""
    return (route.ramp + np.arange(route.lap)) * SCAN_DT


def _draw(n: int, g: torch.Generator) -> np.ndarray:
    return torch.randn((n, 3), generator=g, device=g.device, dtype=torch.float64).cpu().numpy()


def bias_walk(n: int, noise: dict, key: str, g: torch.Generator) -> np.ndarray:
    """(n, 3) a sensor bias over n consecutive samples: a random walk with
    the rate random walk `noise[key]` (per sqrt(Hz)), pinned to 0 at both
    ends (a Brownian bridge), so that a replayed stretch joins itself."""
    w = np.cumsum(float(noise[key]) * math.sqrt(IMU_DT) * _draw(n, g), axis=0)
    return w - (np.arange(1, n + 1) / n)[:, None] * w[-1]


def imu_samples(route: Route, tau: np.ndarray, noise: dict, g: torch.Generator, bias: tuple,
                steady: bool = False):
    """IMU samples at times tau in the body frame: gyro and acce (float32)
    with the biases `bias` (gyro, acce: (n, 3)) and white noise of the
    configured densities drawn from `g`. On a level circle the gyro reads the
    yaw rate and the accelerometer the tangential and centripetal
    accelerations plus the reaction to gravity."""
    _, u, a = _arc(route, tau, steady)
    n = len(tau)
    gyro = np.zeros((n, 3))
    gyro[:, 2] = u / route.radius
    acce = np.stack([a, u * u / route.radius, np.full(n, GRAVITY)], axis=1)
    white = lambda key: float(noise[key]) / math.sqrt(IMU_DT) * _draw(n, g)
    gyro = gyro + bias[0] + white("gyro_noise_density")
    acce = acce + bias[1] + white("accel_noise_density")
    return gyro.astype(np.float32), acce.astype(np.float32)


def stamps32(rel: np.ndarray, offset: float = 0.0) -> np.ndarray:
    """Absolute stamps as float32 values: what the program and the reference
    both read, so that both take the same differences."""
    return (T_BASE + rel + offset).astype(np.float32)


class Packets(NamedTuple):
    """Padded IMU packets, one per scan (the samples after the previous
    scan, up to and including this scan's stamp): rel (S, C) float64 stamps
    relative to T_BASE, gyro / acce (S, C, 3) float32, valid (S, C) bool."""

    rel: np.ndarray
    gyro: np.ndarray
    acce: np.ndarray
    valid: np.ndarray

    def take(self, k: int, offset: float = 0.0):
        """Packet k as the engines take it: (gyro, acce, float32 stamps, valid)."""
        return self.gyro[k], self.acce[k], stamps32(self.rel[k], offset), self.valid[k]


def _packets(route, scan_tau, noise, capacity, g, bias, steady):
    k = len(scan_tau)
    rel = np.zeros((k, capacity))
    rel[:, :IMU_PER_SCAN] = scan_tau[:, None] + IMU_DT * (np.arange(IMU_PER_SCAN) - IMU_PER_SCAN + 1)
    gyro, acce = imu_samples(route, rel[:, :IMU_PER_SCAN].reshape(-1), noise, g, bias, steady)
    gy = np.zeros((k, capacity, 3), np.float32)
    ac = np.zeros((k, capacity, 3), np.float32)
    gy[:, :IMU_PER_SCAN] = gyro.reshape(k, IMU_PER_SCAN, 3)
    ac[:, :IMU_PER_SCAN] = acce.reshape(k, IMU_PER_SCAN, 3)
    valid = np.zeros((k, capacity), bool)
    valid[:, :IMU_PER_SCAN] = True
    return Packets(rel, gy, ac, valid)


def make_imu(route: Route, noise: dict, capacity: int, g: torch.Generator):
    """(the static window before scan 0: rel stamps, gyro, acce; the Packets
    of ramp scans 0 .. ramp (the last one arrives with lap frame 0 on the
    first pass); the Packets of lap frames 0 .. lap - 1, which every later
    pass replays). The biases walk from the static window's first sample to
    the ramp's last, and over the lap, each stretch pinned to 0 at its
    ends."""
    tau = -IMU_DT * np.arange(route.static + IMU_PER_SCAN - 1, IMU_PER_SCAN - 1, -1)
    n0, n1 = len(tau), len(tau) + (route.ramp + 1) * IMU_PER_SCAN
    walks = [bias_walk(n, noise, key, g) for n in (n1, route.lap * IMU_PER_SCAN)
             for key in ("gyro_random_walk", "accel_random_walk")]
    static = (tau,) + imu_samples(route, tau, noise, g, (walks[0][:n0], walks[1][:n0]))
    ramp = _packets(route, np.arange(route.ramp + 1) * SCAN_DT, noise, capacity, g,
                    (walks[0][n0:], walks[1][n0:]), False)
    lap = _packets(route, lap_times(route), noise, capacity, g, (walks[2], walks[3]), True)
    return static, ramp, lap


def render_scans(world_xyz: torch.Tensor, poses: np.ndarray, sensor: dict, g: torch.Generator):
    """(S, P, 3) float32 raw scans on the world's device: for each pose, P
    points drawn without replacement from the world points within
    max_range, in the sensor frame, plus N(0, noise) on every coordinate.
    Raises where fewer than P points lie within range."""
    dev = world_xyz.device
    p, r2 = int(sensor["raw_points"]), float(sensor["max_range_m"]) ** 2
    out = torch.empty((len(poses), p, 3), dtype=torch.float32, device=dev)
    T = torch.as_tensor(poses, dtype=torch.float32, device=dev)
    for k in range(len(poses)):
        R, t = T[k, :3, :3], T[k, :3, 3]
        d = world_xyz - t
        near = torch.nonzero(torch.sum(d * d, dim=1) <= r2)[:, 0]
        if near.numel() < p:
            raise RuntimeError(f"scan {k}: {near.numel()} world points within range, "
                               f"the sensor returns {p}")
        pick = near[torch.randperm(near.numel(), generator=g, device=dev)[:p]]
        out[k] = d[pick] @ R + float(sensor["noise_m"]) * torch.randn(
            (p, 3), generator=g, device=dev)
    return out


def voxel_filter_map(world_xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """The prior map: the centroid of the world points in each voxel of a
    grid of `leaf` metres whose cells are centred on z = 0, so the ground
    plane falls in one layer (float64 sums, float32 out), in key order."""
    p = world_xyz.to(torch.float64)
    c = torch.floor(p / leaf + 0.5).to(torch.int64)
    c = c - c.min(dim=0).values
    span = c.max(dim=0).values + 1
    key = (c[:, 0] * span[1] + c[:, 1]) * span[2] + c[:, 2]
    uniq, inv = torch.unique(key, return_inverse=True)
    lengths = torch.bincount(inv, minlength=uniq.numel())
    sums = torch.segment_reduce(p[torch.argsort(inv, stable=True)], "sum", lengths=lengths, axis=0)
    return (sums / lengths[:, None].to(torch.float64)).to(torch.float32)


def max_crop_rows(map_xyz: torch.Tensor, centers: np.ndarray, half: float) -> int:
    """The largest number of map points inside an axis-aligned box of
    half-size `half` about any of `centers` (the route's positions)."""
    best = 0
    c = torch.as_tensor(centers, dtype=torch.float32, device=map_xyz.device)
    for k in range(0, len(c), 64):
        inside = torch.all(torch.abs(map_xyz[None] - c[k:k + 64, None]) <= half, dim=-1)
        best = max(best, int(inside.sum(dim=1).max()))
    return best
