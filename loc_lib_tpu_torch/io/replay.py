"""Offline replay: log alignment into per-scan measure groups, the wheel
odometry and velocity logs, and the GNSS ENU converter (numpy; a copy of
loc_lib_tpu/io/replay.py, kept here because the JAX package cannot be
imported without jax).

For each lidar scan, gather every IMU (and GNSS) sample since the previous
scan and linearly interpolate the straddling sample to the scan timestamp.
Groups come out as fixed-capacity padded arrays ready for
`lio.step_measure`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional, Sequence

import numpy as np


class MeasureGroup(NamedTuple):
    """One lidar scan + its padded IMU packet."""

    scan_index: int
    scan_stamp: float
    imu_stamp: np.ndarray   # (C,) float32
    imu_gyro: np.ndarray    # (C, 3) float32
    imu_acce: np.ndarray    # (C, 3) float32
    imu_valid: np.ndarray   # (C,) bool
    gnss: Optional[np.ndarray] = None   # (4,) [lat, lon, alt, stamp] at scan time


@dataclasses.dataclass
class ImuLog:
    stamps: np.ndarray      # (M,)
    gyro: np.ndarray        # (M, 3)
    acce: np.ndarray        # (M, 3)


@dataclasses.dataclass
class GnssLog:
    stamps: np.ndarray      # (M,)
    lla: np.ndarray         # (M, 3) lat/lon/alt


@dataclasses.dataclass
class OdomLog:
    """Wheel-encoder log: pulses per unit time per wheel. Consumed by the
    static-init stillness gate (models/eskf.odom_is_static) and the ESKF
    wheel-speed observation."""

    stamps: np.ndarray       # (M,)
    left_pulse: np.ndarray   # (M,)
    right_pulse: np.ndarray  # (M,)

    def sample_at(self, times: np.ndarray):
        """Zero-order hold: the reading at or before each query time (wheel
        pulses are rate counts over the preceding interval). Times before
        the first reading get the first reading."""
        idx = np.clip(np.searchsorted(self.stamps, times, side="right") - 1,
                      0, len(self.stamps) - 1)
        return self.left_pulse[idx], self.right_pulse[idx]


@dataclasses.dataclass
class VelocityLog:
    """Body-frame velocity log."""

    stamps: np.ndarray      # (M,)
    linear: np.ndarray      # (M, 3)
    angular: np.ndarray     # (M, 3)

    def sync_to(self, t: float) -> np.ndarray:
        """Interpolated (linear(3), angular(3)) at time t."""
        return np.concatenate([
            _interp_row(self.stamps, self.linear, t),
            _interp_row(self.stamps, self.angular, t),
        ])

    def transform_coordinate(self, T: np.ndarray) -> "VelocityLog":
        """Re-express velocities in another body frame: rotate both, add the
        lever-arm term v += w x r."""
        R, r = np.asarray(T[:3, :3]), np.asarray(T[:3, 3])
        w = self.angular @ R.T
        v = self.linear @ R.T + np.cross(w, r)
        return VelocityLog(stamps=self.stamps, linear=v, angular=w)

    def ned2enu(self) -> "VelocityLog":
        """NED -> ENU axis swap (x<->y, z negated)."""
        f = lambda a: np.stack([a[:, 1], a[:, 0], -a[:, 2]], axis=1)
        return VelocityLog(stamps=self.stamps, linear=f(self.linear),
                           angular=f(self.angular))


def _interp_row(stamps, rows, t):
    """Linear interpolation of (M, D) rows at time t."""
    i = np.searchsorted(stamps, t)
    if i == 0:
        return rows[0]
    if i >= len(stamps):
        return rows[-1]
    a = (t - stamps[i - 1]) / max(stamps[i] - stamps[i - 1], 1e-9)
    return rows[i - 1] * (1 - a) + rows[i] * a


def sync_measures(
    scan_stamps: Sequence[float],
    imu: Optional[ImuLog],
    gnss: Optional[GnssLog] = None,
    imu_capacity: int = 64,
) -> Iterator[MeasureGroup]:
    """Yield one MeasureGroup per scan, in order."""
    prev_t = -np.inf
    for k, t_scan in enumerate(scan_stamps):
        stamp = np.zeros((imu_capacity,), np.float32)
        gyro = np.zeros((imu_capacity, 3), np.float32)
        acce = np.zeros((imu_capacity, 3), np.float32)
        valid = np.zeros((imu_capacity,), bool)
        if imu is not None and len(imu.stamps):
            sel = (imu.stamps > prev_t) & (imu.stamps <= t_scan)
            idx = np.nonzero(sel)[0]
            # interpolate the straddling sample to exactly t_scan
            need_interp = (len(idx) == 0 or imu.stamps[idx[-1]] < t_scan) and \
                np.any(imu.stamps > t_scan) and np.any(imu.stamps <= t_scan)
            rows = list(idx[: imu_capacity - int(need_interp)])
            m = len(rows)
            if m:
                stamp[:m] = imu.stamps[rows]
                gyro[:m] = imu.gyro[rows]
                acce[:m] = imu.acce[rows]
                valid[:m] = True
            if need_interp and m < imu_capacity:
                stamp[m] = t_scan
                gyro[m] = _interp_row(imu.stamps, imu.gyro, t_scan)
                acce[m] = _interp_row(imu.stamps, imu.acce, t_scan)
                valid[m] = True
        g = None
        if gnss is not None and len(gnss.stamps):
            lla = _interp_row(gnss.stamps, gnss.lla, t_scan)
            g = np.array([lla[0], lla[1], lla[2], t_scan], np.float64)
        prev_t = t_scan  # next packet starts after this scan
        yield MeasureGroup(scan_index=k, scan_stamp=float(t_scan),
                           imu_stamp=stamp, imu_gyro=gyro, imu_acce=acce,
                           imu_valid=valid, gnss=g)


# ---------------------------------------------------------------------------
# GNSS ENU conversion (GeographicLib LocalCartesian replacement,
# sensor_data/gnss_data.cpp:16-53)
# ---------------------------------------------------------------------------

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563
_WGS84_E2 = _WGS84_F * (2 - _WGS84_F)


def _lla_to_ecef(lat, lon, alt):
    lat, lon = np.deg2rad(lat), np.deg2rad(lon)
    s, c = np.sin(lat), np.cos(lat)
    n = _WGS84_A / np.sqrt(1 - _WGS84_E2 * s * s)
    x = (n + alt) * c * np.cos(lon)
    y = (n + alt) * c * np.sin(lon)
    z = (n * (1 - _WGS84_E2) + alt) * s
    return np.array([x, y, z])


class EnuConverter:
    """lat/lon/alt -> local ENU meters about a fixed origin
    (GnssData::InitOriginPosition/UpdateXYZ, gnss_data.cpp:16-53)."""

    def __init__(self, lat0: float, lon0: float, alt0: float):
        self.origin_ecef = _lla_to_ecef(lat0, lon0, alt0)
        lat, lon = np.deg2rad(lat0), np.deg2rad(lon0)
        sl, cl = np.sin(lat), np.cos(lat)
        so, co = np.sin(lon), np.cos(lon)
        self.R = np.array([
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ])

    def to_enu(self, lat: float, lon: float, alt: float) -> np.ndarray:
        return self.R @ (_lla_to_ecef(lat, lon, alt) - self.origin_ecef)
