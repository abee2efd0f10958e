"""Offline replay: log alignment into per-scan measure groups (numpy; copy of
the measure-sync part of loc_lib_tpu/io/replay.py, kept here because the JAX
package cannot be imported without jax).

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
