"""Real-sensor ingestion: KITTI velodyne `.bin` logs and vendor-layout PCDs
(numpy; a copy of loc_lib_tpu/io/kitti.py, kept here because the JAX
package cannot be imported without jax). Both land in the `logdir.SensorLog`
schema:

  * KITTI odometry/raw velodyne scans: float32 (N, 4) [x y z intensity]
    `.bin` files + `times.txt` (float seconds) or `timestamps.txt`
    (datetime strings). KITTI strips the driver's ring field, so ring ids
    are RECOVERED from the firing order (HDL-64 packets store each laser
    ring's points azimuth-contiguously: a backward azimuth jump marks the
    next ring), and per-point relative time from the azimuth sweep of one
    revolution.
  * Vendor-layout PCDs (Robosense FullPointType rows): the reference's
    `CloudConver::Conver` semantics (LocUtils/src/subscriber/
    cloud_subscriber.cpp:7-62): finite + min-range-4m cull, ring
    passthrough, per-point absolute `timestamp` normalized to
    time_intervel = (t - t_first)/span.

Everything lands padded to a fixed capacity, the shape contract every
downstream step assumes.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

from .logdir import SensorLog
from .pcd import load_pcd_full

MIN_RANGE = 4.0  # the reference's near-field cull (cloud_subscriber.cpp:15,42)


def load_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI velodyne scan: float32 (N, 4) rows [x y z intensity]
    (the raw-data devkit layout; topic analog `/kitti/velo/pointcloud`,
    test_node.cpp:264)."""
    raw = np.fromfile(path, dtype=np.float32)
    if raw.size % 4:
        raise ValueError(f"{path}: size {raw.size} not divisible by 4")
    return raw.reshape(-1, 4)


def recover_rings(xyz: np.ndarray, num_rings: int = 64) -> np.ndarray:
    """Ring ids from HDL-64 firing order: each ring's points are stored
    azimuth-contiguous, so a backward azimuth jump (wrap past -pi) starts
    the next ring. Returns (N,) int32 clipped to [0, num_rings)."""
    azim = np.arctan2(xyz[:, 1], xyz[:, 0])
    # unwrapped forward sweep: a drop of more than pi marks a new ring
    jump = np.zeros(len(azim), dtype=bool)
    jump[1:] = (azim[1:] - azim[:-1]) < -np.pi
    ring = np.cumsum(jump).astype(np.int32)
    return np.clip(ring, 0, num_rings - 1)


def azimuth_rel_time(xyz: np.ndarray) -> np.ndarray:
    """Per-point relative time in [0, 1] from the azimuth position within
    one revolution (KITTI strips per-point stamps; the scan is one 0.1 s
    sweep, so azimuth fraction IS the normalized firing time — the same
    [0, 1] convention as the Robosense time_intervel,
    cloud_subscriber.cpp:54)."""
    azim = np.arctan2(xyz[:, 1], xyz[:, 0])
    # KITTI velodynes spin clockwise starting near +pi (forward = 0 is the
    # scan middle); map the sweep monotonically onto [0, 1]
    return ((np.pi - azim) % (2.0 * np.pi)) / (2.0 * np.pi)


def load_timestamps(path: str) -> np.ndarray:
    """KITTI stamps: `times.txt` (odometry benchmark, float seconds) or
    `timestamps.txt` (raw suite, `YYYY-MM-DD HH:MM:SS.nanos` lines).
    Returns float64 seconds (raw datetimes relative to the first stamp's
    midnight, which preserves deltas exactly)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            m = re.match(r"(\d+)-(\d+)-(\d+) (\d+):(\d+):(\d+)\.(\d+)", line)
            if m:
                h, mi, s, frac = (int(m.group(4)), int(m.group(5)),
                                  int(m.group(6)), m.group(7))
                out.append(h * 3600 + mi * 60 + s
                           + int(frac) / 10.0 ** len(frac))
            else:
                out.append(float(line))
    return np.asarray(out, np.float64)


def _pack_frames(frames, stamps, capacity: int):
    """Pad per-frame point dicts into the SensorLog array layout (+ring,
    time, intensity side arrays)."""
    f = len(frames)
    xyz = np.full((f, capacity, 3), 1e6, np.float32)
    mask = np.zeros((f, capacity), bool)
    ring = np.full((f, capacity), -1, np.int32)
    ptime = np.zeros((f, capacity), np.float32)
    inten = np.zeros((f, capacity), np.float32)
    dropped = 0
    for k, fr in enumerate(frames):
        n = min(len(fr["xyz"]), capacity)
        dropped += max(len(fr["xyz"]) - capacity, 0)
        xyz[k, :n] = fr["xyz"][:n]
        mask[k, :n] = True
        ring[k, :n] = fr["ring"][:n]
        ptime[k, :n] = fr["time"][:n]
        inten[k, :n] = fr["intensity"][:n]
    log = SensorLog(np.asarray(stamps, np.float64), xyz, mask,
                    scan_ring=ring, scan_time=ptime, scan_intensity=inten)
    log.points_dropped = dropped  # capacity overflow count — observable
    return log


def load_kitti_log(velodyne_dir: str, times_path: Optional[str] = None,
                   capacity: int = 131072, max_frames: Optional[int] = None,
                   num_rings: int = 64, min_range: float = MIN_RANGE
                   ) -> SensorLog:
    """A KITTI sequence directory (`.bin` files, numerically sorted) as a
    replayable SensorLog with per-point ring/time recovered. The default
    capacity holds a full HDL-64 scan (~120k points) unpadded."""
    names = sorted((n for n in os.listdir(velodyne_dir)
                    if n.endswith(".bin")),
                   key=lambda n: int(os.path.splitext(n)[0]))
    if max_frames is not None:
        names = names[:max_frames]
    if not names:
        raise FileNotFoundError(f"no .bin scans under {velodyne_dir}")
    if times_path is None:
        for cand in ("times.txt", "timestamps.txt"):
            p = os.path.join(os.path.dirname(velodyne_dir.rstrip("/")), cand)
            if os.path.exists(p):
                times_path = p
                break
    stamps = (load_timestamps(times_path)[:len(names)]
              if times_path else 0.1 * np.arange(len(names)))
    frames = []
    for name in names:
        pts = load_velodyne_bin(os.path.join(velodyne_dir, name))
        ring = recover_rings(pts[:, :3], num_rings)
        rel = azimuth_rel_time(pts[:, :3])
        keep = (np.isfinite(pts).all(axis=1)
                & (np.linalg.norm(pts[:, :3], axis=1) >= min_range))
        frames.append({"xyz": pts[keep, :3], "intensity": pts[keep, 3],
                       "ring": ring[keep], "time": rel[keep]})
    return _pack_frames(frames, stamps[:len(names)], capacity)


def from_vendor_pcd(paths, stamps=None, capacity: int = 32768,
                    min_range: float = MIN_RANGE) -> SensorLog:
    """Vendor-layout PCD scans (Robosense FullPointType fields: x y z
    intensity ring timestamp) -> SensorLog, mirroring
    CloudConver::Conver(CloudDataRsLidar, ...) exactly
    (cloud_subscriber.cpp:31-58): finite + min-range cull, ring
    passthrough, per-point absolute stamps normalized to
    (t - t_first) / span in [0, 1]."""
    if isinstance(paths, str):
        paths = [paths]
    frames, out_stamps = [], []
    for k, path in enumerate(paths):
        f = load_pcd_full(path)
        xyz = np.stack([f["x"], f["y"], f["z"]], axis=1).astype(np.float32)
        n = len(xyz)
        inten = np.asarray(f.get("intensity", np.zeros(n)), np.float32)
        ring = np.asarray(f.get("ring", np.full(n, -1)), np.int32)
        if "timestamp" in f:        # Robosense: absolute per-point double
            ts = np.asarray(f["timestamp"], np.float64)
            span = max(float(ts[-1] - ts[0]), 1e-9)
            rel = ((ts - ts[0]) / span).astype(np.float32)
            scan_stamp = float(ts[0])
        elif "time" in f:           # already-relative per-point time
            rel = np.asarray(f["time"], np.float32)
            scan_stamp = 0.0
        else:
            rel = np.zeros(n, np.float32)
            scan_stamp = 0.0
        keep = (np.isfinite(xyz).all(axis=1)
                & (np.linalg.norm(xyz, axis=1) >= min_range))
        frames.append({"xyz": xyz[keep], "intensity": inten[keep],
                       "ring": ring[keep], "time": rel[keep]})
        out_stamps.append(stamps[k] if stamps is not None else scan_stamp)
    return _pack_frames(frames, out_stamps, capacity)
