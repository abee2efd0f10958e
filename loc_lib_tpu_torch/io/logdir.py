"""On-disk sensor-log format for the offline replay harness (numpy; a copy
of loc_lib_tpu/io/logdir.py, kept here because the JAX package cannot be
imported without jax). A log saved by either package loads in the other:

    <log>/scans.npz   stamps (F,), xyz (F, C, 3) f32 padded, mask (F, C) bool
                      [+ ring (F, C) int32, time (F, C) f32, intensity (F, C) f32]
    <log>/imu.npz     stamps (M,), gyro (M, 3), acce (M, 3)        [optional]
    <log>/gnss.npz    stamps (K,), lla (K, 3) lat/lon/alt           [optional]
    <log>/gt.npz      poses (F, 4, 4)                               [optional]

`make_demo_log` synthesizes a physically consistent log (world + trajectory
+ ideal IMU); the same arguments give bit-identical arrays to the JAX
package's generator.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import replay, synthetic
from ..ops.pointcloud import PointCloud, card_device, from_numpy


class SensorLog:
    def __init__(self, scan_stamps, scan_xyz, scan_mask,
                 imu: Optional[replay.ImuLog] = None,
                 gnss: Optional[replay.GnssLog] = None,
                 gt_poses: Optional[np.ndarray] = None,
                 scan_ring: Optional[np.ndarray] = None,
                 scan_time: Optional[np.ndarray] = None,
                 scan_intensity: Optional[np.ndarray] = None):
        self.scan_stamps = scan_stamps
        self.scan_xyz = scan_xyz      # (F, C, 3) float32, PAD_COORD padded
        self.scan_mask = scan_mask    # (F, C) bool
        self.imu = imu
        self.gnss = gnss
        self.gt_poses = gt_poses      # (F, 4, 4) when available
        # real-sensor per-point structure (io/kitti.py readers): ring id
        # (F, C) int32 (-1 = none), relative firing time (F, C) float32 in
        # [0, 1], intensity (F, C) float32
        self.scan_ring = scan_ring
        self.scan_time = scan_time
        self.scan_intensity = scan_intensity

    @property
    def num_frames(self) -> int:
        return len(self.scan_stamps)

    def frame(self, k: int, device=None) -> PointCloud:
        """Frame k as a padded PointCloud on `device` (default: the card,
        see `pointcloud.card_device`), carrying ring / time / intensity when
        the log has them (what LOAM's feature extraction consumes)."""
        device = card_device(device)
        pick = lambda a: None if a is None else torch.from_numpy(a[k]).to(device)
        return PointCloud(xyz=torch.from_numpy(self.scan_xyz[k]).to(device),
                          mask=torch.from_numpy(self.scan_mask[k]).to(device),
                          intensity=pick(self.scan_intensity),
                          ring=pick(self.scan_ring),
                          time=pick(self.scan_time))

    def measures(self, imu_capacity: int = 64):
        """Per-scan measure groups; the IMU grouping runs in the native C++
        runtime when available (io/native.py), the numpy synchronizer
        otherwise; both give the same packets."""
        from . import native

        if self.gnss is None and self.imu is not None and native.available():
            st, gy, ac, va = native.sync_measures_batch(
                np.asarray(self.scan_stamps, np.float64), self.imu.stamps,
                self.imu.gyro, self.imu.acce, imu_capacity)

            def gen():
                for k, t_scan in enumerate(self.scan_stamps):
                    yield replay.MeasureGroup(
                        scan_index=k, scan_stamp=float(t_scan),
                        imu_stamp=st[k], imu_gyro=gy[k], imu_acce=ac[k],
                        imu_valid=va[k])

            return gen()
        return replay.sync_measures(self.scan_stamps, self.imu, self.gnss,
                                    imu_capacity=imu_capacity)


def save_log(directory: str, log: SensorLog) -> None:
    os.makedirs(directory, exist_ok=True)
    extras = {k: getattr(log, "scan_" + k) for k in
              ("ring", "time", "intensity")
              if getattr(log, "scan_" + k, None) is not None}
    np.savez(os.path.join(directory, "scans.npz"), stamps=log.scan_stamps,
             xyz=log.scan_xyz, mask=log.scan_mask, **extras)
    if log.imu is not None:
        np.savez(os.path.join(directory, "imu.npz"), stamps=log.imu.stamps,
                 gyro=log.imu.gyro, acce=log.imu.acce)
    if log.gnss is not None:
        np.savez(os.path.join(directory, "gnss.npz"), stamps=log.gnss.stamps,
                 lla=log.gnss.lla)
    if log.gt_poses is not None:
        np.savez(os.path.join(directory, "gt.npz"), poses=log.gt_poses)


def load_log(directory: str) -> SensorLog:
    s = np.load(os.path.join(directory, "scans.npz"))
    imu = gnss = gt = None
    p = os.path.join(directory, "imu.npz")
    if os.path.exists(p):
        d = np.load(p)
        imu = replay.ImuLog(stamps=d["stamps"], gyro=d["gyro"], acce=d["acce"])
    p = os.path.join(directory, "gnss.npz")
    if os.path.exists(p):
        d = np.load(p)
        gnss = replay.GnssLog(stamps=d["stamps"], lla=d["lla"])
    p = os.path.join(directory, "gt.npz")
    if os.path.exists(p):
        gt = np.load(p)["poses"]
    get = lambda k: s[k] if k in s.files else None
    return SensorLog(s["stamps"], s["xyz"], s["mask"], imu, gnss, gt,
                     scan_ring=get("ring"), scan_time=get("time"),
                     scan_intensity=get("intensity"))


def make_demo_log(num_frames: int = 30, capacity: int = 8192,
                  with_imu: bool = True, seed: int = 0,
                  dt: float = 0.1, speed: float = 2.0,
                  yaw_rate: float = 0.15,
                  world_points: int = 120000,
                  extent: float = 80.0, max_range: float = 70.0) -> SensorLog:
    """Synthetic demo log: world render per trajectory pose + consistent IMU."""
    world = synthetic.make_world(num_points=world_points, extent=extent, seed=seed)
    traj = synthetic.make_trajectory(num_frames=num_frames, dt=dt, speed=speed,
                                     yaw_rate=yaw_rate)
    xyz = np.zeros((num_frames, capacity, 3), np.float32)
    mask = np.zeros((num_frames, capacity), bool)
    for k in range(num_frames):
        local = synthetic.render_scan_numpy(world, traj.R[k], traj.t[k],
                                            max_range=max_range,
                                            max_points=capacity, noise=0.01,
                                            seed=k)
        pc = from_numpy(local, capacity=capacity, device="cpu")   # host staging
        xyz[k] = pc.xyz.numpy()
        mask[k] = pc.mask.numpy()
    imu = None
    if with_imu:
        st, gy, ac = synthetic.ideal_imu(traj, rate_hz=100.0)
        imu = replay.ImuLog(stamps=st, gyro=gy, acce=ac)
    gt = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    gt[:, :3, :3] = traj.R
    gt[:, :3, 3] = traj.t
    return SensorLog(traj.stamps, xyz, mask, imu, None, gt)
