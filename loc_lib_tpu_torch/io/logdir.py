"""Sensor log for the offline replay harness (numpy; copy of the in-memory
part of loc_lib_tpu/io/logdir.py, kept here because the JAX package cannot
be imported without jax).

`make_demo_log` synthesizes a physically consistent log (world + trajectory
+ ideal IMU); the same arguments give bit-identical arrays to the JAX
package's generator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import replay, synthetic
from ..ops.pointcloud import PointCloud, from_numpy


class SensorLog:
    def __init__(self, scan_stamps, scan_xyz, scan_mask,
                 imu: Optional[replay.ImuLog] = None,
                 gnss: Optional[replay.GnssLog] = None,
                 gt_poses: Optional[np.ndarray] = None):
        self.scan_stamps = scan_stamps
        self.scan_xyz = scan_xyz      # (F, C, 3) float32, PAD_COORD padded
        self.scan_mask = scan_mask    # (F, C) bool
        self.imu = imu
        self.gnss = gnss
        self.gt_poses = gt_poses      # (F, 4, 4) when available

    @property
    def num_frames(self) -> int:
        return len(self.scan_stamps)

    def frame(self, k: int, device) -> PointCloud:
        """Frame k as a padded PointCloud on `device`."""
        return PointCloud(xyz=torch.from_numpy(self.scan_xyz[k]).to(device),
                          mask=torch.from_numpy(self.scan_mask[k]).to(device))

    def measures(self, imu_capacity: int = 64):
        """Per-scan measure groups (the numpy synchronizer)."""
        return replay.sync_measures(self.scan_stamps, self.imu, self.gnss,
                                    imu_capacity=imu_capacity)


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
