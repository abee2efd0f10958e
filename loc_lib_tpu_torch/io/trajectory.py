"""Trajectory writers/readers: KITTI and TUM formats (port of
loc_lib_tpu/io/trajectory.py).

The reference's TUM batch writer writes one unrelated timestamp for every
row; these write the real per-pose stamps. Readers serve the eval stack.
These functions turn numpy into a file and back: the quaternion helpers run
on CPU tensors, in float32 as the JAX package runs them, so writing a file
costs no round trip through the card and prints the same digits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import lie


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def save_kitti(path: str, poses: np.ndarray) -> None:
    """poses: (T, 4, 4) -> KITTI rows (3x4 row-major). Formats in the
    native runtime when available (io/native.py)."""
    poses = np.asarray(poses)
    from . import native

    raw = native.format_kitti(poses) if len(poses) else None
    if raw is not None:
        with open(path, "wb") as f:
            f.write(raw)
        return
    rows = poses[:, :3, :].reshape(len(poses), 12)
    np.savetxt(path, rows, fmt="%.9g")


def load_kitti(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (len(rows), 1, 1))
    out[:, :3, :] = rows
    return out


def save_tum(path: str, stamps: np.ndarray, poses: np.ndarray) -> None:
    """TUM rows: `t x y z qx qy qz qw`."""
    poses = np.asarray(poses)
    q = lie.quat_from_rotm(_f32(poses[:, :3, :3])).numpy()   # (T, 4) wxyz
    with open(path, "w") as f:
        for i in range(len(poses)):
            t = poses[i, :3, 3]
            f.write(
                f"{stamps[i]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )


def load_tum(path: str):
    rows = np.loadtxt(path).reshape(-1, 8)
    stamps = rows[:, 0]
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, 3] = rows[:, 1:4]
    q_wxyz = np.concatenate([rows[:, 7:8], rows[:, 4:7]], axis=1)
    poses[:, :3, :3] = lie.rotm_from_quat(_f32(q_wxyz)).numpy()
    return stamps, poses


def interp_pose(stamps: np.ndarray, poses: np.ndarray, query_time: float,
                time_th: float = 0.5):
    """SE(3) pose interpolation over a timestamped pose buffer (the
    reference's `math::PoseInterp`): rotation slerped, translation lerped
    between the straddling poses. Queries past the last stamp within
    `time_th` return the last pose; outside the buffer returns None.
    `poses` is (T, 4, 4); stamps ascending."""
    stamps = np.asarray(stamps, np.float64)
    poses = np.asarray(poses)
    if len(stamps) == 0:
        return None
    if query_time > stamps[-1]:
        return poses[-1].copy() if query_time < stamps[-1] + time_th else None
    if query_time < stamps[0]:
        return None
    i = int(np.searchsorted(stamps, query_time, side="right") - 1)
    i = min(max(i, 0), len(stamps) - 2) if len(stamps) > 1 else 0
    dt = stamps[i + 1] - stamps[i] if len(stamps) > 1 else 0.0
    if abs(dt) < 1e-6:
        return poses[i].copy()
    s = float((query_time - stamps[i]) / dt)
    qa = lie.quat_from_rotm(_f32(poses[i, :3, :3]))
    qb = lie.quat_from_rotm(_f32(poses[i + 1, :3, :3]))
    R = lie.rotm_from_quat(lie.quat_slerp(qa, qb, s)).numpy()
    T = np.eye(4, dtype=poses.dtype)
    T[:3, :3] = R
    T[:3, 3] = poses[i, :3, 3] * (1.0 - s) + poses[i + 1, :3, 3] * s
    return T
