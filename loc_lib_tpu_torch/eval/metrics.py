"""Trajectory evaluation: ATE and RPE (numpy; a copy of
loc_lib_tpu/eval/metrics.py, kept here because the JAX package cannot be
imported without jax).
Conventions follow the TUM RGB-D benchmark definitions."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class AteResult(NamedTuple):
    rmse: float
    mean: float
    median: float
    max: float
    trans_errors: np.ndarray   # (T,) per-frame translation error after alignment


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (optionally similarity) alignment src -> dst.
    src/dst: (T, 3). Returns (R, t, s)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float((D * S.diagonal()).sum() / max(xs.var(0).sum(), 1e-12)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> AteResult:
    """Absolute trajectory error. est/gt: (T, 4, 4), index-associated."""
    p_est = np.asarray(est_poses)[:, :3, 3]
    p_gt = np.asarray(gt_poses)[:, :3, 3]
    if align and len(p_est) >= 3:
        R, t, s = umeyama_alignment(p_est, p_gt)
        p_est = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return AteResult(
        rmse=float(np.sqrt(np.mean(err ** 2))),
        mean=float(np.mean(err)),
        median=float(np.median(err)),
        max=float(np.max(err)),
        trans_errors=err,
    )


class RpeResult(NamedTuple):
    trans_rmse: float
    rot_rmse_deg: float
    trans_errors: np.ndarray
    rot_errors_deg: np.ndarray


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1) -> RpeResult:
    """Relative pose error over frame gaps of `delta`."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    te, re = [], []
    for i in range(len(est) - delta):
        d_est = np.linalg.inv(est[i]) @ est[i + delta]
        d_gt = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(d_gt) @ d_est
        te.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        re.append(np.degrees(np.arccos(c)))
    te, re = np.asarray(te), np.asarray(re)
    return RpeResult(
        trans_rmse=float(np.sqrt(np.mean(te ** 2))) if len(te) else 0.0,
        rot_rmse_deg=float(np.sqrt(np.mean(re ** 2))) if len(re) else 0.0,
        trans_errors=te,
        rot_errors_deg=re,
    )
