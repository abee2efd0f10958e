"""Trajectory evaluation: ATE (numpy; copy of loc_lib_tpu/eval/metrics.py's
ATE, kept here because the JAX package cannot be imported without jax).
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
