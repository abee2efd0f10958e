"""Plain reference of the LIO engine's context: the keyframe decisions, the
keyframe window's local map and its target, and the static IMU
initialisation. Imports nothing of the program; what the program derived is
worked out again here from the raw scans and the poses it reported.

Where a back end corrected the front end (`run.corrections`), the
keyframe poses the program held were moved with it: the last keyframe's
pose that the keyframe test reads, and the window's poses that the next
keyframe's target is built from (a correction leaves the target already
built as it is)."""

from __future__ import annotations

import math

import numpy as np
import torch

from yardstick import reference as ref

FIRST_SCAN_UNMATCHED = True      # the first scan seeds the map at the identity


def keyframes(run) -> list:
    """Per scan ordinal, whether the engine takes it as a keyframe: the
    first scan, then any scan whose reported pose is more than kf_distance
    or kf_angle_deg from the last keyframe's (as the corrections since have
    moved it)."""
    e = run.cfg["engine_options"]
    corr = run.corrections
    out, last = [], None
    for i, sc in enumerate(run.scans):
        T = sc.pose.astype(np.float64)
        if last is None:
            kf = True
        else:
            dR = last[:3, :3].T @ T[:3, :3]
            ang = math.acos(min(1.0, max(-1.0, (np.trace(dR) - 1.0) / 2.0)))
            kf = (np.linalg.norm(T[:3, 3] - last[:3, 3]) > e["kf_distance"]
                  or ang > math.radians(e["kf_angle_deg"]))
        out.append(kf)
        if kf:
            last = T
        if len(corr):
            last = corr.between(i, i + 1) @ last
    return out


def context(run) -> list:
    """Per scan ordinal, the keyframes (ordinals) its target was built from:
    the last num_kfs_in_local_map keyframes before it."""
    k = run.cfg["engine_options"]["num_kfs_in_local_map"]
    ring, out = [], []
    for i, kf in enumerate(keyframes(run)):
        out.append(tuple(ring[-k:]))
        if kf:
            ring.append(i)
    return out


def local_map_budget(e: dict) -> int:
    cap = e["num_kfs_in_local_map"] * e["scan_capacity"]
    return min(cap, max(1024, -(-int(cap * e["local_map_budget_factor"]) // 1024) * 1024))


def build(ck, ring: tuple) -> ref.Target:
    """The target over the keyframes `ring`, built at the step of its last:
    each keyframe's filtered scan at its reported pose, moved by the
    corrections that came between its step and that one, merged,
    voxel-filtered about the keyframe positions' mean, the first
    local_map_budget points in key order, then the voxel planes."""
    e, p, dev = ck.e, ck.prec, ck.device
    if not ring:
        return ref.empty_target(p, dev, e["dense_dims"])
    corr = ck.run.corrections
    pts, ts = [], []
    for j in ring:
        pose = ck.run.scans[j].pose
        if len(corr):
            pose = corr.between(j, ring[-1]) @ pose.astype(np.float64)
        T = p.t(pose, dev)
        pts.append(p.mm(ck.filtered(ck.run.scans[j].src), T[:3, :3].T) + T[:3, 3])
        ts.append(T[:3, 3])
    origin = torch.stack(ts).mean(dim=0)
    local = ref.voxel_filter(torch.cat(pts), origin, e["map_filter_leaf"], local_map_budget(e))
    return ref.build_target(local, origin, p, e["grid_leaf"], tuple(e["dense_dims"]),
                            e["plane_min_pts"], e["plane_fit_eps"])


def initial_state(ck) -> ref.Eskf:
    """The static initialisation over the stationary IMU window: samples are
    buffered until they span init_time_s (and number at least 10); then the
    gyro bias is their mean rate, gravity is -9.81 m/s^2 along their mean
    specific force, the accelerometer bias the mean of the rest; the filter
    starts at rest at the identity, covariance 1e-4 I, at the last sample's
    stamp."""
    p, e = ck.prec, ck.e
    stamps, gyro, acce = ck.run.static
    init_s = e["imu_init_time_s"]
    for n in range(1, len(stamps) + 1):
        if n < 10 or float(stamps[n - 1]) - float(stamps[0]) < init_s:
            continue
        g = torch.from_numpy(gyro[:n]).to(torch.float64)
        a = torch.from_numpy(acce[:n]).to(torch.float64)
        grav = -a.mean(dim=0) / torch.linalg.vector_norm(a.mean(dim=0)) * e["gravity_norm"]
        z = torch.zeros(3, dtype=torch.float64)
        return ref.Eskf(*(x.to(p.dtype) for x in (
            z, z, torch.eye(3, dtype=torch.float64), g.mean(dim=0), (a + grav).mean(dim=0), grav,
            torch.eye(18, dtype=torch.float64) * e["eskf"]["init_cov"],
            torch.tensor(float(stamps[n - 1]), dtype=torch.float64))))
    raise RuntimeError("the stationary IMU window is shorter than the initialisation needs")
