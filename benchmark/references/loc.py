"""Plain reference of the Loc engine's context: the crop centres that the
reported poses lead to, the crop of the prior map and its target, and the
filter's initial state at the given pose. Imports nothing of the program."""

from __future__ import annotations

import numpy as np
import torch

from yardstick import reference as ref

FIRST_SCAN_UNMATCHED = False


def context(run) -> list:
    """Per scan ordinal, the centre of the crop it was matched against: the
    initial pose's position, then, after any scan whose reported position is
    further than box_size / 2 - recrop_margin from the centre (inf-norm),
    that position."""
    e = run.cfg["engine_options"]
    reach = e["box_size"] / 2.0 - e["recrop_margin"]
    c = tuple(float(x) for x in run.first_pose[:3, 3].astype(np.float32))
    out = []
    for sc in run.scans:
        out.append(c)
        t = sc.pose[:3, 3].astype(np.float64)
        if np.max(np.abs(t - np.asarray(c))) > reach:
            c = tuple(float(x) for x in t)
    return out


def build(ck, center: tuple) -> ref.Target:
    """The target over the prior map's points inside the box of box_size
    about `center` (in map order, at most local_map_capacity of them),
    binned about the centre snapped down to the grid."""
    e, p, dev = ck.e, ck.prec, ck.device
    m = p.t(ck.run.prior_map, dev)
    c = p.t(center, dev)
    crop = m[torch.all(torch.abs(m - c) <= e["box_size"] / 2.0, dim=1)][:e["local_map_capacity"]]
    origin = torch.floor(c / e["grid_leaf"]) * e["grid_leaf"]
    return ref.build_target(crop, origin, p, e["grid_leaf"], tuple(e["dense_dims"]),
                            e["plane_min_pts"], e["plane_fit_eps"])


def initial_state(ck) -> ref.Eskf:
    """At rest at the given initial pose, no biases, gravity 9.8 m/s^2 down,
    covariance 1e-4 I, time 0."""
    p = ck.prec
    T = ck.run.first_pose.astype(np.float32).astype(np.float64)
    z = torch.zeros(3, dtype=torch.float64)
    return ref.Eskf(*(x.to(p.dtype) for x in (
        torch.from_numpy(T[:3, 3]), z, torch.from_numpy(T[:3, :3]), z, z,
        torch.tensor([0.0, 0.0, -9.8], dtype=torch.float64),
        torch.eye(18, dtype=torch.float64) * ck.e["eskf"]["init_cov"],
        torch.tensor(0.0, dtype=torch.float64))))
