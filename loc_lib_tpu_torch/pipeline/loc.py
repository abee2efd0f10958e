"""Loc: localization against a prior global map (port of
loc_lib_tpu/pipeline/loc.py).

The global map is one padded cloud on the device. A box crop around the
current pose (`crop_local_map`: box mask + stable compaction to a fixed
capacity) becomes the matcher's target (voxel-plane ICP or direct NDT).
Per scan, `step` predicts the pose (ESKF nominal or constant velocity),
matches the scan against the crop, fuses the matched pose into the ESKF and
tests whether the pose came within `recrop_margin` of the box edge. The
stateful wrapper `Loc` reads that flag back with the pose (one pull per scan)
and re-crops on the host when it is set; the crop origin is snapped to the
voxel grid, so successive crops give the same voxel partition.

Unlike LIO there is no first-frame special case: the map exists before the
first scan, so the ESKF observes from the first scan on and the health
monitor counts every frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.pointcloud import PointCloud, PAD_COORD, card_device, from_numpy
from ..models import icp, ndt, eskf as eskf_mod
from ..utils import lie
from ..utils import health as health_mod


@dataclasses.dataclass(frozen=True)
class LocOptions:
    """Mirror of the JAX package's LocOptions (same names and defaults).
    `scan_filter_leaf` and `scan_capacity` are set by io/config.py and the
    matching app and read by nothing on the engine path, as in JAX: scans
    are matched at the capacity they come with."""

    matcher: str = "icp"                # icp | ndt
    icp: icp.IcpOptions = icp.IcpOptions(method="p2plane_vox")
    ndt: ndt.NdtOptions = ndt.NdtOptions()
    box_size: float = 150.0             # cube edge of the crop (m)
    recrop_margin: float = 50.0         # re-crop when this close to an edge
    scan_filter_leaf: float = 1.0
    scan_capacity: int = 8192
    local_map_capacity: int = 131072
    with_eskf: bool = True


class LocState(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    last_R: torch.Tensor
    last_t: torch.Tensor
    icp_target: Optional[icp.IcpTarget]
    ndt_map: Optional[ndt.NdtMap]
    map_center: torch.Tensor     # (3,) center of the current box crop
    eskf: eskf_mod.EskfState
    R_il: torch.Tensor
    t_il: torch.Tensor
    initialized: bool            # pose seeded (host flag)


class StepResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    converged: torch.Tensor
    num_effective: torch.Tensor
    chi2: torch.Tensor
    need_recrop: torch.Tensor    # () bool: the pose is near the box edge


def _check_matcher(opts: LocOptions):
    if opts.matcher not in ("icp", "ndt"):
        raise ValueError(f"unknown matcher {opts.matcher!r}")


def crop_local_map(map_xyz: torch.Tensor, map_mask: torch.Tensor, center: torch.Tensor,
                   half_size: float, capacity: int) -> PointCloud:
    """Box-crop the global map around `center` into min(capacity, map
    rows) rows: points inside the box first, in map order (stable)."""
    inside = map_mask & torch.all(torch.abs(map_xyz - center) <= half_size, dim=-1)
    order = torch.argsort((~inside).to(torch.int32), stable=True)[:capacity]
    mask = inside[order]
    return PointCloud(xyz=torch.where(mask[:, None], map_xyz[order], PAD_COORD), mask=mask)


def snap_origin(opts: LocOptions, center: torch.Tensor) -> torch.Tensor:
    """The target origin of a crop around `center`: snapped down to the
    matcher's voxel grid on the device. Floor binning is shift-invariant
    under whole-leaf shifts, so successive crops give the same voxel
    partition."""
    leaf = opts.icp.grid_leaf if opts.matcher == "icp" else opts.ndt.voxel_size
    return torch.floor(center / leaf) * leaf


def _build_target(opts: LocOptions, local_map: PointCloud, origin) -> dict:
    if opts.matcher == "icp":
        return {"icp_target": icp.set_target(local_map, opts.icp, origin)}
    return {"ndt_map": ndt.build_direct(local_map, opts.ndt, origin)}


def init_state(opts: LocOptions, R_il=None, t_il=None, *, device) -> LocState:
    """Fresh state on `device`, the target built over an empty crop."""
    _check_matcher(opts)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    z3 = torch.zeros((3,), dtype=torch.float32, device=device)
    cap = opts.local_map_capacity
    empty = PointCloud(xyz=torch.full((cap, 3), PAD_COORD, dtype=torch.float32, device=device),
                       mask=torch.zeros((cap,), dtype=torch.bool, device=device))
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    st = LocState(R=eye, t=z3, last_R=eye, last_t=z3, icp_target=None, ndt_map=None,
                  map_center=z3, eskf=eskf_mod.init_state(device=device),
                  R_il=eye if R_il is None else f32(R_il),
                  t_il=z3 if t_il is None else f32(t_il),
                  initialized=False)
    return st._replace(**_build_target(opts, empty, z3))


def step(state: LocState, scan: PointCloud, opts: LocOptions, match=None):
    """One scan: predict, match against the crop, fuse, box-edge test.
    `match(scan, R0, t0)`, when given, replaces the match against the
    state's target (the sharded Loc's distributed match)."""
    _check_matcher(opts)
    if opts.with_eskf:
        Ri, ti = eskf_mod.nominal_se3(state.eskf)
        R0, t0 = lie.se3_compose(Ri, ti, state.R_il, state.t_il)
    else:
        dR, dt = lie.se3_compose(state.R, state.t, *lie.se3_inverse(state.last_R, state.last_t))
        R0, t0 = lie.se3_compose(dR, dt, state.R, state.t)

    if match is not None:
        res = match(scan, R0, t0)
    elif opts.matcher == "icp":
        res = icp.scan_match(state.icp_target, opts.icp, scan, R0, t0)
    else:
        res = ndt.scan_match(state.ndt_map, opts.ndt, scan, R0, t0)

    R_new, t_new = res.R, res.t
    new_eskf = state.eskf
    if opts.with_eskf:
        Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
        R_imu, t_imu = lie.se3_compose(R_new, t_new, Ril_inv, til_inv)
        new_eskf = eskf_mod.observe_se3(state.eskf, R_imu, t_imu, eskf_mod.EskfOptions())
        Ri, ti = eskf_mod.nominal_se3(new_eskf)
        R_new, t_new = lie.se3_compose(Ri, ti, state.R_il, state.t_il)

    # box-edge proximity test
    dist_to_edge = opts.box_size / 2.0 - torch.max(torch.abs(t_new - state.map_center))
    need_recrop = dist_to_edge < opts.recrop_margin
    state = state._replace(last_R=state.R, last_t=state.t, R=R_new, t=t_new, eskf=new_eskf)
    return state, StepResult(R=R_new, t=t_new, converged=res.converged,
                             num_effective=res.num_effective, chi2=res.chi2,
                             need_recrop=need_recrop)


def predict_imu(state: LocState, gyro, acce, timestamp) -> LocState:
    """One IMU sample through the ESKF."""
    dev = state.t.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)
    opts = eskf_mod.EskfOptions()
    return state._replace(eskf=eskf_mod.predict(
        state.eskf, f32(gyro), f32(acce), f32(timestamp), opts,
        eskf_mod.process_noise(opts, dev)))


def step_measure(state: LocState, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                 imu_valid, opts: LocOptions, match=None):
    """One measure group: ESKF-predict through the padded IMU packet, then
    `step`."""
    new_eskf = eskf_mod.predict_scan(state.eskf, imu_gyro, imu_acce, imu_stamp, imu_valid,
                                     eskf_mod.EskfOptions())
    return step(state._replace(eskf=new_eskf), scan, opts, match)


def set_init_pose(state: LocState, R, t) -> LocState:
    """Seed the pose and the ESKF nominal."""
    dev = state.t.device
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
    R_imu, t_imu = lie.se3_compose(R, t, Ril_inv, til_inv)
    return state._replace(R=R, t=t, last_R=R, last_t=t,
                          eskf=eskf_mod.set_pose(state.eskf, R_imu, t_imu), initialized=True)


# ---------------------------------------------------------------------------
# Stateful wrapper
# ---------------------------------------------------------------------------

class Loc:
    """Stateful wrapper: owns the global map on `device`, re-crops the local
    map when a step flags the box edge, records the trajectory and watches
    tracking health (every frame, the first included)."""

    def __init__(self, global_map_xyz: np.ndarray, opts: LocOptions = LocOptions(),
                 R_il=None, t_il=None, *, device=None):
        """`device`: where the global map, the state and the steps live
        (default: the card, see `pointcloud.card_device`; it raises without
        one)."""
        self.opts = opts
        self.device = card_device(device)
        gm = from_numpy(global_map_xyz, device=self.device)
        self.map_xyz = gm.xyz
        self.map_mask = gm.mask
        self.state = init_state(opts, R_il, t_il, device=self.device)
        self.poses: list[np.ndarray] = []
        self.num_recrops = 0                  # box-edge re-crops after the first crop
        # matcher-aware residual gate, as in Lio: NDT's chi2 is
        # information-weighted, so it gets half the NDT outlier gate
        self.health = health_mod.TrackingHealth(
            health_mod.HealthOptions(max_chi2_per_point=10.0)
            if opts.matcher.startswith("ndt") else health_mod.HealthOptions())

    def set_init_pose(self, R, t):
        self.state = set_init_pose(self.state, R, t)
        self.health.reset()
        self._recrop()

    def _recrop(self):
        center = self.state.t
        local = crop_local_map(self.map_xyz, self.map_mask, center, self.opts.box_size / 2.0,
                               self.opts.local_map_capacity)
        self.state = self.state._replace(
            map_center=center, **_build_target(self.opts, local, snap_origin(self.opts, center)))

    def _record(self, out: StepResult):
        # one device-to-host pull per scan
        vals = torch.cat([out.R.reshape(9), out.t.reshape(3),
                          torch.stack([out.need_recrop.to(torch.float32),
                                       out.converged.to(torch.float32),
                                       out.num_effective.to(torch.float32),
                                       out.chi2.to(torch.float32)])]).cpu().numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = vals[:9].reshape(3, 3)
        T[:3, 3] = vals[9:12]
        self.poses.append(T)
        self.health.update(bool(vals[13]), int(vals[14]), float(vals[15]))
        if vals[12] > 0.5:
            self._recrop()
            self.num_recrops += 1

    def update_cloud(self, scan: PointCloud) -> StepResult:
        self.state, out = step(self.state, scan, self.opts)
        self._record(out)
        return out

    def update_imu(self, gyro, acce, timestamp) -> None:
        self.state = predict_imu(self.state, gyro, acce, timestamp)

    def update_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                       imu_valid) -> StepResult:
        """One measure group (IMU packet + scan); same re-crop and record
        handling as update_cloud."""
        self.state, out = step_measure(self.state, scan, imu_gyro, imu_acce, imu_stamp,
                                       imu_valid, self.opts)
        self._record(out)
        return out

    def current_pose(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.state.R.cpu().numpy()
        T[:3, 3] = self.state.t.cpu().numpy()
        return T
