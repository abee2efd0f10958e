"""LIO: keyframe LiDAR-inertial odometry and local mapping (port of
loc_lib_tpu/pipeline/lio.py for the matchers icp, icp_vox_inc, ndt, ndt_inc
and loam).

One scan in, updated state + pose out: ESKF prediction through the measure
group's IMU packet, Gauss-Newton scan match against the matcher's target,
ESKF fusion of the matched pose, keyframe decision, and on a keyframe the
target update:
  * icp: ring-buffer local-map rebuild (transform, concat, voxel filter,
    budget compaction, voxel-plane target build);
  * ndt: the same local map, built into a direct NDT map;
  * ndt_inc: the new keyframe absorbed into the incremental NDT table;
  * icp_vox_inc: the new keyframe (downsampled) absorbed into a floor-binned
    moment table, from which the voxel-plane target is re-derived; every
    `vox_inc_reanchor`-th keyframe the table is rebuilt from the window;
  * loam: twin ring buffers (surf features in kf_*, edge features in
    kf_edge_*), two local maps, a line target over the edges and a plane
    target over the surfs (`step(..., edge_scan=...)`).
JAX's on-device `lax.cond` branches (keyframe, re-anchor) become host
branches on a flag read back once per scan and on the host int `num_kfs`.

Keyframe clouds are stored in the lidar frame and re-transformed by their
world poses at every rebuild, as in the reference.

The wrapper `Lio` records poses sequentially or, with `pipelined=True`, one
scan late (the previous scan's pose pull after the current scan's step), and
takes a pose-graph correction (`apply_correction`, the 3D SLAM write-back).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.pointcloud import PointCloud, PAD_COORD, card_device
from ..ops import voxel as voxel_ops
from ..models import icp, ndt, loam, eskf as eskf_mod
from ..utils import lie
from ..utils import health as health_mod


@dataclasses.dataclass(frozen=True)
class LioOptions:
    """Mirror of the JAX package's LioOptions."""

    matcher: str = "icp"              # icp | icp_vox_inc | ndt | ndt_inc | loam
    icp: icp.IcpOptions = icp.IcpOptions()
    ndt: ndt.NdtOptions = ndt.NdtOptions()
    loam: loam.LoamOption = loam.LoamOption()
    kf_distance: float = 0.5          # keyframe translation gate (m)
    kf_angle_deg: float = 30.0        # keyframe rotation gate (deg)
    num_kfs_in_local_map: int = 10
    scan_filter_leaf: float = 1.0
    map_filter_leaf: float = 0.5
    scan_capacity: int = 8192         # padded points per filtered scan
    imu_capacity: int = 64            # padded IMU samples per measure group
    with_eskf: bool = True
    # matcher="icp_vox_inc": every Nth accepted keyframe, rebuild the moment
    # table from the keyframe window at the current poses instead of
    # absorbing only the new scan (0: absorb only)
    vox_inc_reanchor: int = 5
    # static row budget of the assembled local map as a fraction of the
    # window's raw capacity; overflow is counted in LioState.map_overflow
    local_map_budget_factor: float = 0.625

    @property
    def local_map_capacity(self) -> int:
        return self.num_kfs_in_local_map * self.scan_capacity

    @property
    def local_map_budget(self) -> int:
        cap = self.local_map_capacity
        b = int(cap * self.local_map_budget_factor)
        return min(cap, max(1024, -(-b // 1024) * 1024))

    @property
    def inc_ndt(self) -> ndt.NdtOptions:
        """Moment-table options backing matcher="icp_vox_inc": floor-binned
        incremental voxel Gaussians at the ICP grid leaf and dense dims."""
        return dataclasses.replace(
            self.ndt, method="incremental", voxel_size=self.icp.grid_leaf,
            bin_mode="floor", dense_dims=self.icp.dense_dims)

    @property
    def ndt_inc(self) -> ndt.NdtOptions:
        """The NDT options of matcher="ndt_inc"."""
        return dataclasses.replace(self.ndt, method="incremental")


def _check_matcher(opts: LioOptions):
    if opts.matcher in ("icp", "icp_vox_inc", "ndt", "ndt_inc", "loam"):
        return
    raise ValueError(f"unknown matcher {opts.matcher!r}")


class LioState(NamedTuple):
    """Everything the per-scan step needs. Tensors live on one device; the
    two counters the host branches on are host ints."""

    R: torch.Tensor                 # (3, 3) current lidar pose in world
    t: torch.Tensor                 # (3,)
    last_R: torch.Tensor            # previous pose (const-velocity prediction)
    last_t: torch.Tensor
    kf_xyz: torch.Tensor            # (K, N, 3) keyframe ring buffer, lidar frame
    kf_mask: torch.Tensor           # (K, N)
    kf_R: torch.Tensor              # (K, 3, 3) keyframe world poses
    kf_t: torch.Tensor              # (K, 3)
    last_kf_R: torch.Tensor         # pose of the most recent keyframe
    last_kf_t: torch.Tensor
    num_kfs: int                    # keyframes ever accepted
    # matcher target: icp_target (icp), ndt_map (ndt, ndt_inc), both
    # (icp_vox_inc: the moment table and the plane target derived from it),
    # or loam_target (loam)
    icp_target: Optional[icp.IcpTarget]
    ndt_map: Optional[ndt.NdtMap]
    loam_target: Optional[loam.LoamTarget]
    # loam: the edge-feature ring buffer (kf_* holds the surf features)
    kf_edge_xyz: Optional[torch.Tensor]
    kf_edge_mask: Optional[torch.Tensor]
    eskf: eskf_mod.EskfState
    R_il: torch.Tensor              # T_imu_lidar extrinsic
    t_il: torch.Tensor
    frame_idx: int
    map_overflow: torch.Tensor      # () int32 points dropped at the last compaction


class StepResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    is_keyframe: bool
    converged: torch.Tensor
    num_effective: torch.Tensor
    iterations: int
    chi2: torch.Tensor


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def init_state(opts: LioOptions, R_il=None, t_il=None, *, device) -> LioState:
    """Fresh state on `device`, with the matcher target pre-built from an
    empty budget-sized cloud or an empty table (the reference's fixed-shape
    start)."""
    _check_matcher(opts)
    k, n = opts.num_kfs_in_local_map, opts.scan_capacity
    eye = torch.eye(3, dtype=torch.float32, device=device)
    z3 = torch.zeros((3,), dtype=torch.float32, device=device)
    icp_target, ndt_map, loam_target = None, None, None
    if opts.matcher == "icp":
        icp_target = icp.set_target(_empty_map_cloud(opts, device), opts.icp)
    elif opts.matcher == "icp_vox_inc":
        if opts.icp.method != "p2plane_vox":
            raise ValueError("matcher='icp_vox_inc' needs icp.method='p2plane_vox', "
                             f"got {opts.icp.method!r}")
        ndt_map = ndt.empty_incremental(opts.inc_ndt, device=device)
        icp_target = _derive_vox_target(opts, ndt_map)
    elif opts.matcher == "ndt":
        ndt_map = ndt.build_direct(_empty_map_cloud(opts, device), opts.ndt)
    elif opts.matcher == "ndt_inc":
        ndt_map = ndt.empty_incremental(opts.ndt_inc, device=device)
    else:
        empty = _empty_map_cloud(opts, device)
        loam_target = loam.set_target(empty, empty, opts.loam)
    is_loam = opts.matcher == "loam"
    return LioState(
        R=eye, t=z3, last_R=eye, last_t=z3,
        kf_xyz=torch.full((k, n, 3), PAD_COORD, dtype=torch.float32, device=device),
        kf_mask=torch.zeros((k, n), dtype=torch.bool, device=device),
        kf_R=eye.expand(k, 3, 3).clone(),
        kf_t=torch.zeros((k, 3), dtype=torch.float32, device=device),
        last_kf_R=eye, last_kf_t=z3,
        num_kfs=0,
        icp_target=icp_target,
        ndt_map=ndt_map,
        loam_target=loam_target,
        kf_edge_xyz=torch.full((k, n, 3), PAD_COORD, dtype=torch.float32, device=device)
        if is_loam else None,
        kf_edge_mask=torch.zeros((k, n), dtype=torch.bool, device=device) if is_loam else None,
        eskf=eskf_mod.init_state(device=device),
        R_il=eye if R_il is None else _f32(R_il, device),
        t_il=z3 if t_il is None else _f32(t_il, device),
        frame_idx=0,
        map_overflow=torch.zeros((), dtype=torch.int32, device=device),
    )


def _derive_vox_target(opts: LioOptions, m: ndt.NdtMap) -> icp.IcpTarget:
    return icp.target_from_moment_table(m.keys, m.count, m.mean, m.cov, m.dense_table,
                                        m.dense_lo, m.origin, opts.icp, opts.icp.dense_dims)


def _empty_map_cloud(opts: LioOptions, device) -> PointCloud:
    m = opts.local_map_budget
    return PointCloud(xyz=torch.full((m, 3), PAD_COORD, dtype=torch.float32, device=device),
                      mask=torch.zeros((m,), dtype=torch.bool, device=device))


# ---------------------------------------------------------------------------
# Pieces of the step
# ---------------------------------------------------------------------------

def _is_keyframe(opts: LioOptions, state: LioState, R, t) -> bool:
    """Relative motion vs the last keyframe (one host read)."""
    if state.num_kfs == 0:
        return True
    dR, dt = lie.se3_compose(*lie.se3_inverse(state.last_kf_R, state.last_kf_t), R, t)
    ang = torch.linalg.vector_norm(lie.so3_log(dR))
    far = (torch.linalg.vector_norm(dt) > opts.kf_distance) | (
        ang > math.radians(opts.kf_angle_deg))
    return bool(far)


def _assemble_local_map(opts: LioOptions, kf_xyz, kf_mask, kf_R, kf_t):
    """Transform the keyframe window to world, concat, voxel-filter, then
    compact the survivors to the static local_map_budget rows.
    Returns (cloud, origin, overflow)."""
    k, n, _ = kf_xyz.shape
    world = torch.einsum("kij,knj->kni", kf_R, kf_xyz) + kf_t[:, None, :]
    world = torch.where(kf_mask[..., None], world, PAD_COORD)
    merged = PointCloud(xyz=world.reshape(k * n, 3), mask=kf_mask.reshape(k * n))
    # re-center the voxel key window on the current map
    origin = torch.sum(kf_t, dim=0) / torch.clamp(
        torch.sum((torch.sum(kf_mask, dim=1) > 0).to(torch.float32)), min=1.0)
    ds = voxel_ops.voxel_downsample(merged, opts.map_filter_leaf, origin=origin)
    budget = opts.local_map_budget
    if budget >= ds.capacity:
        return ds, origin, torch.zeros((), dtype=torch.int32, device=kf_xyz.device)
    order = torch.argsort((~ds.mask).to(torch.int32), stable=True)[:budget]
    mask = ds.mask[order]
    xyz = torch.where(mask[:, None], ds.xyz[order], PAD_COORD)
    overflow = torch.clamp(ds.mask.to(torch.int32).sum() - budget, min=0)
    return PointCloud(xyz=xyz, mask=mask), origin, overflow


def _world_scan(scan_xyz, scan_mask, R, t) -> PointCloud:
    world = torch.where(scan_mask[:, None], scan_xyz @ R.T + t, PAD_COORD)
    return PointCloud(xyz=world, mask=scan_mask)


def _push_keyframe(opts: LioOptions, state: LioState, scan_xyz, scan_mask, R, t,
                   edge: Optional[PointCloud] = None) -> LioState:
    """Insert (scan, pose) into the ring buffer (and, for loam, the edge
    features into theirs) and update the target."""
    slot = state.num_kfs % opts.num_kfs_in_local_map

    def upd(buf, row):
        out = buf.clone()
        out[slot] = row
        return out

    kf_xyz = upd(state.kf_xyz, scan_xyz)
    kf_mask = upd(state.kf_mask, scan_mask)
    kf_R = upd(state.kf_R, R)
    kf_t = upd(state.kf_t, t)
    new = state._replace(kf_xyz=kf_xyz, kf_mask=kf_mask, kf_R=kf_R, kf_t=kf_t,
                         last_kf_R=R, last_kf_t=t, num_kfs=state.num_kfs + 1)
    if opts.matcher == "icp":
        local_map, origin, ovf = _assemble_local_map(opts, kf_xyz, kf_mask, kf_R, kf_t)
        return new._replace(icp_target=icp.set_target(local_map, opts.icp, origin),
                            map_overflow=ovf)
    if opts.matcher == "ndt":
        local_map, origin, ovf = _assemble_local_map(opts, kf_xyz, kf_mask, kf_R, kf_t)
        return new._replace(ndt_map=ndt.build_direct(local_map, opts.ndt, origin),
                            map_overflow=ovf)
    if opts.matcher == "loam":
        kf_edge_xyz = upd(state.kf_edge_xyz, edge.xyz)
        kf_edge_mask = upd(state.kf_edge_mask, edge.mask)
        surf_map, origin, ovf_s = _assemble_local_map(opts, kf_xyz, kf_mask, kf_R, kf_t)
        edge_map, _, ovf_e = _assemble_local_map(opts, kf_edge_xyz, kf_edge_mask, kf_R, kf_t)
        return new._replace(kf_edge_xyz=kf_edge_xyz, kf_edge_mask=kf_edge_mask,
                            loam_target=loam.set_target(edge_map, surf_map, opts.loam, origin),
                            map_overflow=ovf_s + ovf_e)
    if opts.matcher == "ndt_inc":
        # incremental NDT absorbs only the new keyframe
        return new._replace(ndt_map=ndt.update_incremental(
            new.ndt_map, _world_scan(scan_xyz, scan_mask, R, t), opts.ndt_inc))
    # icp_vox_inc: absorb the new keyframe, downsampled at the local-map leaf
    # as the batch path feeds set_target; every vox_inc_reanchor-th keyframe
    # rebuild the table from the window at the current poses instead, with
    # the key window re-centred on the window's origin
    if opts.vox_inc_reanchor > 0 and new.num_kfs % opts.vox_inc_reanchor == 0:
        local_map, origin, _ = _assemble_local_map(opts, kf_xyz, kf_mask, kf_R, kf_t)
        m2 = ndt.update_incremental(ndt.empty_incremental(opts.inc_ndt, origin=origin),
                                    local_map, opts.inc_ndt)
    else:
        scan_w = voxel_ops.voxel_downsample(_world_scan(scan_xyz, scan_mask, R, t),
                                            opts.map_filter_leaf, origin=t)
        m2 = ndt.update_incremental(new.ndt_map, scan_w, opts.inc_ndt)
    return new._replace(ndt_map=m2, icp_target=_derive_vox_target(opts, m2))


def _align(opts: LioOptions, state: LioState, src: PointCloud, R0, t0,
           edge_src: Optional[PointCloud] = None):
    if opts.matcher in ("icp", "icp_vox_inc"):
        return icp.scan_match(state.icp_target, opts.icp, src, R0, t0)
    if opts.matcher == "loam":
        return loam.scan_match(state.loam_target, opts.loam, edge_src, src, R0, t0)
    if opts.matcher == "ndt":
        return ndt.scan_match(state.ndt_map, opts.ndt, src, R0, t0)
    return ndt.scan_match(state.ndt_map, opts.ndt_inc, src, R0, t0)


def _predict_pose(opts: LioOptions, state: LioState):
    """ESKF path: T_w_l = T_w_i * T_i_l from the filter nominal.
    Pure-lidar path: constant velocity, cur * last^-1 * cur."""
    if opts.with_eskf:
        Ri, ti = eskf_mod.nominal_se3(state.eskf)
        return lie.se3_compose(Ri, ti, state.R_il, state.t_il)
    dR, dt = lie.se3_compose(state.R, state.t, *lie.se3_inverse(state.last_R, state.last_t))
    return lie.se3_compose(dR, dt, state.R, state.t)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def step(state: LioState, scan: PointCloud, opts: LioOptions,
         edge_scan: Optional[PointCloud] = None):
    """One scan in, updated state + pose out. `scan` must already be
    voxel-filtered to `opts.scan_capacity` rows; for matcher="loam" pass
    the surf features as `scan` and the edge features as `edge_scan`."""
    _check_matcher(opts)
    if (opts.matcher == "loam") != (edge_scan is not None):
        raise ValueError("edge_scan is required for matcher='loam' and only for it")
    first = state.frame_idx == 0
    if first:
        # first scan: identity pose (the match still runs, against the empty
        # target, so StepResult carries the same fields as every later scan)
        R0 = torch.eye(3, dtype=torch.float32, device=scan.device)
        t0 = torch.zeros(3, dtype=torch.float32, device=scan.device)
    else:
        R0, t0 = _predict_pose(opts, state)

    res = _align(opts, state, scan, R0, t0, edge_src=edge_scan)
    R_new, t_new = (R0, t0) if first else (res.R, res.t)

    new_eskf = state.eskf
    if opts.with_eskf and not first:
        # observe the matched LIDAR pose as an IMU-frame pose, take the
        # nominal back
        Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
        R_imu, t_imu = lie.se3_compose(R_new, t_new, Ril_inv, til_inv)
        new_eskf = eskf_mod.observe_se3(state.eskf, R_imu, t_imu, eskf_mod.EskfOptions())
        Ri, ti = eskf_mod.nominal_se3(new_eskf)
        R_new, t_new = lie.se3_compose(Ri, ti, state.R_il, state.t_il)

    state = state._replace(last_R=state.R, last_t=state.t, R=R_new, t=t_new,
                           eskf=new_eskf, frame_idx=state.frame_idx + 1)
    is_kf = _is_keyframe(opts, state, R_new, t_new)
    if is_kf:
        state = _push_keyframe(opts, state, scan.xyz, scan.mask, R_new, t_new, edge_scan)
    return state, StepResult(R=R_new, t=t_new, is_keyframe=is_kf,
                             converged=res.converged,
                             num_effective=res.num_effective,
                             iterations=res.iterations, chi2=res.chi2)


def step_measure(state: LioState, scan: PointCloud, imu_gyro, imu_acce,
                 imu_stamp, imu_valid, opts: LioOptions,
                 edge_scan: Optional[PointCloud] = None):
    """ESKF-predict through the measure group's padded IMU packet, then
    `step`."""
    new_eskf = eskf_mod.predict_scan(state.eskf, imu_gyro, imu_acce, imu_stamp,
                                     imu_valid, eskf_mod.EskfOptions())
    return step(state._replace(eskf=new_eskf), scan, opts, edge_scan=edge_scan)


def preprocess_scan(opts: LioOptions, xyz: torch.Tensor, mask: torch.Tensor) -> PointCloud:
    """Voxel-filter a raw padded scan down to `scan_capacity` rows."""
    pc = PointCloud(xyz=xyz, mask=mask)
    # center the downsample key window on the scan so far returns survive
    centroid = torch.sum(torch.where(mask[:, None], xyz, 0.0), dim=0) / torch.clamp(
        torch.sum(mask.to(torch.float32)), min=1.0)
    ds = voxel_ops.voxel_downsample(pc, opts.scan_filter_leaf, origin=centroid)
    n = opts.scan_capacity
    if ds.capacity < n:
        raise ValueError("scan capacity exceeds raw capacity")
    order = torch.argsort((~ds.mask).to(torch.int32), stable=True)[:n]
    return PointCloud(xyz=ds.xyz[order], mask=ds.mask[order])


# ---------------------------------------------------------------------------
# Stateful wrapper
# ---------------------------------------------------------------------------

class ImuStaticInit:
    """Buffers IMU samples until a stationary window of init_time_seconds
    passes the variance gates, then returns the seeded EskfState once."""

    def __init__(self, *, device):
        self.device = device
        self.buffer: list[tuple[float, np.ndarray, np.ndarray]] = []

    def add(self, gyro, acce, timestamp):
        """Returns the seeded EskfState when ready, else None."""
        self.buffer.append((float(timestamp), np.asarray(gyro), np.asarray(acce)))
        if len(self.buffer) < 10:
            return None
        t0, t1 = self.buffer[0][0], self.buffer[-1][0]
        if t1 - t0 < eskf_mod.ImuInitOptions().init_time_seconds:
            return None
        gyros = _f32(np.stack([g for _, g, _ in self.buffer]), self.device)
        acces = _f32(np.stack([a for _, _, a in self.buffer]), self.device)
        valid = torch.ones((gyros.shape[0],), dtype=torch.bool, device=self.device)
        res = eskf_mod.static_imu_init(gyros, acces, valid)
        if not bool(res.success):
            self.buffer.pop(0)
            return None
        return eskf_mod.init_state(bg=res.bg, ba=res.ba, gravity=res.gravity,
                                   time=t1, device=self.device)


class Lio:
    """Stateful wrapper: owns a LioState on `device`, records per-frame and
    keyframe poses, and watches tracking health."""

    def __init__(self, opts: LioOptions = LioOptions(), R_il=None, t_il=None, *,
                 device=None, pipelined: bool = False):
        """`device`: where the state lives and the steps run (default: the
        card, see `pointcloud.card_device`; it raises without one).
        `pipelined=True`: lag-1 results. `add_measure` / `add_cloud`
        return the PREVIOUS scan's StepResult (None on the first call) and
        record it after the current scan's step is enqueued; `flush` drains
        the last one. The recorded poses equal sequential mode's bit for bit:
        nothing a step writes reaches a StepResult already returned (every
        update of the state is out of place). Keep it False where a caller
        uses each scan's result at once (Slam3d does)."""
        self.opts = opts
        self.device = card_device(device)
        self.state = init_state(opts, R_il, t_il, device=self.device)
        self.pipelined = pipelined
        self._pend_out: Optional[StepResult] = None
        self.poses: list[np.ndarray] = []        # per-frame 4x4 T_w_l
        self.kf_poses: list[np.ndarray] = []
        self._imu_init = ImuStaticInit(device=self.device)
        self.imu_inited = not opts.with_eskf
        # matcher-aware residual gate: the NDT matchers report an
        # information-weighted chi2 (Mahalanobis^2 per residual, outlier
        # gate 20), not metric m^2; under the 1.0 default every healthy
        # NDT frame is flagged bad. Half the NDT outlier gate, as in JAX.
        self.health = health_mod.TrackingHealth(
            health_mod.HealthOptions(max_chi2_per_point=10.0)
            if opts.matcher.startswith("ndt") else health_mod.HealthOptions())

    def init_imu(self, gyro, acce, timestamp) -> bool:
        """Feed one stationary IMU sample; True once the filter is seeded."""
        if self.imu_inited:
            return True
        st = self._imu_init.add(gyro, acce, timestamp)
        if st is None:
            return False
        self.state = self.state._replace(eskf=st)
        self.imu_inited = True
        return True

    def add_cloud(self, scan: PointCloud, edge_scan: Optional[PointCloud] = None
                  ) -> Optional[StepResult]:
        """One scan without an IMU packet (the ESKF, if on, is not
        propagated before the match)."""
        self.state, out = step(self.state, scan, self.opts, edge_scan=edge_scan)
        return self._emit(out)

    def add_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                    imu_valid, edge_scan: Optional[PointCloud] = None
                    ) -> Optional[StepResult]:
        self.state, out = step_measure(self.state, scan, imu_gyro, imu_acce,
                                       imu_stamp, imu_valid, self.opts, edge_scan=edge_scan)
        return self._emit(out)

    def _emit(self, out: StepResult) -> Optional[StepResult]:
        if not self.pipelined:
            self._record(out)
            return out
        prev, self._pend_out = self._pend_out, out
        if prev is not None:
            self._record(prev)
        return prev

    def flush(self) -> Optional[StepResult]:
        """Record and return the pipelined tail (None in sequential mode)."""
        out, self._pend_out = self._pend_out, None
        if out is not None:
            self._record(out)
        return out

    def apply_correction(self, dR, dt) -> None:
        """Left-multiply every live world pose by the SE(3) correction
        T_corr = (dR, dt): the current and previous pose, the last
        keyframe's, every keyframe of the window, and the ESKF nominal
        (R, p, v; gravity stays). The pose-graph back-end snaps the front
        end onto the optimized trajectory with it. The matcher's target is
        left as it is, as in the reference; the next keyframe rebuilds it
        from the corrected window."""
        dR = _f32(dR, self.device)
        dt = _f32(dt, self.device)
        s = self.state
        fix = lambda R, t: lie.se3_compose(dR, dt, R, t)
        R, t = fix(s.R, s.t)
        last_R, last_t = fix(s.last_R, s.last_t)
        lk_R, lk_t = fix(s.last_kf_R, s.last_kf_t)
        kf_R, kf_t = fix(s.kf_R, s.kf_t)
        e = s.eskf._replace(R=dR @ s.eskf.R, p=s.eskf.p @ dR.T + dt, v=s.eskf.v @ dR.T)
        self.state = s._replace(R=R, t=t, last_R=last_R, last_t=last_t, kf_R=kf_R, kf_t=kf_t,
                                last_kf_R=lk_R, last_kf_t=lk_t, eskf=e)

    def _record(self, out: StepResult):
        # one device-to-host pull per scan
        vals = torch.cat([out.R.reshape(9), out.t.reshape(3),
                          torch.stack([out.converged.to(torch.float32),
                                       out.num_effective.to(torch.float32),
                                       out.chi2.to(torch.float32)])]).cpu().numpy()
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = vals[:9].reshape(3, 3)
        T[:3, 3] = vals[9:12]
        self.poses.append(T)
        if out.is_keyframe:
            self.kf_poses.append(T)
        if len(self.poses) > 1:  # frame 0 does no matching
            self.health.update(bool(vals[12]), int(vals[13]), float(vals[14]))

    def local_map(self) -> np.ndarray:
        s = self.state
        world = np.einsum("kij,knj->kni", s.kf_R.cpu().numpy(), s.kf_xyz.cpu().numpy()) \
            + s.kf_t.cpu().numpy()[:, None, :]
        return world[s.kf_mask.cpu().numpy()]

    def keyframe_poses(self) -> np.ndarray:
        return np.stack(self.kf_poses) if self.kf_poses else np.zeros((0, 4, 4))
