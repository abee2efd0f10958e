"""Mapping with the incremental voxel map split over the ranks' map shards
(port of loc_lib_tpu/pipeline/lio_sharded.py).

  * The voxel-Gaussian table is cut into voxel-aligned slabs over the mesh's
    "mp" axis at the FIRST keyframe (`map_shard.build_incremental_sharded`).
    Each shard owns a table of `ndt.map_capacity` voxels, so the mesh holds
    mp * capacity and each rank O(total / mp). The slab bounds stay fixed
    for the map's life: every voxel has one owner, so absorption and
    matching never reconcile across shards.
  * Per scan, on every rank: the ESKF predicts through the IMU packet, the
    distributed NDT match runs (`map_shard.ndt_scan_match_sharded`: source
    rows over "dp", Gaussian table over "mp"; each stencil voxel lives on
    one shard, so the shards' K3 sums just add, one all_reduce SUM per GN
    iteration), the ESKF fuses the pose and the keyframe test runs. The
    test is a host read of replicated values, so all ranks branch alike.
  * On a keyframe each shard absorbs the world-posed scan's points in its
    own slab (`map_shard.update_incremental_sharded`), evicting by age
    within its own table: the distributed twin of `Lio`'s ndt_inc path.

Slab ownership fixed at the first keyframe suits a revisited (loop-shaped)
map. On a trajectory that keeps exploring, most new voxels land in one of
the two outer shards, which fills and age-evicts while the others idle.
Every `imbalance_check_every`-th keyframe the driver reads the (mp,) live
counts (one small all-reduce and pull) and records a warning when the
fullest shard holds more than `imbalance_warn_ratio` times the mean;
`apply_correction` re-derives the slabs from the corrected map.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import eskf as eskf_mod
from ..ops.pointcloud import PointCloud, card_device
from ..parallel import map_shard, mesh as mesh_mod
from ..utils import health as health_mod
from ..utils import lie
from . import lio as lio_mod
from .lio import LioOptions, StepResult


class LioShardedState(NamedTuple):
    """Replicated per-scan state (the sharded map lives outside it); the two
    counters the host branches on are host ints."""

    R: torch.Tensor
    t: torch.Tensor
    last_R: torch.Tensor
    last_t: torch.Tensor
    last_kf_R: torch.Tensor
    last_kf_t: torch.Tensor
    num_kfs: int
    eskf: eskf_mod.EskfState
    R_il: torch.Tensor
    t_il: torch.Tensor
    frame_idx: int


def init_state(R_il=None, t_il=None, *, device) -> LioShardedState:
    eye = torch.eye(3, dtype=torch.float32, device=device)
    z3 = torch.zeros((3,), dtype=torch.float32, device=device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return LioShardedState(
        R=eye, t=z3, last_R=eye, last_t=z3, last_kf_R=eye, last_kf_t=z3, num_kfs=0,
        eskf=eskf_mod.init_state(device=device),
        R_il=eye if R_il is None else f32(R_il), t_il=z3 if t_il is None else f32(t_il),
        frame_idx=0)


def step_measure(mesh: DeviceMesh, sm: map_shard.ShardedNdtMap, state: LioShardedState,
                 scan: PointCloud, imu_gyro, imu_acce, imu_stamp, imu_valid,
                 opts: LioOptions):
    """One measure group against the sharded map (matcher ndt_inc): predict,
    match, fuse, keyframe test. The map absorbs a keyframe separately
    (`update_incremental_sharded`), as only keyframes feed the map."""
    new_eskf = eskf_mod.predict_scan(state.eskf, imu_gyro, imu_acce, imu_stamp, imu_valid,
                                     eskf_mod.EskfOptions())
    state = state._replace(eskf=new_eskf)
    R0, t0 = lio_mod._predict_pose(opts, state)
    res = map_shard.ndt_scan_match_sharded(mesh, sm, opts.ndt_inc, scan, R0, t0)
    R_new, t_new = res.R, res.t
    if opts.with_eskf:
        Ril_inv, til_inv = lie.se3_inverse(state.R_il, state.t_il)
        R_imu, t_imu = lie.se3_compose(R_new, t_new, Ril_inv, til_inv)
        new_eskf = eskf_mod.observe_se3(state.eskf, R_imu, t_imu, eskf_mod.EskfOptions())
        Ri, ti = eskf_mod.nominal_se3(new_eskf)
        R_new, t_new = lie.se3_compose(Ri, ti, state.R_il, state.t_il)
        state = state._replace(eskf=new_eskf)
    state = state._replace(last_R=state.R, last_t=state.t, R=R_new, t=t_new,
                           frame_idx=state.frame_idx + 1)
    is_kf = lio_mod._is_keyframe(opts, state, R_new, t_new)
    if is_kf:
        state = state._replace(last_kf_R=R_new, last_kf_t=t_new, num_kfs=state.num_kfs + 1)
    return state, StepResult(R=R_new, t=t_new, is_keyframe=is_kf, converged=res.converged,
                             num_effective=res.num_effective, iterations=res.iterations,
                             chi2=res.chi2)


def _corrected_state(s: LioShardedState, dR, dt) -> LioShardedState:
    """Every replicated world pose left-multiplied by the correction (dR,
    dt), the ESKF nominal rotated with it: `Lio.apply_correction`'s rules."""
    fix = lambda R, t: lie.se3_compose(dR, dt, R, t)
    R, t = fix(s.R, s.t)
    last_R, last_t = fix(s.last_R, s.last_t)
    lk_R, lk_t = fix(s.last_kf_R, s.last_kf_t)
    e = s.eskf._replace(R=dR @ s.eskf.R, p=s.eskf.p @ dR.T + dt, v=s.eskf.v @ dR.T)
    return s._replace(R=R, t=t, last_R=last_R, last_t=last_t, last_kf_R=lk_R, last_kf_t=lk_t,
                      eskf=e)


def world_scan(scan: PointCloud, R, t) -> PointCloud:
    """The scan moved into the world frame, pads kept far away."""
    return lio_mod._world_scan(scan.xyz, scan.mask, R, t)


class LioSharded:
    """Host driver mirroring `pipeline/lio.Lio` (matcher ndt_inc) with the
    incremental voxel table split over the mesh's "mp" axis. Size the
    per-shard `opts.ndt.map_capacity` so that mp * capacity covers the run;
    `live_voxels_per_shard` shows each shard's fill."""

    imbalance_warn_ratio: float = 3.0
    imbalance_check_every: int = 16

    def __init__(self, mesh: DeviceMesh, opts: LioOptions = LioOptions(), R_il=None,
                 t_il=None, *, device=None):
        """`device`: this rank's device (default: its card, see
        `pointcloud.card_device`; it raises without one)."""
        self.mesh = mesh
        self.opts = opts
        self.device = card_device(device)
        self.state = init_state(R_il, t_il, device=self.device)
        self.sm: Optional[map_shard.ShardedNdtMap] = None
        self.poses: list[np.ndarray] = []
        self.kf_poses: list[np.ndarray] = []
        self._imu_init = lio_mod.ImuStaticInit(device=self.device)
        self.imu_inited = not opts.with_eskf
        # the ndt_inc gate: half the NDT outlier gate per residual, as in Lio
        self.health = health_mod.TrackingHealth(
            health_mod.HealthOptions(max_chi2_per_point=10.0))
        self.imbalance_warnings: list[str] = []
        self._kf_since_check = 0

    def init_imu(self, gyro, acce, timestamp) -> bool:
        if self.imu_inited:
            return True
        st = self._imu_init.add(gyro, acce, timestamp)
        if st is None:
            return False
        self.state = self.state._replace(eskf=st)
        self.imu_inited = True
        return True

    def add_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                    imu_valid) -> StepResult:
        inc = self.opts.ndt_inc
        if self.sm is None:
            # first frame: identity pose and no match; its scan seeds the
            # slab partition
            s = self.state
            self.state = s._replace(
                eskf=eskf_mod.predict_scan(s.eskf, imu_gyro, imu_acce, imu_stamp, imu_valid,
                                           eskf_mod.EskfOptions()),
                frame_idx=s.frame_idx + 1, num_kfs=1)
            self.sm = map_shard.build_incremental_sharded(self.mesh, scan, inc)
            dev = self.device
            out = StepResult(R=s.R, t=s.t, is_keyframe=True,
                             converged=torch.ones((), dtype=torch.bool, device=dev),
                             num_effective=torch.zeros((), dtype=torch.int32, device=dev),
                             iterations=0,
                             chi2=torch.zeros((), dtype=torch.float32, device=dev))
            self._record(out)
            return out
        self.state, out = step_measure(self.mesh, self.sm, self.state, scan, imu_gyro,
                                       imu_acce, imu_stamp, imu_valid, self.opts)
        self._record(out)
        if out.is_keyframe:
            ws = world_scan(scan, out.R, out.t)
            self.sm = map_shard.update_incremental_sharded(self.mesh, self.sm, ws, inc)
            self._kf_since_check += 1
            if self._kf_since_check >= self.imbalance_check_every:
                self._kf_since_check = 0
                self._check_imbalance()
        return out

    def apply_correction(self, dR, dt) -> None:
        """Left-multiply the live pose state by the pose-graph correction
        (`Lio.apply_correction`'s contract) AND write it through the sharded
        map: every live Gaussian is moved, re-binned, re-slabbed and rebuilt
        (`map_shard.apply_correction_sharded`), so odometry goes on against
        the corrected map."""
        dRt = torch.as_tensor(dR, dtype=torch.float32, device=self.device)
        dtt = torch.as_tensor(dt, dtype=torch.float32, device=self.device)
        self.state = _corrected_state(self.state, dRt, dtt)
        if self.sm is not None:
            self.sm = map_shard.apply_correction_sharded(self.mesh, self.sm, dRt, dtt,
                                                         self.opts.ndt_inc)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray(dR, np.float32)
        T[:3, 3] = np.asarray(dt, np.float32)
        self.poses = [T @ p for p in self.poses]
        self.kf_poses = [T @ p for p in self.kf_poses]

    def _check_imbalance(self) -> None:
        """Warn when one slab holds far more than the mean live voxels: the
        fixed partition no longer spreads the map."""
        live = self.live_voxels_per_shard().astype(np.float64)
        mean = float(live.mean())
        if mean <= 0:
            return
        ratio = float(live.max()) / mean
        if ratio > self.imbalance_warn_ratio:
            self.imbalance_warnings.append(
                f"slab imbalance {ratio:.1f}x at keyframe {len(self.kf_poses)}: "
                f"live={live.astype(int).tolist()} (fixed first-keyframe partition; "
                "consider a larger per-shard map_capacity or re-partitioning)")

    def _record(self, out: StepResult) -> None:
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

    def live_voxels_per_shard(self) -> np.ndarray:
        """(mp,) live voxels of every shard, on every rank: each must stay
        under opts.ndt.map_capacity, or its shard has begun to age-evict.
        All zero before the first scan seeds the map."""
        if self.sm is None:
            return np.zeros((mesh_mod.axis_size(self.mesh, "mp"),), np.int64)
        return map_shard.live_voxels(self.mesh, self.sm).cpu().numpy().astype(np.int64)

    def keyframe_poses(self) -> np.ndarray:
        return np.stack(self.kf_poses) if self.kf_poses else np.zeros((0, 4, 4))
