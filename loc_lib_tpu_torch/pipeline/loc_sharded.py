"""Loc with the local map split over the ranks' map shards (port of
loc_lib_tpu/pipeline/loc_sharded.py).

  * The GLOBAL map stays in host memory (numpy) and is touched once per
    re-crop, as the reference touches its loaded global cloud.
  * A re-crop box-crops around the pose on the host and partitions the crop
    into voxel-aligned slabs over the mesh's "mp" axis
    (`map_shard.set_target_sharded`): each rank holds only its own slab's
    hash grid and plane table, so the map held per rank is O(crop / mp).
  * Per scan, on every rank: the ESKF predicts through the IMU packet, the
    distributed voxel-plane match runs (`map_shard.icp_scan_match_sharded`:
    source rows over "dp", plane table over "mp", an election by two
    all_reduce MIN and one all_reduce SUM per GN iteration), the ESKF fuses
    the pose and the box-edge test decides a re-crop. The step is
    `pipeline/loc.py`'s own, with the sharded match in place of the local
    one; every value the host branches on is replicated, so every rank
    re-crops at the same frame.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models import eskf as eskf_mod
from ..ops.pointcloud import PointCloud, PAD_COORD, card_device
from ..parallel import map_shard, mesh as mesh_mod
from ..utils import health as health_mod
from ..utils import timing
from . import loc as loc_mod
from .loc import LocOptions, LocState, StepResult


# the replicated per-scan state: loc.LocState with its target fields None
LocShardedState = LocState


def init_state(R_il=None, t_il=None, *, device=None) -> LocState:
    """Fresh replicated state on `device` (default: the card); the sharded
    target lives outside it (LocSharded.target)."""
    device = card_device(device)
    eye = torch.eye(3, dtype=torch.float32, device=device)
    z3 = torch.zeros((3,), dtype=torch.float32, device=device)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    return LocState(R=eye, t=z3, last_R=eye, last_t=z3, icp_target=None, ndt_map=None,
                    map_center=z3, eskf=eskf_mod.init_state(device=device),
                    R_il=eye if R_il is None else f32(R_il),
                    t_il=z3 if t_il is None else f32(t_il), initialized=False)


def step_measure(mesh: DeviceMesh, target: map_shard.ShardedIcpTarget, state: LocState,
                 scan: PointCloud, imu_gyro, imu_acce, imu_stamp, imu_valid,
                 opts: LocOptions):
    """One measure group against the sharded map: `loc.step_measure` with
    the distributed voxel-plane match."""
    def match(src, R0, t0):
        return map_shard.icp_scan_match_sharded(mesh, target, opts.icp, src, R0, t0)

    return loc_mod.step_measure(state, scan, imu_gyro, imu_acce, imu_stamp, imu_valid, opts,
                                match=match)


class LocSharded:
    """Host driver mirroring `pipeline/loc.Loc` with an mp-sharded local map.
    `shard_capacity` is each shard's POINT budget (slab and one-voxel halo);
    the crop a mesh carries is about mp * shard_capacity, so a budget below
    the crop's size makes the map exceed any one shard."""

    def __init__(self, mesh: DeviceMesh, global_map_xyz: np.ndarray,
                 opts: LocOptions = LocOptions(), shard_capacity: Optional[int] = None,
                 R_il=None, t_il=None, *, device=None):
        """`device`: this rank's device (default: its card, see
        `pointcloud.card_device`; it raises without one)."""
        if opts.matcher != "icp" or opts.icp.method != "p2plane_vox":
            raise ValueError("the sharded Loc runs the voxel-plane path (icp, p2plane_vox), "
                             f"got {opts.matcher}/{opts.icp.method}")
        self.mesh = mesh
        self.opts = opts
        self.device = card_device(device)
        mp = mesh_mod.axis_size(mesh, "mp")
        self.shard_capacity = (shard_capacity if shard_capacity is not None
                               else -(-opts.local_map_capacity // mp) * 2)
        gm = np.asarray(global_map_xyz, np.float32).reshape(-1, 3)
        self.map_xyz = gm[np.isfinite(gm).all(axis=1)]
        self.state = init_state(R_il, t_il, device=self.device)
        self.target: Optional[map_shard.ShardedIcpTarget] = None
        self.poses: list[np.ndarray] = []
        self.num_recrops = 0                  # box-edge re-crops after the first crop
        self.health = health_mod.TrackingHealth()

    def set_init_pose(self, R, t):
        self.state = loc_mod.set_init_pose(self.state, R, t)
        self.health.reset()
        self._recrop()

    def _recrop(self) -> None:
        """Box-crop the host global map around the pose (numpy, no device
        holds the global map) and rebuild this rank's target shard."""
        center = self.state.t.cpu().numpy()
        half = self.opts.box_size / 2.0
        cap = self.opts.local_map_capacity
        inside = np.all(np.abs(self.map_xyz - center) <= half, axis=1)
        pts = self.map_xyz[inside][:cap]
        xyz = np.full((cap, 3), PAD_COORD, np.float32)
        xyz[:len(pts)] = pts
        mask = np.zeros((cap,), bool)
        mask[:len(pts)] = True
        crop = PointCloud(xyz=torch.from_numpy(xyz).to(self.device),
                          mask=torch.from_numpy(mask).to(self.device))
        self.target = map_shard.set_target_sharded(self.mesh, crop, self.opts.icp,
                                                   self.shard_capacity)
        self.state = self.state._replace(
            map_center=torch.from_numpy(center).to(self.device))

    def shard_overflow(self) -> np.ndarray:
        """(mp,) points each shard dropped at the last re-crop: all zero, or
        the sharded map is not the crop."""
        return self.target.overflow.cpu().numpy()

    def update_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp,
                       imu_valid) -> StepResult:
        if self.target is None:
            raise RuntimeError("call set_init_pose first")
        self.state, out = step_measure(self.mesh, self.target, self.state, scan, imu_gyro,
                                       imu_acce, imu_stamp, imu_valid, self.opts)
        # one device-to-host pull per scan
        vals = timing.host_numpy(torch.cat([
            out.R.reshape(9), out.t.reshape(3),
            torch.stack([out.need_recrop.to(torch.float32), out.converged.to(torch.float32),
                         out.num_effective.to(torch.float32), out.chi2.to(torch.float32)])]))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = vals[:9].reshape(3, 3)
        T[:3, 3] = vals[9:12]
        self.poses.append(T)
        self.health.update(bool(vals[13]), int(vals[14]), float(vals[15]))
        if vals[12] > 0.5:
            self._recrop()
            self.num_recrops += 1
        return out

    def current_pose(self) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = self.state.R.cpu().numpy()
        T[:3, 3] = self.state.t.cpu().numpy()
        return T
