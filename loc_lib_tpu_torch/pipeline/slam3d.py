"""3D SLAM: LIO front end + ScanContext loop closure + SE(3) pose graph (port
of loc_lib_tpu/pipeline/slam3d.py).

Per keyframe of the LIO front end (pipeline/lio.py): the keyframe's
descriptor goes into the ScanContext ring buffer (graph/scan_context.py),
the top `loop.sc_topk` descriptor matches that pass the keyframe-gap and
odometry-distance gates are re-registered against the new keyframe by ICP
(one candidate: `icp.scan_match`; several: ONE `icp.scan_match_batch` over
`sc_topk` lanes, padded by repeating the last candidate, so each GN
iteration is one launch of the batched K2 or K1 for all of them), and an
accepted registration becomes a loop edge. Every `optimize_every` accepted
loops, and on request, `optimize` runs the two-phase chi2-gated pose graph
(graph/pose_graph.py), writes the optimized poses back into the keyframe
archive and corrects the live front end (`Lio.apply_correction`).

Host / device split: the keyframe archive (every keyframe cloud and world
pose) is host numpy, touched once per loop event; the descriptors, the
loop registrations and the pose-graph solve run on the device. The graph is
built on the host in a fixed layout: odometry edges padded to nb - 1 rows,
loop edges at rows [nb - 1, nb - 1 + L), padded to lb, with nb and lb shape
buckets of the keyframe and loop-cap counts.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..graph import pose_graph as pg, scan_context as sc
from ..models import icp
from ..ops import voxel as voxel_ops
from ..ops.pointcloud import PointCloud, card_device
from . import lio as lio_mod


@dataclasses.dataclass(frozen=True)
class LoopOptions:
    """Loop-closure gates (mirror of the JAX package's LoopOptions)."""

    min_keyframe_gap: int = 15        # skip the most recent keyframes
    max_candidate_dist: float = 25.0  # odometry-distance gate (m)
    min_effective_pts: int = 200      # registration acceptance
    max_chi2_per_pt: float = 0.05     # mean squared residual acceptance (m^2)
    # loop edges carry odometry-grade information (a loop registration is as
    # good as an odometry one); bad edges are gated, not under-weighted
    loop_info_scale: float = 1e4      # loop edge information cap
    odom_info_scale: float = 1e4      # sequential edge information
    # per-edge information n_eff / chi2_per_pt, clipped to
    # [loop_info_min, loop_info_scale]; False: loop_info_scale for every edge
    use_quality_info: bool = True
    loop_info_min: float = 1e2
    optimize_every: int = 4           # run the pose graph after this many new loops
    # padded loop-edge capacity and the solver's constant loop bucket; the
    # oldest edges are dropped at the cap
    max_loops: int = 512
    # ScanContext candidates re-registered per keyframe: 1 is the scalar
    # flow, more run as one batched registration
    sc_topk: int = 1


@dataclasses.dataclass(frozen=True)
class Slam3dOptions:
    """Mirror of the JAX package's Slam3dOptions.

    `warm_start` is kept for option parity and does nothing here: the
    reference compiles the solver ahead of the first loop in a background
    thread because a remote XLA compile of it takes tens of seconds; the
    port has no compile step (the first optimize() against the second one
    is measured by chip_smoke.py)."""

    lio: lio_mod.LioOptions = lio_mod.LioOptions()
    sc: sc.ScanContextOptions = sc.ScanContextOptions(exclude_recent=15)
    pgo: pg.PgoOptions = pg.PgoOptions()
    loop: LoopOptions = LoopOptions()
    # wide-basin ICP for loop re-registration: coarser leaves and gates than
    # odometry (the initial guess comes from drifted poses); the octant-
    # elected method, one K1 launch per GN iteration
    loop_icp: icp.IcpOptions = icp.IcpOptions(
        method="p2plane_vox_oct", max_iteration=30, max_plane_distance=0.5,
        grid_leaf=2.0, bucket_size=8, plane_min_pts=4)
    sc_capacity: int = 4096           # max keyframes in the descriptor DB
    warm_start: bool = True


def loop_edge_info(num_effective: int, chi2_per_pt: float, lo: LoopOptions) -> float:
    """Isotropic information weight of one loop registration: n_eff
    residuals of variance chi2_per_pt give n_eff / chi2_per_pt, clipped so
    a near-perfect fit cannot drown the odometry chain and a barely accepted
    one still pulls."""
    if not lo.use_quality_info:
        return lo.loop_info_scale
    w = num_effective / max(chi2_per_pt, 1e-6)
    return float(np.clip(w, lo.loop_info_min, lo.loop_info_scale))


class LoopEdge(NamedTuple):
    i: int                 # older keyframe index
    j: int                 # newer keyframe index
    R: np.ndarray          # measured R_i_j
    t: np.ndarray          # measured t_i_j
    chi2_per_pt: float
    num_effective: int


class Slam3d:
    """The 3D SLAM engine: owns the LIO front end, the keyframe archive, the
    ScanContext database and the pose graph."""

    _BUCKET = 16

    def __init__(self, opts: Slam3dOptions = Slam3dOptions(), R_il=None, t_il=None,
                 front_end=None, *, device=None):
        """`device`: where the front end, the descriptors and the solves run
        (default: the card, see `pointcloud.card_device`; it raises without
        one). `front_end` replaces the odometry engine with anything that
        has the Lio contract (init_imu, add_measure, add_cloud, imu_inited,
        apply_correction) and returns each scan's StepResult at once."""
        self.opts = opts
        self.device = card_device(device)
        self.lio = (front_end if front_end is not None
                    else lio_mod.Lio(opts.lio, R_il=R_il, t_il=t_il, device=self.device))
        self.scdb = sc.ScanContextDb(capacity=opts.sc_capacity, opts=opts.sc,
                                     device=self.device)
        # keyframe archive (host): lidar-frame clouds + world poses
        self.kf_xyz: list[np.ndarray] = []     # (C, 3) each
        self.kf_mask: list[np.ndarray] = []    # (C,) each
        self.kf_R: list[np.ndarray] = []       # (3, 3) each, world pose
        self.kf_t: list[np.ndarray] = []       # (3,) each
        self.kf_frame: list[int] = []          # source frame index
        self.loops: list[LoopEdge] = []
        self.loop_inliers: Optional[np.ndarray] = None
        self.cg_iterations = 0                 # CG iterations of the last optimize()
        self._loops_since_opt = 0
        self._frame = 0

    # -- delegation to the LIO front end -------------------------------------
    @property
    def imu_inited(self) -> bool:
        return self.lio.imu_inited

    def init_imu(self, gyro, acce, timestamp) -> bool:
        return self.lio.init_imu(gyro, acce, timestamp)

    def add_measure(self, scan: PointCloud, imu_gyro, imu_acce, imu_stamp, imu_valid):
        out = self.lio.add_measure(scan, imu_gyro, imu_acce, imu_stamp, imu_valid)
        self._after_step(scan, out)
        return out

    def add_cloud(self, scan: PointCloud):
        out = self.lio.add_cloud(scan)
        self._after_step(scan, out)
        return out

    # -- loop closure ----------------------------------------------------------
    def _after_step(self, scan: PointCloud, out) -> None:
        self._frame += 1
        if not out.is_keyframe:
            return
        self.kf_xyz.append(scan.xyz.cpu().numpy())
        self.kf_mask.append(scan.mask.cpu().numpy())
        pose = torch.cat([out.R.reshape(9), out.t.reshape(3)]).cpu().numpy()
        self.kf_R.append(pose[:9].reshape(3, 3))
        self.kf_t.append(pose[9:])
        self.kf_frame.append(self._frame - 1)
        kf_id = len(self.kf_R) - 1
        # at capacity the ring buffer evicts (and counts) the oldest descriptor
        self.scdb.add(scan)
        cands = self._detect(scan, kf_id)
        if cands:
            accepted = self._register_loops(cands, kf_id, scan)
            self._loops_since_opt += accepted
            if accepted and self._loops_since_opt >= self.opts.loop.optimize_every:
                self.optimize()

    def _detect(self, scan: PointCloud, kf_id: int) -> list[int]:
        """ScanContext retrieval + the keyframe-gap and odometry-distance
        gates. Returns the gated candidate keyframe ids, best descriptor
        match first (up to loop.sc_topk of them)."""
        lo = self.opts.loop
        if kf_id < lo.min_keyframe_gap:
            return []
        res = self.scdb.query_topk(scan, lo.sc_topk)
        pulled = torch.stack([res.index, res.found.to(torch.int32)]).cpu().numpy()
        out: list[int] = []
        for cand, ok in zip(pulled[0].tolist(), pulled[1].tolist()):
            if not ok or cand < 0:
                continue
            if kf_id - cand < lo.min_keyframe_gap:
                continue
            if np.linalg.norm(self.kf_t[kf_id] - self.kf_t[cand]) > lo.max_candidate_dist:
                continue
            out.append(cand)
        return out

    def _archive_clouds(self, ids: list[int]) -> PointCloud:
        """The archived clouds of keyframes `ids`, stacked on the device."""
        return PointCloud(
            xyz=torch.from_numpy(np.stack([self.kf_xyz[c] for c in ids])).to(self.device),
            mask=torch.from_numpy(np.stack([self.kf_mask[c] for c in ids])).to(self.device))

    def _initial_guess(self, cand: int, kf_id: int):
        """T_cand_new from the current (drifted) pose estimates."""
        Rc, tc = self.kf_R[cand], self.kf_t[cand]
        return Rc.T @ self.kf_R[kf_id], Rc.T @ (self.kf_t[kf_id] - tc)

    def _accept(self, cand: int, kf_id: int, R, t, n_eff: int, chi2: float) -> bool:
        """Quality-gated acceptance (effective points and mean squared
        residual, not the convergence flag: a wide-basin registration may use
        its whole budget and still fit well); bad edges are also gated inside
        the pose graph."""
        lo = self.opts.loop
        chi2pp = chi2 / max(n_eff, 1)
        if n_eff < lo.min_effective_pts or chi2pp > lo.max_chi2_per_pt:
            return False
        self._append_loop(LoopEdge(i=cand, j=kf_id, R=R, t=t, chi2_per_pt=chi2pp,
                                   num_effective=n_eff))
        return True

    def _register_loops(self, cands: list[int], kf_id: int, scan: PointCloud) -> int:
        """Re-register every surviving candidate against the new keyframe.
        One candidate runs the scalar path; several run as ONE batched match
        over sc_topk lanes (padded by repeating the last candidate, whose
        lanes are ignored). Returns the number of accepted loop edges."""
        if len(cands) == 1:
            return int(self._register_loop(cands[0], kf_id, scan))
        B = self.opts.loop.sc_topk
        lanes = (cands + [cands[-1]] * B)[:B]
        targets = icp.set_target_batch(self._archive_clouds(lanes), self.opts.loop_icp)
        guesses = [self._initial_guess(c, kf_id) for c in lanes]
        R0 = torch.from_numpy(np.stack([g[0] for g in guesses]).astype(np.float32))
        t0 = torch.from_numpy(np.stack([g[1] for g in guesses]).astype(np.float32))
        # the batched kernels take contiguous lanes, not a stride-0 broadcast
        srcs = PointCloud(xyz=scan.xyz.expand((B,) + scan.xyz.shape).contiguous(),
                          mask=scan.mask.expand((B,) + scan.mask.shape).contiguous())
        res = icp.scan_match_batch(targets, self.opts.loop_icp, srcs, R0.to(self.device),
                                   t0.to(self.device))
        pulled = torch.cat([res.R.reshape(B, 9), res.t, res.num_effective[:, None].float(),
                            res.chi2[:, None]], dim=1).cpu().numpy()
        accepted = 0
        for k, cand in enumerate(cands):
            row = pulled[k]
            accepted += self._accept(cand, kf_id, row[:9].reshape(3, 3).copy(), row[9:12].copy(),
                                     int(row[12]), float(row[13]))
        return accepted

    def _register_loop(self, cand: int, kf_id: int, scan: PointCloud) -> bool:
        """Re-register the new keyframe scan against the candidate keyframe
        cloud (in the candidate's lidar frame). Measurement: T_cand_new."""
        tgt = icp.take_lane(self._archive_clouds([cand]), 0)
        target = icp.set_target(tgt, self.opts.loop_icp)
        R0, t0 = (torch.from_numpy(np.asarray(x, np.float32)).to(self.device)
                  for x in self._initial_guess(cand, kf_id))
        res = icp.scan_match(target, self.opts.loop_icp, scan, R0, t0)
        row = torch.cat([res.R.reshape(9), res.t, res.num_effective.reshape(1).float(),
                         res.chi2.reshape(1)]).cpu().numpy()
        return self._accept(cand, kf_id, row[:9].reshape(3, 3).copy(), row[9:12].copy(),
                            int(row[12]), float(row[13]))

    def _append_loop(self, edge: LoopEdge) -> None:
        """Bounded loop-edge store (loop.max_loops is the padded solver
        capacity): at the cap the OLDEST constraints are dropped."""
        self.loops.append(edge)
        cap = self.opts.loop.max_loops
        if len(self.loops) > cap:
            self.loops = self.loops[-cap:]

    # -- pose-graph optimization ---------------------------------------------------
    @classmethod
    def _bucketed(cls, n: int) -> int:
        """Geometric shape buckets: 16, 32, 64, ... (padding waste <= 2x)."""
        b = cls._BUCKET
        n = max(n, 1)
        while b < n:
            b *= 2
        return b

    def _solver_shape(self, num_kfs: int) -> tuple:
        """(node bucket, loop-edge bucket): the loop bucket is the constant
        bucket of loop.max_loops, so the graph's shape depends on the node
        bucket alone."""
        return self._bucketed(num_kfs), self._bucketed(self.opts.loop.max_loops)

    @staticmethod
    def _pad_edges(edges: pg.Se3Edges, total: int) -> pg.Se3Edges:
        """Pad with invalid identity self-edges up to `total` rows (numpy)."""
        k = total - int(len(edges.i))
        if k <= 0:
            return edges
        return pg.concat_edges_np(edges, pg.make_pad_edges_np(k))

    def _build_edges(self, nb: int, lb: int) -> pg.Se3Edges:
        """Odometry chain padded to nb - 1 rows, then the loop edges padded
        to lb rows: loop edges always occupy rows [nb - 1, nb - 1 + L).
        Host numpy."""
        lo = self.opts.loop
        edges = pg.odometry_edges_np(np.stack(self.kf_R), np.stack(self.kf_t),
                                     info_scale=lo.odom_info_scale)
        edges = self._pad_edges(edges, nb - 1)
        if self.loops:
            scales = np.array([loop_edge_info(l.num_effective, l.chi2_per_pt, lo)
                               for l in self.loops], np.float32)
            loop_edges = pg.Se3Edges(
                i=np.array([l.i for l in self.loops], np.int32),
                j=np.array([l.j for l in self.loops], np.int32),
                R=np.stack([l.R for l in self.loops]).astype(np.float32),
                t=np.stack([l.t for l in self.loops]).astype(np.float32),
                info=np.eye(6, dtype=np.float32)[None] * scales[:, None, None],
                is_loop=np.ones((len(self.loops),), bool),
                valid=np.ones((len(self.loops),), bool))
            edges = pg.concat_edges_np(edges, loop_edges)
        return self._pad_edges(edges, (nb - 1) + lb)

    def optimize(self) -> bool:
        """Two-phase chi2-gated solve, pose write-back, and the front end's
        correction by the last keyframe's update. One pull of the result."""
        if len(self.kf_R) < 2 or not self.loops:
            self._loops_since_opt = 0
            return False
        m = len(self.kf_R)
        nb, lb = self._solver_shape(m)
        # edge rows rounded up to a multiple of 16, nodes padded to nb
        edges = self._pad_edges(self._build_edges(nb, lb), -(-((nb - 1) + lb) // 16) * 16)
        pad_n = nb - m
        nodes_R = np.concatenate([np.stack(self.kf_R).astype(np.float32),
                                  np.broadcast_to(np.eye(3, dtype=np.float32), (pad_n, 3, 3))])
        nodes_t = np.concatenate([np.stack(self.kf_t).astype(np.float32),
                                  np.zeros((pad_n, 3), np.float32)])
        dev = self.device
        res1, res2, inliers = pg.two_phase(torch.from_numpy(nodes_R).to(dev),
                                           torch.from_numpy(nodes_t).to(dev), edges,
                                           self.opts.pgo)
        n_loops = len(self.loops)
        pulled = torch.cat([res2.R[:m].reshape(-1), res2.t[:m].reshape(-1),
                            inliers[nb - 1: nb - 1 + n_loops].float(),
                            (res1.cg_iterations + res2.cg_iterations).reshape(1).float()]
                           ).cpu().numpy()
        R_opt = pulled[:9 * m].reshape(m, 3, 3)
        t_opt = pulled[9 * m: 12 * m].reshape(m, 3)

        # correct the live front end by the last keyframe's update
        k = m - 1
        dR = R_opt[k] @ self.kf_R[k].T
        dt = t_opt[k] - dR @ self.kf_t[k]
        self.lio.apply_correction(dR, dt)
        for i in range(m):
            self.kf_R[i] = R_opt[i]
            self.kf_t[i] = t_opt[i]
        self.loop_inliers = pulled[12 * m: 12 * m + n_loops].astype(bool)
        self.cg_iterations = int(pulled[-1])
        self._loops_since_opt = 0
        return True

    # -- exports -------------------------------------------------------------------
    def keyframe_poses(self) -> np.ndarray:
        if not self.kf_R:
            return np.zeros((0, 4, 4), np.float32)
        T = np.tile(np.eye(4, dtype=np.float32), (len(self.kf_R), 1, 1))
        T[:, :3, :3] = np.stack(self.kf_R)
        T[:, :3, 3] = np.stack(self.kf_t)
        return T

    def assemble_global_map(self, voxel_size: float = 0.3,
                            max_points_per_kf: int = 0) -> np.ndarray:
        """The map re-assembled from the keyframe clouds at their OPTIMIZED
        poses, voxel-filtered on the device (voxel_size > 0)."""
        pts = []
        for xyz, mask, R, t in zip(self.kf_xyz, self.kf_mask, self.kf_R, self.kf_t):
            p = xyz[mask]
            if max_points_per_kf and len(p) > max_points_per_kf:
                p = p[:max_points_per_kf]
            pts.append(p @ R.T + t)
        if not pts:
            return np.zeros((0, 3), np.float32)
        allp = np.concatenate(pts).astype(np.float32)
        if voxel_size <= 0:
            return allp
        pc = PointCloud(xyz=torch.from_numpy(allp).to(self.device),
                        mask=torch.ones((len(allp),), dtype=torch.bool, device=self.device))
        origin = torch.from_numpy(allp.mean(axis=0)).to(self.device)
        ds = voxel_ops.voxel_downsample(pc, voxel_size, origin=origin)
        return ds.xyz[ds.mask].cpu().numpy()
