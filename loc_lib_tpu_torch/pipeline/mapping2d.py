"""2D submap SLAM: scan matching, submap management, loop closure (port of
loc_lib_tpu/pipeline/mapping2d.py, the host-driven engine).

  * `Mapping2D` (the reference's mapping_2d.cpp): per scan a constant-
    velocity guess, a GN match into the current submap's likelihood field,
    the keyframe test (0.3 m / 15 deg), occupancy update + field regen, and
    submap expansion when the scan leaves the grid or after
    `max_keyframes_in_submap` keyframes.
  * `Submap` (submap.cpp): pose T_w_s + occupancy + field; a new submap is
    seeded from the last keyframes of the previous one.
  * Loop closing (loop_closing.cpp): distance-gated candidates against
    older submaps, re-registration through a pooled field pyramid with an
    LM retry, pair dedupe, a retry throttle and a plausibility gate, then
    the SE(2) pose graph over submap poses and its write-back.

Field matching, the occupancy carve, the field and the pose graph run as
torch ops on the engine's device (default: the card); the submap lifecycle
and loop bookkeeping live on the host in numpy, whose SE(2) helpers are
copies of the JAX package's (the same float32 / float64 mix, so the host
side has its bits).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..graph import pose_graph2d as pg2
from ..graph.pose_graph import PgoOptions
from ..models import grid2d
from ..ops.pointcloud import card_device


@dataclasses.dataclass(frozen=True)
class Mapping2dOptions:
    """Mirror of the JAX package's Mapping2dOptions (same names and defaults)."""

    grid: grid2d.Grid2dOptions = grid2d.Grid2dOptions()
    align: grid2d.Align2dOptions = grid2d.Align2dOptions()
    keyframe_dist: float = 0.3           # mapping_2d.hpp:73
    keyframe_angle_deg: float = 15.0     # mapping_2d.hpp:74
    max_keyframes_in_submap: int = 50    # mapping_2d.cpp:166
    # a new submap is seeded with the last N keyframes of the previous one
    seed_frames: int = 10
    loop_candidate_radius: float = 15.0  # loop_closing.cpp:69
    loop_submap_gap: int = 1             # loop_closing.cpp:58
    loop_min_inlier_ratio: float = 0.4   # multi_resolution_...cpp:170
    # plausibility gate: reject a loop whose submap-pair transform deviates
    # from the odometry-implied one by more than this (m / rad)
    loop_max_trans_delta: float = 1.5
    loop_max_rot_delta: float = 0.35
    # a failed attempt on a submap pair is retried only after this much motion
    loop_retry_move_m: float = 1.0
    # a submap graph is tens of nodes: one dense (3M, 3M) solve
    pgo: PgoOptions = PgoOptions(solver="dense")
    # multi-res pyramid: coarse-to-fine pooling factors over the base field
    pyramid_factors: tuple = (8, 4, 2, 1)
    # device-resident engine only: archived submaps whose grid / field stay
    # on the device; older archives spill to host memory
    archived_device_submaps: int = 12
    # retry a failed GN multires registration once with align_lm
    lm_fallback: bool = True


# Host-side SE(2) bookkeeping in plain numpy (copies of the JAX package's)

def _np_wrap(a: float) -> float:
    return float((a + np.pi) % (2.0 * np.pi) - np.pi)


def _np_se2_compose(th1, t1, th2, t2):
    c, s = np.cos(th1), np.sin(th1)
    R = np.array([[c, -s], [s, c]], np.float32)
    return _np_wrap(th1 + th2), np.asarray(t1, np.float32) + R @ np.asarray(t2, np.float32)


def _np_se2_inverse(th, t):
    c, s = np.cos(th), np.sin(th)
    Rt = np.array([[c, s], [-s, c]], np.float32)
    return _np_wrap(-th), -(Rt @ np.asarray(t, np.float32))


def _np_se2_apply(th, t, xy):
    c, s = np.cos(th), np.sin(th)
    R = np.array([[c, -s], [s, c]], np.float32)
    return np.asarray(xy, np.float32) @ R.T + np.asarray(t, np.float32)


def _on(x, device, dtype=None) -> torch.Tensor:
    """A host array (or a tensor anywhere) as a tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _scalar(x, device) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=device)


def to_numpy(x) -> np.ndarray:
    """A tensor or an array (a spilled archive) as a host numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Submap:
    """Host-side submap record (Submap, submap.hpp:25-73); its grid and
    field live on `device` (default: the card), or, once spilled, in host
    numpy."""

    def __init__(self, opts: Mapping2dOptions, theta_ws: float, t_ws: np.ndarray, index: int,
                 device=None):
        self.opts = opts
        self.device = device = card_device(device)
        self.index = index
        self.theta_ws = float(theta_ws)
        self.t_ws = np.asarray(t_ws, np.float32)
        self.grid = grid2d.empty_grid(opts.grid, device)
        self.field = grid2d.likelihood_field(self.grid, opts.grid)
        self.num_frames = 0
        self.frame_ids: list[int] = []
        # last seed_frames keyframes (scan, valid, world pose) kept for
        # seeding the NEXT submap
        self.recent: list[tuple] = []

    def world_to_submap(self, theta_wb, t_wb):
        return _np_se2_compose(*_np_se2_inverse(self.theta_ws, self.t_ws), theta_wb, t_wb)

    def submap_to_world(self, theta_sb, t_sb):
        return _np_se2_compose(self.theta_ws, self.t_ws, theta_sb, t_sb)

    def add_scan(self, scan_xy, valid, theta_sb, t_sb):
        """AddScanInOccupancyMap: pose the scan into the submap frame, update
        the occupancy, regenerate the field."""
        th_w, t_w = self.submap_to_world(theta_sb, t_sb)
        self.recent.append((scan_xy, valid, th_w, np.asarray(t_w, np.float32)))
        if len(self.recent) > self.opts.seed_frames:
            self.recent.pop(0)
        pts = _np_se2_apply(theta_sb, t_sb, scan_xy)
        self.grid, self.field = grid2d.add_scan_and_field(
            self.grid, self.opts.grid, _on(pts, self.device), _on(valid, self.device),
            _on(np.asarray(t_sb, np.float32), self.device))
        self.num_frames += 1

    def seed_from(self, other: "Submap") -> None:
        """SetOccuFromOtherSubmap: rasterize the previous submap's recent
        keyframes (their WORLD poses re-expressed in this submap's frame),
        then one field regen."""
        recent = other.recent[-self.opts.seed_frames:]
        if not recent:
            return
        kmax = self.opts.seed_frames
        b = recent[0][0].shape[0]
        pts = np.zeros((kmax, b, 2), np.float32)
        val = np.zeros((kmax, b), bool)
        orgs = np.zeros((kmax, 2), np.float32)
        for k, (scan_xy, valid, th_w, t_w) in enumerate(recent):
            th_sb, t_sb = self.world_to_submap(th_w, t_w)
            pts[k] = _np_se2_apply(th_sb, t_sb, scan_xy)
            val[k] = valid
            orgs[k] = t_sb
        self.grid, self.field = grid2d.add_scans_and_field(
            self.grid, self.opts.grid, _on(pts, self.device), _on(val, self.device),
            _on(orgs, self.device), len(recent))

    def match_scan(self, scan_xy, valid, theta0_sb, t0_sb) -> grid2d.Align2dResult:
        return grid2d.align_gauss_newton(
            self.field, self.opts.grid, _on(scan_xy, self.device), _on(valid, self.device),
            _scalar(theta0_sb, self.device), _on(np.asarray(t0_sb, np.float32), self.device),
            self.opts.align)

    def match_multires(self, scan_xy, valid, theta0_sb, t0_sb):
        """Coarse-to-fine alignment through the pooled field pyramid
        (MRLikelihoodField::AlignG2O), with the LM retry from the original
        init when GN fails the acceptance. A spilled archive's field is
        moved back to the engine's device first. Returns (result, accepted)."""
        field = _on(self.field, self.device)
        xy, v = _on(scan_xy, self.device), _on(valid, self.device)
        th0 = _scalar(theta0_sb, self.device)
        t0 = _on(np.asarray(t0_sb, np.float32), self.device)

        def run(aopts):
            res = _match_multires(field, self.opts.grid, aopts, self.opts.pyramid_factors,
                                  xy, v, th0, t0)
            # one host read of both acceptance numbers
            ratio, n_eff = torch.stack([res.inlier_ratio,
                                        res.num_effective.to(torch.float32)]).tolist()
            return res, (ratio >= self.opts.loop_min_inlier_ratio
                         and n_eff >= self.opts.align.min_effective)

        res, ok = run(self.opts.align)
        if not ok and self.opts.lm_fallback:
            res2, ok2 = run(dataclasses.replace(self.opts.align, method="lm"))
            if ok2:
                return res2, True
        return res, ok


def _match_multires(field, gopts, aopts, factors, scan_xy, valid, th0, t0):
    """Align through every pyramid level in turn (pool, then align from the
    previous level's pose). Returns the finest level's result."""
    th, t = th0, t0
    res = None
    for f in factors:
        pooled, go = _pooled_field(field, gopts, f)
        res = grid2d.align_gauss_newton(pooled, go, scan_xy, valid, th, t, aopts)
        th, t = res.theta, res.t
    return res


def _pooled_field(field: torch.Tensor, gopts: grid2d.Grid2dOptions, factor: int):
    """Min-pool the base distance field by `factor`: a field built at
    resolution / factor (distances rescale with the resolution)."""
    if factor == 1:
        return field, gopts
    n = field.shape[0] // factor
    pooled = field[: n * factor, : n * factor].reshape(n, factor, n, factor).amin(
        dim=(1, 3)) / factor
    new_opts = dataclasses.replace(gopts, image_size=n, resolution=gopts.resolution / factor,
                                   field_radius=max(2, gopts.field_radius // factor))
    return pooled, new_opts


class LoopConstraint(NamedTuple):
    submap_i: int
    submap_j: int
    theta_ij: float
    t_ij: np.ndarray
    valid: bool


class Mapping2D:
    """The host-driven engine (Mapping2D, mapping_2d.hpp:26-75). `device` defaults to
    the card (it raises without one)."""

    def __init__(self, opts: Mapping2dOptions = Mapping2dOptions(), device=None):
        self.opts = opts
        self.device = card_device(device)
        self.submaps: list[Submap] = [Submap(opts, 0.0, np.zeros(2), 0, self.device)]
        self.theta_wb = 0.0
        self.t_wb = np.zeros(2, np.float32)
        self.last_theta = 0.0
        self.last_t = np.zeros(2, np.float32)
        self.last_kf_theta = 0.0
        self.last_kf_t = np.zeros(2, np.float32)
        self.frame_count = 0
        self.loops: list[LoopConstraint] = []
        # one constraint per (historical, current) submap pair; invalidated
        # pairs may be retried
        self._pair_idx: dict[tuple, int] = {}
        # body position at the last FAILED attempt per pair (retry throttle)
        self._pair_attempt_t: dict[tuple, np.ndarray] = {}
        self.frame_poses: list[tuple[float, np.ndarray]] = []

    # -- per-scan -----------------------------------------------------------
    def process_scan(self, scan_xy: np.ndarray, valid: np.ndarray):
        """ProcessScan (mapping_2d.cpp:65-130). scan_xy: (B, 2) numpy in the
        sensor frame, valid (B,) bool. Returns the world pose (theta, t)."""
        opts = self.opts
        first = self.frame_count == 0
        # constant-velocity world guess
        guess_th = self.theta_wb + _np_wrap(self.theta_wb - self.last_theta)
        guess_t = self.t_wb + (self.t_wb - self.last_t)

        cur = self.submaps[-1]
        if not first:
            th0, t0 = cur.world_to_submap(guess_th, guess_t)
            res = cur.match_scan(scan_xy, valid, th0, t0)
            pose = torch.cat([res.theta.reshape(1), res.t]).cpu().numpy()   # one pull
            th_w, t_w = cur.submap_to_world(float(pose[0]), pose[1:])
        else:
            th_w, t_w = self.theta_wb, self.t_wb

        self.last_theta, self.last_t = self.theta_wb, self.t_wb
        self.theta_wb, self.t_wb = float(th_w), np.asarray(t_w, np.float32)
        self.frame_poses.append((self.theta_wb, self.t_wb.copy()))

        if first or self._is_keyframe():
            self.last_kf_theta, self.last_kf_t = self.theta_wb, self.t_wb
            th_sb, t_sb = cur.world_to_submap(self.theta_wb, self.t_wb)
            cur.add_scan(scan_xy, valid, th_sb, t_sb)
            cur.frame_ids.append(self.frame_count)
            self._maybe_expand(scan_xy, valid)
            self._detect_loops(scan_xy, valid)

        self.frame_count += 1
        return self.theta_wb, self.t_wb.copy()

    def _is_keyframe(self) -> bool:
        d = np.linalg.norm(self.t_wb - self.last_kf_t)
        a = abs(_np_wrap(self.theta_wb - self.last_kf_theta))
        return d > self.opts.keyframe_dist or a > np.deg2rad(self.opts.keyframe_angle_deg)

    def _maybe_expand(self, scan_xy, valid):
        """ExpandSubmap triggers (mapping_2d.cpp:154-184): the out-of-bounds
        fraction in host numpy (grid2d.out_of_bounds_fraction is the device
        form)."""
        cur = self.submaps[-1]
        th_sb, t_sb = cur.world_to_submap(self.theta_wb, self.t_wb)
        pts = _np_se2_apply(th_sb, t_sb, scan_xy)
        g = self.opts.grid
        px = pts * g.resolution + g.center
        outside = ((px[:, 0] < 0) | (px[:, 0] >= g.image_size)
                   | (px[:, 1] < 0) | (px[:, 1] >= g.image_size))
        nvalid = max(int(np.sum(valid)), 1)
        oob = float(np.sum(outside & np.asarray(valid)) / nvalid)
        if oob > 0.1 or cur.num_frames > self.opts.max_keyframes_in_submap:
            new = Submap(self.opts, self.theta_wb, self.t_wb, len(self.submaps), self.device)
            # seed from the previous submap's recent keyframes, then add the
            # current scan
            new.seed_from(cur)
            new.add_scan(scan_xy, valid, 0.0, np.zeros(2))
            self.submaps.append(new)

    # -- loop closing ---------------------------------------------------------
    def _detect_loops(self, scan_xy, valid):
        """DetectLoopCandidates + MatchInHistorySubmaps (loop_closing.cpp:
        52-158), then optimize."""
        opts = self.opts
        cur = self.submaps[-1]
        found = False
        for sm in self.submaps[: max(0, len(self.submaps) - 1 - opts.loop_submap_gap)]:
            # one valid constraint per submap pair: skip pairs already
            # constrained; retried only if invalidated
            pair = (sm.index, cur.index)
            k = self._pair_idx.get(pair)
            if k is not None and self.loops[k].valid:
                continue
            if np.linalg.norm(sm.t_ws - self.t_wb) > opts.loop_candidate_radius:
                continue
            last_t = self._pair_attempt_t.get(pair)
            if (last_t is not None
                    and np.linalg.norm(self.t_wb - last_t) < opts.loop_retry_move_m):
                continue  # same viewpoint as the last failed attempt
            th0, t0 = sm.world_to_submap(self.theta_wb, self.t_wb)
            res, ok = sm.match_multires(scan_xy, valid, th0, t0)
            if not ok:
                self._pair_attempt_t[pair] = self.t_wb.copy()
                continue
            # T_sm_cur = T_sm_b * T_b_cur, T_sm_b from the match and
            # T_b_cur = (T_w_b)^-1 T_w_cur
            th_b_cur, t_b_cur = _np_se2_compose(
                *_np_se2_inverse(self.theta_wb, self.t_wb), cur.theta_ws, cur.t_ws)
            pose = torch.cat([res.theta.reshape(1), res.t]).cpu().numpy()   # one pull
            th_ij, t_ij = _np_se2_compose(float(pose[0]), pose[1:], th_b_cur, t_b_cur)
            # plausibility gate against the odometry-implied pair transform
            th_odo, t_odo = _np_se2_compose(*_np_se2_inverse(sm.theta_ws, sm.t_ws),
                                            cur.theta_ws, cur.t_ws)
            if (np.linalg.norm(np.asarray(t_ij) - t_odo) > opts.loop_max_trans_delta
                    or abs(_np_wrap(th_ij - th_odo)) > opts.loop_max_rot_delta):
                self._pair_attempt_t[pair] = self.t_wb.copy()
                continue
            lc = LoopConstraint(submap_i=sm.index, submap_j=cur.index, theta_ij=float(th_ij),
                                t_ij=np.asarray(t_ij), valid=True)
            if k is None:
                self._pair_idx[pair] = len(self.loops)
                self.loops.append(lc)
            else:
                self.loops[k] = lc
            found = True
        if found:
            self.optimize()

    def optimize(self):
        """The pose graph over submap poses + write-back (loop_closing.cpp:
        160-255): the graph is built in host numpy, solved on the device."""
        m = len(self.submaps)
        if m < 2 or not self.loops:
            return
        theta_p, t_p, edges_p, _ = pg2.build_graph_np(
            [s.theta_ws for s in self.submaps], np.stack([s.t_ws for s in self.submaps]),
            [(l.submap_i, l.submap_j, l.theta_ij, l.t_ij, l.valid) for l in self.loops])
        th2, t2, inlier = pg2.optimize_two_phase(_on(theta_p, self.device),
                                                 _on(t_p, self.device), edges_p, self.opts.pgo)
        th2, t2 = to_numpy(th2)[:m], to_numpy(t2)[:m]
        # write back submap poses and deactivate rejected loops
        n_odo = m - 1
        inl = to_numpy(inlier)[n_odo: n_odo + len(self.loops)]
        for k, l in enumerate(self.loops):
            if not inl[k]:
                self.loops[k] = l._replace(valid=False)
        # the current body pose rides its submap
        cur = self.submaps[-1]
        th_sb, t_sb = cur.world_to_submap(self.theta_wb, self.t_wb)
        for k, s in enumerate(self.submaps):
            old_sm = (s.theta_ws, s.t_ws)
            s.theta_ws = float(th2[k])
            s.t_ws = t2[k]
            # the seed ring (world poses) rides its submap's rigid correction
            dck = _np_se2_compose(s.theta_ws, s.t_ws, *_np_se2_inverse(*old_sm))
            s.recent = [
                (xy, v) + (lambda p: (float(p[0]), np.asarray(p[1], np.float32)))(
                    _np_se2_compose(*dck, th_r, t_r))
                for (xy, v, th_r, t_r) in s.recent]
        old_th, old_t = self.theta_wb, self.t_wb
        th_w, t_w = cur.submap_to_world(th_sb, t_sb)
        self.theta_wb, self.t_wb = float(th_w), np.asarray(t_w, np.float32)
        # the same rigid correction for the motion-model memory
        dcorr = _np_se2_compose(self.theta_wb, self.t_wb, *_np_se2_inverse(old_th, old_t))
        self.last_theta, self.last_t = (lambda p: (p[0], np.asarray(p[1], np.float32)))(
            _np_se2_compose(*dcorr, self.last_theta, self.last_t))
        th_kf, t_kf = _np_se2_compose(*dcorr, self.last_kf_theta, self.last_kf_t)
        self.last_kf_theta, self.last_kf_t = th_kf, np.asarray(t_kf, np.float32)

    # -- export ---------------------------------------------------------------
    def global_occupancy(self):
        """Stitched global map (ShowGlobalMap analog): a list of (counts numpy,
        theta_ws, t_ws) per submap for external rendering."""
        return [(to_numpy(s.grid.counts), s.theta_ws, s.t_ws.copy()) for s in self.submaps]
