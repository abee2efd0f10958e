"""Device-resident 2D submap SLAM (port of
loc_lib_tpu/pipeline/mapping2d_device.py).

  * `Mapping2dDeviceState`: the CURRENT submap's occupancy counts and
    likelihood field, its SE(2) pose, the body pose and motion memory, and
    a global ring of the last `seed_frames` keyframe scans (sensor frame +
    world pose) for seeding the next submap, all on the device; the counts
    the host decides on (frames, keyframes in the submap, keyframes pushed)
    are host ints.
  * `step_scan`: the per-scan flow (guess, field match, pose update, the
    keyframe test; on a keyframe the occupancy carve, the field and the
    ring push). The reference's `lax.cond` is a host branch on one read of
    the keyframe flag.
  * `Mapping2DDevice`: the host side reduced to submap lifecycle and loop
    bookkeeping with one pull per scan. Expansion archives the device grid
    into a host `Submap` record and re-seeds the state from the ring
    (`expand_state`); loop detection, multires re-registration and the
    SE(2) pose graph are `Mapping2D`'s over the archived submaps.

Tensors are never written in place: `step_scan` and `expand_state` build new
state tensors, so an archived submap keeps the very tensors the live state
held (no copy), and the pipelined mode's `state_before` stays valid.

Deviation from the host-driven twin, kept from the reference: the seed ring
is GLOBAL (the last `seed_frames` keyframes whatever their submap) and rides
the CURRENT submap's correction after a pose-graph solve.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import grid2d
from ..utils import lie, mathx
from .mapping2d import Mapping2D, Mapping2dOptions, Submap, _on, _scalar, to_numpy


class Mapping2dDeviceState(NamedTuple):
    # current submap
    counts: torch.Tensor       # (H, W) int32
    touched: torch.Tensor      # (H, W) bool
    field: torch.Tensor        # (H, W) float32
    theta_ws: torch.Tensor     # () submap pose in world
    t_ws: torch.Tensor         # (2,)
    num_frames: int            # keyframes in the current submap
    # global seed ring: last S keyframes (sensor-frame scan + world pose)
    recent_xy: torch.Tensor    # (S, B, 2)
    recent_valid: torch.Tensor  # (S, B)
    recent_th: torch.Tensor    # (S,)
    recent_t: torch.Tensor     # (S, 2)
    recent_count: int          # keyframes ever pushed
    # body pose + motion-model memory
    theta_wb: torch.Tensor
    t_wb: torch.Tensor
    last_theta: torch.Tensor
    last_t: torch.Tensor
    last_kf_theta: torch.Tensor
    last_kf_t: torch.Tensor
    frame_count: int


class StepOut(NamedTuple):
    theta: torch.Tensor
    t: torch.Tensor
    is_keyframe: bool
    oob_frac: torch.Tensor     # the expansion trigger
    num_frames: int            # submap keyframe count AFTER this scan
    num_effective: torch.Tensor
    inlier_ratio: torch.Tensor
    converged: torch.Tensor


def init_state(opts: Mapping2dOptions, num_beams: int = 720, theta_ws: float = 0.0,
               t_ws=np.zeros(2), device=None) -> Mapping2dDeviceState:
    """An empty submap at (theta_ws, t_ws), the body at the origin, on
    `device` (default: the card)."""
    g = grid2d.empty_grid(opts.grid, device)
    dev = g.counts.device
    s = opts.seed_frames
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return Mapping2dDeviceState(
        counts=g.counts, touched=g.touched, field=grid2d.likelihood_field(g, opts.grid),
        theta_ws=_scalar(theta_ws, dev), t_ws=_on(np.asarray(t_ws, np.float32), dev),
        num_frames=0,
        recent_xy=z(s, num_beams, 2),
        recent_valid=torch.zeros((s, num_beams), dtype=torch.bool, device=dev),
        recent_th=z(s), recent_t=z(s, 2), recent_count=0,
        theta_wb=z(), t_wb=z(2), last_theta=z(), last_t=z(2), last_kf_theta=z(),
        last_kf_t=z(2), frame_count=0)


def _keyframe_angle(opts: Mapping2dOptions) -> float:
    return float(np.deg2rad(np.float32(opts.keyframe_angle_deg)))


def step_scan(state: Mapping2dDeviceState, scan_xy: torch.Tensor, valid: torch.Tensor,
              opts: Mapping2dOptions):
    """ProcessScan (mapping_2d.cpp:65-130): guess, match, pose update, and
    on a keyframe the raster + field regen and the ring push. Returns (new
    state, StepOut); `state` is not modified."""
    first = state.frame_count == 0
    guess_th = state.theta_wb + lie.wrap_angle(state.theta_wb - state.last_theta)
    guess_t = state.t_wb + (state.t_wb - state.last_t)

    inv_th, inv_t = lie.se2_inverse(state.theta_ws, state.t_ws)
    th0, t0 = lie.se2_compose(inv_th, inv_t, guess_th, guess_t)
    res = grid2d.align_gauss_newton(state.field, opts.grid, scan_xy, valid, th0, t0, opts.align)
    if first:
        th_w, t_w = state.theta_wb, state.t_wb
    else:
        th_w, t_w = lie.se2_compose(state.theta_ws, state.t_ws, res.theta, res.t)
        th_w = lie.wrap_angle(th_w)

    d = torch.linalg.vector_norm(t_w - state.last_kf_t)
    a = torch.abs(lie.wrap_angle(th_w - state.last_kf_theta))
    is_kf = first or bool((d > opts.keyframe_dist) | (a > _keyframe_angle(opts)))  # one read

    state = state._replace(last_theta=state.theta_wb, last_t=state.t_wb, theta_wb=th_w, t_wb=t_w,
                           frame_count=state.frame_count + 1)
    if is_kf:
        ith, it = lie.se2_inverse(state.theta_ws, state.t_ws)
        th_sb, t_sb = lie.se2_compose(ith, it, th_w, t_w)
        pts = lie.se2_apply(th_sb, t_sb, scan_xy)
        grid, field = grid2d.add_scan_and_field(
            grid2d.OccupancyGrid(counts=state.counts, touched=state.touched), opts.grid, pts,
            valid, t_sb)
        slot = state.recent_count % state.recent_xy.shape[0]
        state = state._replace(
            counts=grid.counts, touched=grid.touched, field=field,
            num_frames=state.num_frames + 1,
            recent_xy=mathx.ring_put(state.recent_xy, slot, scan_xy),
            recent_valid=mathx.ring_put(state.recent_valid, slot, valid),
            recent_th=mathx.ring_put(state.recent_th, slot, th_w),
            recent_t=mathx.ring_put(state.recent_t, slot, t_w),
            recent_count=state.recent_count + 1, last_kf_theta=th_w, last_kf_t=t_w)

    # expansion trigger geometry (the host decides)
    ith, it = lie.se2_inverse(state.theta_ws, state.t_ws)
    th_sb, t_sb = lie.se2_compose(ith, it, th_w, t_w)
    oob = grid2d.out_of_bounds_fraction(opts.grid, lie.se2_apply(th_sb, t_sb, scan_xy), valid)
    return state, StepOut(theta=th_w, t=t_w, is_keyframe=is_kf, oob_frac=oob,
                          num_frames=state.num_frames, num_effective=res.num_effective,
                          inlier_ratio=res.inlier_ratio, converged=res.converged)


def expand_state(state: Mapping2dDeviceState, opts: Mapping2dOptions) -> Mapping2dDeviceState:
    """ExpandSubmap on the device state (mapping_2d.cpp:154-184 +
    SetOccuFromOtherSubmap): a fresh grid at the CURRENT body pose, seeded
    by the ring's keyframes (oldest first, re-expressed in the new frame),
    then the current scan (the newest ring entry) again at the origin, one
    field regen. The caller archives the old grid before this."""
    s = state.recent_xy.shape[0]
    dev = state.field.device
    th_new, t_new = state.theta_wb, state.t_wb
    inv_th, inv_t = lie.se2_inverse(th_new, t_new)
    count = min(state.recent_count, s)

    # chronological ring order: oldest first
    idx = torch.tensor([(state.recent_count - count + k) % s for k in range(s)], device=dev)
    th_sb, t_sb = lie.se2_compose(inv_th, inv_t, state.recent_th[idx], state.recent_t[idx])
    pts = lie.se2_apply(th_sb, t_sb, state.recent_xy[idx])                 # (S, B, 2)
    r_valid = state.recent_valid[idx]
    grid = grid2d.empty_grid(opts.grid, dev)
    for k in range(count):
        grid = grid2d.add_scan(grid, opts.grid, pts[k], r_valid[k], t_sb[k])
    newest = (state.recent_count - 1) % s
    grid, field = grid2d.add_scan_and_field(
        grid, opts.grid, state.recent_xy[newest], state.recent_valid[newest],
        torch.zeros(2, dtype=torch.float32, device=dev))
    return state._replace(counts=grid.counts, touched=grid.touched, field=field,
                          theta_ws=th_new, t_ws=t_new, num_frames=1)


def _corrected_ring(recent_th, recent_t, old_th, old_t, new_th, new_t):
    """Apply the body-pose rigid correction dcorr = T_new T_old^-1 to the
    seed ring's world poses; the ring as it was when the correction is
    identity."""
    ith, it = lie.se2_inverse(old_th, old_t)
    cth, ct = lie.se2_compose(new_th, new_t, ith, it)
    moved = (torch.abs(lie.wrap_angle(cth)) > 1e-9) | (torch.linalg.vector_norm(ct) > 1e-9)
    th2, t2 = lie.se2_compose(cth, ct, recent_th, recent_t)
    th2 = lie.wrap_angle(th2)
    return torch.where(moved, th2, recent_th), torch.where(moved, t2, recent_t)


class Mapping2DDevice(Mapping2D):
    """Device-resident drop-in for `Mapping2D`: the same public surface
    (process_scan / submaps / loops / optimize / global_occupancy), one
    pull per scan. The write-back of a pose-graph solve also pushes the
    corrected poses into the device state.

    `pipelined=True`: lag-1 mode. process_scan returns the PREVIOUS scan's
    pose (None on the first call) and `flush()` returns the last one; when
    handling scan k-1 changes the device state (an expansion or a loop
    write-back), scan k is replayed from the changed state, so the poses
    equal sequential mode's bit for bit (`replays` counts them).
    `warm_start` is accepted and does nothing (the JAX engine warms its
    compiled loop-closure programs; nothing here is compiled)."""

    def __init__(self, opts: Mapping2dOptions = Mapping2dOptions(), num_beams: int = 720,
                 warm_start: bool = True, pipelined: bool = False, device=None):
        super().__init__(opts, device)
        self.dstate = init_state(opts, num_beams=num_beams, device=self.device)
        self.pipelined = pipelined
        self._pend = None
        self.replays = 0       # lifecycle replays performed (observable)

    def _step(self, scan_xy, valid):
        return step_scan(self.dstate, _on(scan_xy, self.device), _on(valid, self.device),
                         self.opts)

    # -- per-scan -----------------------------------------------------------
    def process_scan(self, scan_xy: np.ndarray, valid: np.ndarray):
        if self.pipelined:
            return self._process_scan_pipelined(scan_xy, valid)
        self.dstate, out = self._step(scan_xy, valid)
        self._apply_result(scan_xy, valid, out)
        return self.theta_wb, self.t_wb.copy()

    def _apply_result(self, scan_xy, valid, out: StepOut) -> bool:
        """Pull one StepOut, run the host mirror updates, the submap
        lifecycle and loop detection. Returns True when the lifecycle
        changed the DEVICE state (expansion, or a loop write-back): the
        signal the pipelined mode replays on."""
        pose = torch.cat([out.theta.reshape(1), out.t, out.oob_frac.reshape(1)]).cpu().numpy()
        state_at_entry = self.dstate
        # host mirrors evolve by the same update rules as the device state
        self.last_theta, self.last_t = self.theta_wb, self.t_wb
        self.theta_wb, self.t_wb = float(pose[0]), np.asarray(pose[1:3], np.float32)
        self.frame_poses.append((self.theta_wb, self.t_wb.copy()))

        if out.is_keyframe:
            self.last_kf_theta, self.last_kf_t = self.theta_wb, self.t_wb
            cur = self.submaps[-1]
            cur.num_frames = out.num_frames
            cur.frame_ids.append(self.frame_count)
            if float(pose[3]) > 0.1 or out.num_frames > self.opts.max_keyframes_in_submap:
                self._expand_device()
            self._detect_loops(scan_xy, valid)
        self.frame_count += 1
        return self.dstate is not state_at_entry

    def _process_scan_pipelined(self, scan_xy, valid):
        """Lag-1: step scan k, then handle scan k-1's result (replaying k if
        that changed the device state). Returns scan k-1's pose."""
        state_before = self.dstate
        self.dstate, out = self._step(scan_xy, valid)
        cur = {"xy": scan_xy, "valid": valid, "out": out, "state_before": state_before}
        res = None
        if self._pend is not None:
            res = self._finish_pending(cur)
        self._pend = cur
        return res

    def _finish_pending(self, cur):
        """Handle the pending scan's result; replay `cur`'s step if the
        lifecycle changed the device state. Returns the pending pose."""
        p = self._pend
        post_cur_state = self.dstate
        # the host logic sees the state as of AFTER the pending scan: the
        # state `cur` was stepped from (or the current one at flush)
        self.dstate = cur["state_before"] if cur is not None else self.dstate
        mutated = self._apply_result(p["xy"], p["valid"], p["out"])
        if cur is not None:
            if mutated:
                self.replays += 1
                cur["state_before"] = self.dstate
                self.dstate, cur["out"] = self._step(cur["xy"], cur["valid"])
            else:
                self.dstate = post_cur_state
        return self.theta_wb, self.t_wb.copy()

    def flush(self):
        """Drain the pipelined tail: handle the last pending scan. Returns
        its pose (the current pose in sequential mode)."""
        if self._pend is None:
            return self.theta_wb, self.t_wb.copy()
        res = self._finish_pending(None)
        self._pend = None
        return res

    # -- submap lifecycle ---------------------------------------------------
    def _expand_device(self) -> None:
        """Archive the device grid into the current host Submap record (the
        live tensors become the archive's: nothing writes them in place),
        then re-seed the device state as the new submap. Past
        `archived_device_submaps` archives, the oldest spill to host numpy;
        `Submap.match_multires` moves a spilled field back to the device."""
        cur = self.submaps[-1]
        cur.grid = grid2d.OccupancyGrid(counts=self.dstate.counts, touched=self.dstate.touched)
        cur.field = self.dstate.field
        new = Submap(self.opts, self.theta_wb, self.t_wb, len(self.submaps), self.device)
        new.num_frames = 1
        self.submaps.append(new)
        self.dstate = expand_state(self.dstate, self.opts)
        budget = self.opts.archived_device_submaps
        # budget 0 keeps no archive on the device
        spill = self.submaps[:-1][:-budget] if budget > 0 else self.submaps[:-1]
        for sm in spill:
            if isinstance(sm.field, torch.Tensor):
                sm.grid = grid2d.OccupancyGrid(counts=to_numpy(sm.grid.counts),
                                               touched=to_numpy(sm.grid.touched))
                sm.field = to_numpy(sm.field)

    # -- pose-graph write-back ----------------------------------------------
    def optimize(self):
        old_th, old_t = self.theta_wb, np.asarray(self.t_wb, np.float32)
        super().optimize()
        # push the corrected poses into the device state
        cur = self.submaps[-1]
        dev = self.device
        self.dstate = self.dstate._replace(
            theta_ws=_scalar(cur.theta_ws, dev), t_ws=_on(np.asarray(cur.t_ws, np.float32), dev),
            theta_wb=_scalar(self.theta_wb, dev),
            t_wb=_on(np.asarray(self.t_wb, np.float32), dev),
            last_theta=_scalar(self.last_theta, dev),
            last_t=_on(np.asarray(self.last_t, np.float32), dev),
            last_kf_theta=_scalar(self.last_kf_theta, dev),
            last_kf_t=_on(np.asarray(self.last_kf_t, np.float32), dev))
        # the (global) seed ring rides the CURRENT submap's correction: exact
        # for ring entries of the current submap, off by the inter-submap
        # correction difference for older ones (the host twin corrects each
        # Submap.recent by its own submap)
        new_th, new_t = _corrected_ring(
            self.dstate.recent_th, self.dstate.recent_t, _scalar(old_th, dev),
            _on(old_t, dev), _scalar(self.theta_wb, dev),
            _on(np.asarray(self.t_wb, np.float32), dev))
        self.dstate = self.dstate._replace(recent_th=new_th, recent_t=new_t)

    # -- export --------------------------------------------------------------
    def global_occupancy(self):
        out = [(to_numpy(s.grid.counts), s.theta_ws, s.t_ws.copy()) for s in self.submaps[:-1]]
        out.append((to_numpy(self.dstate.counts), float(self.dstate.theta_ws),
                    to_numpy(self.dstate.t_ws)))
        return out
