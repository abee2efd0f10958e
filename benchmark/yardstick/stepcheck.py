"""The comparison that decides `correct`: a sample of the window's scans,
each re-done by the plain reference from the program's filter state before
it, against what the program produced.

Why step by step: these engines run free, and float32 rounding steers a
free run (a one-ulp nudge moves the reference's own free run by decimetres
over a log), so two free runs cannot be compared pose for pose. The
reference therefore starts each sampled scan from the program's own ESKF
state before that scan, and works out again everything else the program
derived: the filtered scan from the raw one, the target from the raw scans
of the keyframes (or the prior map's crop) at the poses the program
reported, the keyframe and re-crop decisions from those poses, the IMU
propagation, the match and the update. The stage this skips, the filter
state carried between samples, is checked by itself: the whole state the
program leaves after each sampled scan (the pose, the velocity, the biases,
gravity and the covariance) is held to the reference's, and the engine's
first scan, always in the sample, starts from the reference's own initial
state (the static IMU initialisation, or the given initial pose). The
sample is chosen while the window runs (`Sampler`), so only the sampled
scans' device state is held.

Numbers compared, each the widest over the sample:
  pose_rms_m  the reported pose's gap to the reference's, as the root mean square
              of the point-to-plane residuals it moves: sqrt(dx^T H dx / n), dx
              the rotation (body) and translation gaps, H and n the reference's
              normal matrix and count at its match. A gap along a direction the
              scan's geometry leaves unconstrained moves no residual and counts
              for nothing (there the pose is rounding's to choose: a world
              whose kept half-scan sees walls of one direction makes the
              reference's own free run slide along them as well)
  chi2_rel  relative gap of the sum of squared residuals at the program's last GN
            linearization (the reference's linearization of the same index)
  neff_rel  relative gap of that linearization's count of matched points
  state_rel largest gap of the velocity, the gyro and accelerometer biases and
            gravity after the scan to the reference's update of the same
            prediction that leaves the pose where the program put it, each
            field's widest gap over the larger of its size and its standard
            deviation in the reference's covariance; over the window's scans
            (at the engine's first scan the position's variance is still its
            initial 1e-4 m^2, so the update's velocity gain is tens of times its
            position gain, and the float32 rounding of a position tens of metres
            from the origin would read as a velocity gap)
  cov_rel   largest gap of the filter's covariance after the scan, over its largest entry

The gap to the ground truth is logged and not compared: it measures the
algorithm on the world a seed draws (where the half-scan the filter keeps
sees only walls of one direction, the reference's algorithm drifts along
them as well), not whether the program computes what the reference does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import reference as ref

NUMBERS = ("pose_rms_m", "chi2_rel", "neff_rel", "state_rel", "cov_rel")
STATE_FIELDS = (("v", 3), ("bg", 9), ("ba", 12), ("g", 15))   # field, its first row in cov


class Kept(NamedTuple):
    """What the check needs of one sampled scan, kept from the window: the
    IMU packet it came with, the filter state before and after it, and the
    step's result (device tensors, read after the window)."""

    packet: tuple
    prev: object
    eskf: object
    result: object


class ScanView(NamedTuple):
    """One scan as the check reads it: the raw scan's index `src`, the
    reported pose, whether the engine rebuilt its target, the latency, the
    program's GN iterations (None where it does not tell them), and, for a
    sampled scan, what `Kept` holds (None otherwise)."""

    src: int
    pose: np.ndarray
    rebuilt: bool
    ms: float
    failed: bool
    iters: object
    packet: object = None
    prev: object = None
    eskf: object = None
    result: object = None


class ScanLog:
    """What the harness keeps of every scan, in preallocated arrays (no
    object a scan, so the window's host work does not grow with its
    length), and `kept`: the `Kept` of the scans the check re-does."""

    def __init__(self, capacity: int = 4096):
        self.n = 0
        self.src = np.zeros(capacity, np.int64)
        self.pose = np.zeros((capacity, 4, 4))
        self.ms = np.zeros(capacity)
        self.start = np.zeros(capacity)         # host clock at the start of the hand-over, s
        self.failed = np.zeros(capacity, bool)
        self.rebuilt = np.zeros(capacity, bool)
        self.iters = np.full(capacity, -1, np.int64)
        self.kept: dict = {}

    def append(self, src, pose, rebuilt, ms, start, failed, iters) -> int:
        i = self.n
        if i == len(self.ms):
            for name in ("src", "pose", "ms", "start", "failed", "rebuilt", "iters"):
                a = getattr(self, name)
                setattr(self, name, np.concatenate([a, np.zeros_like(a)]))
        self.src[i], self.pose[i], self.rebuilt[i] = src, pose, rebuilt
        self.ms[i], self.start[i], self.failed[i] = ms, start, failed
        self.iters[i] = -1 if iters is None else iters
        self.n = i + 1
        return i

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> ScanView:
        if not 0 <= i < self.n:
            raise IndexError(i)
        k = self.kept.get(i)
        it = int(self.iters[i])
        return ScanView(int(self.src[i]), self.pose[i], bool(self.rebuilt[i]), float(self.ms[i]),
                        bool(self.failed[i]), None if it < 0 else it,
                        *((k.packet, k.prev, k.eskf, k.result) if k else ()))

    def __iter__(self):
        return (self[i] for i in range(self.n))


class Sampler:
    """Chooses, while the window runs, the scans the check re-does: `count`
    drawn uniformly from the seed among the window's sound scans (reservoir
    sampling), and the slowest. `offer` says whether to keep a scan and which
    kept scans are no longer chosen, so only the chosen are held."""

    def __init__(self, count: int, seed: int):
        self.count, self.rng = count, np.random.default_rng(seed)
        self.pool, self.seen = [], 0
        self.slowest, self.slowest_ms = None, -1.0

    def offer(self, i: int, ms: float) -> tuple:
        """(keep scan i, ordinals to let go)."""
        self.seen += 1
        kept, drop = False, []
        if len(self.pool) < self.count:
            self.pool.append(i)
            kept = True
        else:
            r = int(self.rng.integers(self.seen))
            if r < self.count:
                old, self.pool[r], kept = self.pool[r], i, True
                if old != self.slowest:
                    drop.append(old)
        if ms > self.slowest_ms:
            old, self.slowest, self.slowest_ms = self.slowest, i, ms
            kept = True
            if old is not None and old not in self.pool:
                drop.append(old)
        return kept, drop

    def chosen(self) -> list:
        return sorted(set(self.pool) | ({self.slowest} if self.slowest is not None else set()))


class Run(NamedTuple):
    cfg: dict
    raw: np.ndarray            # (S, P, 3) float32 raw scans, by src
    scans: ScanLog             # every scan since the engine started
    window: range              # ordinals of the window's scans
    sample: list               # ordinals the check re-does: 0, then the window's chosen
    truth: np.ndarray          # (S, 4, 4) true poses by src, in the engine's frame
    first_pose: np.ndarray     # the engine's starting pose, world frame
    static: tuple              # the stationary IMU window (stamps, gyro, acce)
    prior_map: object          # (M, 3) float32 host array, or None


def icp_opts(cfg: dict) -> dict:
    return {k: cfg["engine_options"][k] for k in
            ("max_iteration", "eps", "max_plane_distance", "min_effective_pts")}


class Checker:
    """Re-does sampled scans in one arithmetic (`prec`), caching the
    filtered scans and the targets it builds."""

    def __init__(self, run: Run, refmod, prec: ref.Prec, device):
        self.run, self.refmod, self.prec, self.device = run, refmod, prec, device
        self.e = run.cfg["engine_options"]
        self.keys = refmod.context(run)
        self._filtered, self._targets = {}, {}

    def filtered(self, src: int) -> torch.Tensor:
        if src not in self._filtered:
            raw = torch.from_numpy(self.run.raw[src]).to(self.device)
            self._filtered[src] = ref.filter_scan(raw, self.prec, self.e["scan_filter_leaf"],
                                                  self.e["scan_capacity"])
        return self._filtered[src]

    def target(self, i: int) -> ref.Target:
        key = self.keys[i]
        if key not in self._targets:
            if len(self._targets) > 8:
                self._targets.clear()
            self._targets[key] = self.refmod.build(self, key)
        return self._targets[key]

    def step(self, i: int):
        """The reference's scan i from the program's filter state before it
        (from its own initial state for the first scan): (pose R, pose t,
        Match, filter state after, filter state before the update or None
        where the scan takes none)."""
        p = self.prec
        sc = self.run.scans[i]
        s = self.refmod.initial_state(self) if i == 0 else ref.Eskf.of(sc.prev, p)
        s = ref.predict(s, sc.packet[0], sc.packet[1], sc.packet[2], sc.packet[3],
                        self.e["eskf"], p)
        dev = self.device
        m = ref.gauss_newton(self.target(i), self.filtered(sc.src), s.R.to(dev), s.p.to(dev),
                             icp_opts(self.run.cfg), p, sc.iters)
        if i == 0 and self.refmod.FIRST_SCAN_UNMATCHED:
            # the first scan only seeds the map: its pose is the identity
            return torch.eye(3, dtype=p.dtype), torch.zeros(3, dtype=p.dtype), m, s, None
        after = ref.observe_pose(s, m.R.cpu(), m.t.cpu(), self.e["eskf"], p)
        return after.R, after.p, m, after, s


def pose_rms(R, t, m: ref.Match, R_ref, t_ref) -> float:
    """sqrt(dx^T H dx / n): the RMS residual the pose gap (R, t) - (R_ref,
    t_ref) moves, in the metric of the reference's match `m`."""
    f = lambda x: torch.as_tensor(x).to(torch.float64).cpu()
    dx = torch.cat([ref.so3_log(f(R_ref).T @ f(R)), f(t) - f(t_ref)])
    return math.sqrt(max(float(dx @ f(m.H) @ dx), 0.0) / max(m.n, 1))


def state_gaps(s: ref.Eskf, s_ref: ref.Eskf, s_pred, eskf_opts: dict, in_window: bool) -> dict:
    """state_rel (for a window scan) and cov_rel of the filter state `s`
    after a scan against the reference's `s_ref`. The velocity, biases and
    gravity are held to the float64 update of the reference's predicted
    state `s_pred` that leaves the pose where `s` has it
    (`ref.implied_update`; `s_ref` itself where the scan takes no update):
    the pose's own gap is pose_rms_m's."""
    f = lambda x: x.detach().to(torch.float64).cpu()
    cov_r = f(s_ref.cov)
    if s_pred is not None:
        s_pred = ref.Eskf(*(f(x) for x in s_pred))
        s_ref = ref.implied_update(s_pred, f(s.R), f(s.p), eskf_opts)
    worst = 0.0
    for name, row in STATE_FIELDS:
        a, b = f(getattr(s, name)), f(getattr(s_ref, name))
        sd = math.sqrt(max(float(torch.max(torch.diagonal(cov_r)[row:row + 3])), 0.0))
        worst = max(worst, float(torch.max(torch.abs(a - b))) / max(float(torch.max(torch.abs(b))),
                                                                    sd, 1e-30))
    return {**({"state_rel": worst} if in_window else {}),
            "cov_rel": float(torch.max(torch.abs(f(s.cov) - cov_r)) / torch.max(torch.abs(cov_r)))}


def readings(ck: Checker, i: int) -> dict:
    """The numbers of one sampled scan (program against `ck`'s arithmetic)."""
    R, t, m, s, s_pred = ck.step(i)
    sc = ck.run.scans[i]
    pose = sc.pose.astype(np.float64)
    return {
        "pose_rms_m": pose_rms(pose[:3, :3], pose[:3, 3], m, R, t),
        "chi2_rel": abs(float(sc.result.chi2) - m.chi2) / max(m.chi2, 1e-30),
        "neff_rel": abs(float(sc.result.num_effective) - m.count) / max(m.count, 1),
        **state_gaps(ref.Eskf.of(sc.eskf, ref.Prec()), s, s_pred, ck.e["eskf"], i > 0),
    }


def truth_gap(run: Run) -> tuple:
    """(widest translation gap of a window scan's reported pose to the ground
    truth, in the engine's frame; that gap over the distance travelled
    since the engine started, the widest such share)."""
    log, w = run.scans, np.asarray(run.window)
    t = run.truth[log.src[:log.n], :3, 3]
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(t, axis=0), axis=1))])
    gaps = np.linalg.norm(log.pose[w, :3, 3] - t[w], axis=1)
    share = gaps / np.maximum(dist[w], 1e-9)
    return float(np.max(gaps, initial=0.0)), float(np.max(share, initial=0.0))


def compare(run: Run, refmod, device, tf32: bool = False) -> dict:
    """The widest of each number over the sample, with the program in the
    place of the measured side; `tf32` puts the reference in TF32 there
    instead (the control), which reads the same sample against the float64
    reference."""
    base = Checker(run, refmod, ref.Prec(), device)
    out = {k: 0.0 for k in NUMBERS}
    ctrl = Checker(run, refmod, ref.Prec(tf32=True), device) if tf32 else None
    for i in run.sample:
        if ctrl is None:
            r = readings(base, i)
        else:
            r = control_readings(base, ctrl, i)
        for k, v in r.items():
            out[k] = max(out[k], v if math.isfinite(v) else math.inf)
    return out


def control_readings(base: Checker, ctrl: Checker, i: int) -> dict:
    """The numbers of one sampled scan with the TF32 reference in the
    program's place."""
    R, t, m, s, s_pred = base.step(i)
    Rc, tc, mc, sc, _ = ctrl.step(i)
    return {
        "pose_rms_m": pose_rms(Rc, tc, m, R, t),
        "chi2_rel": abs(mc.chi2 - m.chi2) / max(m.chi2, 1e-30),
        "neff_rel": abs(mc.count - m.count) / max(m.count, 1),
        **state_gaps(sc, s, s_pred, base.e["eskf"], i > 0),
    }
