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

The GN count the match is replayed at is the one the step's result
carries (`iterations`): the front end's own, whatever else the engine's
step matched. A count the match cannot have made (under 1, or over
max_iteration) names no linearization to compare, and chi2_rel and neff_rel
read inf; a wrong count within that range shows only where the match had
not converged by then.

An engine with a back end (a loop registration, a pose-graph solve, a
correction of the front end) hands its events to the harness
(`engines/<engine>.py`'s `events()`). Every correction is kept
(`Corrections`): the reference applies them where the program did, to the
keyframe poses its targets are built from and to the filter state the
program reports after the scan that took one. Of the events a sample is
held (`EventSampler`), and their scans join the front end's sample; where
the reference module defines `backend_readings(run, event, prec, device)`
each is re-done with it, and the widest of each of its numbers over the
events joins the five above, held to the configuration's limit of that
name.

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


def on_host(x):
    """A tensor as a host array (a 0-d one as a Python number); anything
    else as it is."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.item() if x.dim() == 0 else x.numpy()
    return x


class Sampler:
    """Chooses, while the window runs, what the check re-does: `count` items
    drawn uniformly from the seed among the window's (reservoir sampling),
    and every item of the slowest scan. Items are whole numbers: a scan's
    ordinal here, an event's serial number in `EventSampler`. `offer_all`
    says which of a scan's items to keep and which kept items are no longer
    chosen, so only the chosen are held."""

    def __init__(self, count: int, seed: int, stream: tuple = ()):
        self.count, self.rng = count, np.random.default_rng((seed, *stream) if stream else seed)
        self.pool, self.seen = [], 0
        self.slowest, self.slowest_ms = [], -1.0

    def offer_all(self, items: list, ms: float) -> tuple:
        """(items to keep, items to let go) of one scan's `items`."""
        gone = []
        for i in items:
            self.seen += 1
            if len(self.pool) < self.count:
                self.pool.append(i)
            else:
                r = int(self.rng.integers(self.seen))
                if r < self.count:
                    gone.append(self.pool[r])
                    self.pool[r] = i
        if ms > self.slowest_ms:
            gone += self.slowest
            self.slowest, self.slowest_ms = list(items), ms
        return ([i for i in items if self.chooses(i)],
                [i for i in dict.fromkeys(gone) if i not in items and not self.chooses(i)])

    def offer(self, i: int, ms: float) -> tuple:
        """(keep scan i, ordinals to let go)."""
        kept, drop = self.offer_all([i], ms)
        return bool(kept), drop

    def chooses(self, i: int) -> bool:
        return i in self.pool or i in self.slowest

    def chosen(self) -> list:
        return sorted(set(self.pool) | set(self.slowest))


class EventSampler(Sampler):
    """Chooses, while the window runs, the back-end events the check re-does
    (`Sampler` over the events, from its own stream of the seed) and holds
    only those. Events are dicts with a "kind"; their tensors stay where the
    engine made them until `chosen` moves them to the host, after the
    window. The chosen carry the ordinal of their scan under "scan", and
    their scans join the front end's sample (`scans`)."""

    def __init__(self, count: int, seed: int):
        super().__init__(count, seed, (1,))
        self.held = {}

    def offer_events(self, i: int, ms: float, events: list) -> tuple:
        """(an event of scan i is held, scans of which no event is held any more)."""
        first = self.seen
        kept, drop = self.offer_all(list(range(first, first + len(events))), ms)
        for k in kept:
            self.held[k] = {**events[k - first], "scan": i}
        gone = {self.held.pop(k)["scan"] for k in drop}
        return bool(kept), sorted(gone - self.scans())

    def scans(self) -> set:
        """The scans of the held events."""
        return {e["scan"] for e in self.held.values()}

    def chosen(self) -> list:
        """The chosen events on the host, in the order they came."""
        return [{k: on_host(v) for k, v in self.held[j].items()} for j in super().chosen()]


class Corrections:
    """Every correction (dR, dt) the back end applied to the front end's live
    poses, with the ordinal of the scan after whose step it came: the
    front end's world poses T became (dR, dt) T there. A correction the
    engine hands over as device tensors stays there until the check first
    reads `scan` or `T`, after the window."""

    def __init__(self):
        self._new = []
        self._scan, self._T = np.zeros(0, np.int64), np.zeros((0, 4, 4))

    def append(self, i: int, dR, dt) -> None:
        self._new.append((i, dR, dt))

    def _settle(self) -> None:
        if self._new:
            T = np.tile(np.eye(4), (len(self._new), 1, 1))
            for k, (_, dR, dt) in enumerate(self._new):
                T[k, :3, :3], T[k, :3, 3] = on_host(dR), on_host(dt)
            self._scan = np.append(self._scan, [i for i, _, _ in self._new])
            self._T = np.concatenate([self._T, T])
            self._new = []

    @property
    def scan(self) -> np.ndarray:
        self._settle()
        return self._scan

    @property
    def T(self) -> np.ndarray:
        self._settle()
        return self._T

    def __len__(self) -> int:
        return len(self._scan) + len(self._new)

    def between(self, a: int, b: int) -> np.ndarray:
        """The corrections that came after the steps of scans a .. b - 1,
        composed (the later on the left): what they did to a pose the
        front end held from scan a's step to scan b's."""
        T = np.eye(4)
        for k in np.nonzero((self.scan >= a) & (self.scan < b))[0]:
            T = self._T[k] @ T
        return T


class Run(NamedTuple):
    cfg: dict
    raw: np.ndarray            # (S, P, 3) float32 raw scans, by src
    scans: ScanLog             # every scan since the engine started
    window: range              # ordinals of the window's scans
    sample: list               # ordinals re-done: 0, the window's chosen, the events' scans
    truth: np.ndarray          # (S, 4, 4) true poses by src, in the engine's frame
    first_pose: np.ndarray     # the engine's starting pose, world frame
    static: tuple              # the stationary IMU window (stamps, gyro, acce)
    prior_map: object          # (M, 3) float32 host array, or None
    corrections: Corrections   # every correction the back end applied (none without one)
    events: list               # the back-end events the check re-does


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


def uncorrected(s: ref.Eskf, T: np.ndarray) -> ref.Eskf:
    """The float64 filter state `s` as it was before the correction T moved
    it: the nominal pose and velocity taken back by T's inverse (a
    correction leaves the biases, gravity and the covariance as they are)."""
    Rt = torch.from_numpy(T[:3, :3].T.copy())
    return s._replace(R=Rt @ s.R, p=Rt @ (s.p - torch.from_numpy(T[:3, 3].copy())), v=Rt @ s.v)


def readings(ck: Checker, i: int) -> dict:
    """The numbers of one sampled scan (program against `ck`'s arithmetic)."""
    R, t, m, s, s_pred = ck.step(i)
    sc = ck.run.scans[i]
    pose = sc.pose.astype(np.float64)
    after = ref.Eskf.of(sc.eskf, ref.Prec())
    if np.any(ck.run.corrections.scan == i):
        after = uncorrected(after, ck.run.corrections.between(i, i + 1))
    # a count no front-end match can make names no linearization of the reference's
    count_ok = sc.iters is None or 1 <= sc.iters <= ck.e["max_iteration"]
    return {
        "pose_rms_m": pose_rms(pose[:3, :3], pose[:3, 3], m, R, t),
        "chi2_rel": (abs(float(sc.result.chi2) - m.chi2) / max(m.chi2, 1e-30)
                     if count_ok else math.inf),
        "neff_rel": (abs(float(sc.result.num_effective) - m.count) / max(m.count, 1)
                     if count_ok else math.inf),
        **state_gaps(after, s, s_pred, ck.e["eskf"], i > 0),
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
    reference. Where the reference module defines `backend_readings(run,
    event, prec, device)`, each chosen back-end event is re-done with it:
    `prec` is the measured side's arithmetic (float64: the program's event
    as recorded; TF32: the reference in the program's place), and every
    number it reads needs a limit in the configuration."""
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
    backend = getattr(refmod, "backend_readings", None)
    if backend is not None:
        limits, prec = run.cfg["limits"], ref.Prec(tf32=tf32)
        for ev in run.events:
            for k, v in backend(run, ev, prec, device).items():
                if k not in limits:
                    raise KeyError(f"the back-end number {k!r} has no limit in the "
                                   "configuration's limits")
                out[k] = max(out.get(k, 0.0), v if math.isfinite(v) else math.inf)
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
