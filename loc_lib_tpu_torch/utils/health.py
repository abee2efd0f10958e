"""Tracking-health monitor: system-level failure detection.

The reference has only per-solver degeneracy guards (min effective points,
det(H)=0 bail-outs, icp_registration.cpp:94-101) and no system-level
failure detection or recovery story (SURVEY.md section 5 "Failure
detection: none at system level"). This monitor closes that gap for the
host-side wrappers: it watches each scan's match quality and declares the
tracker DEGRADED after `degrade_after` consecutive bad frames and LOST
after `lost_after` — the signal the localization flow uses to trigger
re-initialization (re-seed from GNSS / re-crop) instead of silently
publishing a diverging pose.

A frame is "bad" when the matcher did not converge, its effective-point
count is under `min_effective`, or its mean residual exceeds
`max_chi2_per_point` — the same quality measures the loop-closure
acceptance uses (pipeline/slam3d.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HealthOptions:
    min_effective: int = 100
    max_chi2_per_point: float = 1.0   # [m^2] mean squared residual
    degrade_after: int = 3
    lost_after: int = 10


class TrackingHealth:
    """Host-side monitor; feed it one (converged, n_eff, chi2) per scan."""

    OK = "ok"
    DEGRADED = "degraded"
    LOST = "lost"

    def __init__(self, opts: HealthOptions = HealthOptions()):
        self.opts = opts
        self.consecutive_bad = 0
        self.total_bad = 0
        self.frames = 0

    def update(self, converged: bool, num_effective: int, chi2: float) -> str:
        self.frames += 1
        chi2_pp = chi2 / max(int(num_effective), 1)
        bad = ((not bool(converged))
               or int(num_effective) < self.opts.min_effective
               or chi2_pp > self.opts.max_chi2_per_point)
        if bad:
            self.consecutive_bad += 1
            self.total_bad += 1
        else:
            self.consecutive_bad = 0
        return self.status

    @property
    def status(self) -> str:
        if self.consecutive_bad >= self.opts.lost_after:
            return self.LOST
        if self.consecutive_bad >= self.opts.degrade_after:
            return self.DEGRADED
        return self.OK

    @property
    def needs_reinit(self) -> bool:
        return self.status == self.LOST

    def reset(self) -> None:
        """Call after a successful re-initialization."""
        self.consecutive_bad = 0
