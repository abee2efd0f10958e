"""Plain reference of the test engine (installed as `references/<engine>.py`
beside it): the LIO reference for the front end, which follows the back
end's corrections, and the back end's events re-done in float64.

The back end is followed step by step from the program's own records, as
the front end is from the program's filter state: a registration from its
recorded initial guess against the target the reference builds for its
scan; the solve from the poses and weights it was given (the reported
pose, which the front end's check holds, the registration's, which the
registration's check holds, and the pull); the correction from the poses
it was derived from (the solve's input and output). A pose's gap is
|dt| + LEVER_M |dtheta|: a bound on how far a point within LEVER_M of the
pose moves."""

from __future__ import annotations

import sys

import numpy as np
import torch

from yardstick import cell as cellmod, reference as ref, stepcheck

SOLVE_ITERATIONS = 3
LEVER_M = 10.0

_lio = cellmod.load_module("references", "lio")
FIRST_SCAN_UNMATCHED = _lio.FIRST_SCAN_UNMATCHED
context, build, initial_state = _lio.context, _lio.build, _lio.initial_state

def gap(T, T_ref) -> float:
    f = lambda x: torch.as_tensor(np.asarray(x)).to(torch.float64)
    T, T_ref = f(T), f(T_ref)
    dtheta = float(torch.linalg.vector_norm(ref.so3_log(T_ref[:3, :3].T @ T[:3, :3])))
    return float(torch.linalg.vector_norm(T[:3, 3] - T_ref[:3, 3])) + LEVER_M * dtheta


def register(run, event, prec: ref.Prec, device) -> ref.Match:
    """The registration of the event's scan against its target from the
    recorded initial guess, at the event's iteration count."""
    ck = stepcheck.Checker(run, sys.modules[__name__], prec, device)
    i = event["scan"]
    opts = {**stepcheck.icp_opts(run.cfg), "eps": 0.0,
            "max_iteration": int(run.cfg["backend"]["reg_iterations"])}
    return ref.gauss_newton(ck.target(i), ck.filtered(run.scans[i].src),
                            prec.t(event["R0"], device), prec.t(event["t0"], device), opts, prec,
                            event["iterations"])


def solve(poses, weights, prec: ref.Prec) -> torch.Tensor:
    """The weighted mean of the poses on SO(3) x R^3: SOLVE_ITERATIONS
    Karcher steps from the first's rotation, the translations' weighted
    mean."""
    P, w = prec.t(poses), prec.t(weights)
    R = P[0, :3, :3]
    for _ in range(SOLVE_ITERATIONS):
        d = sum(w[k] * ref.so3_log(prec.mm(R.T, P[k, :3, :3])) for k in range(len(w))) / w.sum()
        R = prec.mm(R, ref.so3_exp(d))
    T = torch.eye(4, dtype=prec.dtype)
    T[:3, :3], T[:3, 3] = R, (w[:, None] * P[:, :3, 3]).sum(dim=0) / w.sum()
    return T


def correction(before, after, prec: ref.Prec) -> torch.Tensor:
    """The rigid motion that takes the pose `before` to `after`."""
    B, A = prec.t(before), prec.t(after)
    C = torch.eye(4, dtype=prec.dtype)
    C[:3, :3] = prec.mm(A[:3, :3], B[:3, :3].T)
    C[:3, 3] = A[:3, 3] - prec.mm(C[:3, :3], B[:3, 3:])[:, 0]
    return C


def backend_readings(run, event, prec: ref.Prec, device) -> dict:
    """The numbers of one back-end event; `prec` is the measured side's
    arithmetic: float64, the program's event as recorded; TF32, the
    reference in the program's place."""
    f64 = ref.Prec()
    kind = event["kind"]
    if kind == "registration":
        m = register(run, event, f64, device)
        if prec.tf32:
            mt = register(run, event, prec, device)
            R, t, count, chi2 = mt.R, mt.t, mt.count, mt.chi2
        else:
            R, t, count, chi2 = event["R"], event["t"], event["num_effective"], event["chi2"]
        return {"reg_pose_rms_m": stepcheck.pose_rms(R, t, m, m.R, m.t),
                "reg_chi2_rel": abs(chi2 - m.chi2) / max(m.chi2, 1e-30),
                "reg_neff_rel": abs(count - m.count) / max(m.count, 1)}
    if kind == "solve":
        want = solve(event["poses"], event["weights"], f64)
        got = solve(event["poses"], event["weights"], prec) if prec.tf32 else event["pose"]
        return {"solve_gap_m": gap(got, want)}
    if kind == "correction":
        before = torch.as_tensor(event["before"]).to(torch.float64)
        want = correction(event["before"], event["after"], f64)
        if prec.tf32:
            C = correction(event["before"], event["after"], prec)
        else:
            C = torch.eye(4, dtype=torch.float64)
            C[:3, :3] = torch.as_tensor(event["dR"]).to(torch.float64)
            C[:3, 3] = torch.as_tensor(event["dt"]).to(torch.float64)
        # where the recorded correction puts the front end, against where the solve put it
        return {"correction_gap_m": gap(C.to(torch.float64) @ before, want @ before)}
    return {}
