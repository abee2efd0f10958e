"""A test engine, for the benchmark's own tests only: no configuration of the
manifest can name it, since it sits under `engines/` only in a temporary
copy of the benchmark that a test makes. It is the LIO engine
(`engines/lio.py`) with a small back end of the kind a SLAM engine has.
Every `backend.every`-th scan, after the front end's step, it

  * registers the scan once more against the target the front end matched
    it against, from the reported pose moved by a fixed offset, for a fixed
    count of Gauss-Newton iterations (`eps` 0): a loop registration's
    stand-in, which launches gn_step as the front end's match does;
  * solves for the pose that three weighted measurements agree on: the
    reported pose, the registration's, and the reported pose moved by a
    fixed pull (a loop edge that disagrees with the odometry). The solve is
    their weighted mean on SO(3) x R^3 on the engine's device in float32:
    a fixed count of Karcher steps for the rotation, the translations'
    weighted mean;
  * corrects the front end by the rigid motion that takes the reported
    pose to the solve's (`Lio.apply_correction`),

and hands the three to the harness as events, their numbers as the
device tensors the back end made (the harness moves the chosen ones to the
host after the window). The step's result is the front end's own, so its
`iterations` count the front end's match alone."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from yardstick import cell as cellmod

SOLVE_ITERATIONS = 3

_lio = cellmod.load_module("engines", "lio")


def rot_z(deg: float) -> np.ndarray:
    c, s = math.cos(math.radians(deg)), math.sin(math.radians(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def pose(R, t) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return T


def se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device)
    T[:3, :3], T[:3, 3] = R, t
    return T


class Engine(_lio.Engine):
    """The LIO engine on `device` with the back end above."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.back, self.device = cfg["backend"], device
        self.steps, self._events = 0, []

    def step(self, scan, packet):
        target = self.eng.state.icp_target          # what the front end matches this scan against
        out, rebuilt = super().step(scan, packet)
        self.steps += 1
        self._events = []
        if self.steps % int(self.back["every"]) == 0:
            self._events = self._back_end(scan, target)
        return out, rebuilt

    def events(self) -> list:
        """What the back end did after the last step."""
        return self._events

    def _back_end(self, scan, target) -> list:
        from loc_lib_tpu_torch.models import icp

        b, dev = self.back, self.device
        before = self.eng.poses[-1]                  # the reported pose, float32 on the host
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
        R0 = (before[:3, :3] @ rot_z(b["offset_deg"])).astype(np.float32)
        t0 = (before[:3, 3] + np.asarray(b["offset_m"])).astype(np.float32)
        opts = dataclasses.replace(self.opts.icp, eps=0.0, max_iteration=int(b["reg_iterations"]))
        res = icp.scan_match(target, opts, scan, f32(R0), f32(t0))
        reg = {"kind": "registration", "R0": R0, "t0": t0, "R": res.R, "t": res.t,
               "num_effective": res.num_effective, "chi2": res.chi2,
               "iterations": int(res.iterations)}
        pulled = pose(before[:3, :3] @ rot_z(b["pull_deg"]),
                      before[:3, 3] + np.asarray(b["pull_m"]))
        poses = torch.stack([f32(before), se3(res.R, res.t), f32(pulled)])
        weights = f32(b["weights"])
        after = self.solve(poses, weights)
        solve = {"kind": "solve", "poses": poses, "weights": weights, "pose": after}
        B = poses[0]
        dR = after[:3, :3] @ B[:3, :3].T
        dt = after[:3, 3] - dR @ B[:3, 3]
        self.eng.apply_correction(dR, dt)
        return [reg, solve, {"kind": "correction", "dR": dR, "dt": dt, "before": B,
                             "after": after}]

    def solve(self, poses: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """The weighted mean of `poses` ((k, 4, 4) on the engine's device) on
        SO(3) x R^3, in float32: a (4, 4) tensor there."""
        from loc_lib_tpu_torch.utils import lie

        w = weights
        R = poses[0, :3, :3]
        for _ in range(SOLVE_ITERATIONS):
            d = torch.sum(w[:, None] * lie.so3_log(R.T @ poses[:, :3, :3]), dim=0) / torch.sum(w)
            R = R @ lie.so3_exp(d)
        t = torch.sum(w[:, None] * poses[:, :3, 3], dim=0) / torch.sum(w)
        return se3(R, t)
