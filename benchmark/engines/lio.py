"""Drives the program's LIO mapping engine (`pipeline.lio.Lio`) for a
configuration whose engine is "lio": the options from the configuration
file, the static IMU initialisation, and per scan the engine's own scan
filter then `Lio.add_measure` with the scan's IMU packet. The engine pulls
the pose to the host itself (one read a scan)."""

from __future__ import annotations

import numpy as np


def options(cfg: dict):
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.pipeline import lio

    e = cfg["engine_options"]
    return lio.LioOptions(
        matcher=e["matcher"], icp=icp.IcpOptions(method=e["icp_method"]),
        kf_distance=e["kf_distance"], kf_angle_deg=e["kf_angle_deg"],
        num_kfs_in_local_map=e["num_kfs_in_local_map"], scan_filter_leaf=e["scan_filter_leaf"],
        map_filter_leaf=e["map_filter_leaf"], scan_capacity=e["scan_capacity"],
        imu_capacity=e["imu_capacity"], with_eskf=e["with_eskf"])


class Engine:
    """One LIO engine on `device`. It reports poses in its own frame, in
    which the first scan's pose is the identity."""

    frame = "first_scan"

    def __init__(self, cfg: dict, device):
        from loc_lib_tpu_torch.pipeline import lio

        self._lio = lio
        self.opts = options(cfg)
        self.eng = lio.Lio(self.opts, device=device)

    def start(self, static, first_pose: np.ndarray) -> None:
        """Seed the filter from the stationary IMU window before scan 0."""
        for t, g, a in zip(*static):
            if self.eng.init_imu(g, a, t):
                return
        raise RuntimeError("the static IMU initialisation did not succeed")

    def filter(self, xyz, mask):
        return self._lio.preprocess_scan(self.opts, xyz, mask)

    def step(self, scan, packet):
        """(StepResult, rebuilt: a keyframe was pushed and the target rebuilt)."""
        n = len(self.eng.kf_poses)
        out = self.eng.add_measure(scan, *packet)
        return out, len(self.eng.kf_poses) > n

    def pose(self) -> np.ndarray:
        return self.eng.poses[-1]

    def filter_state(self):
        return self.eng.state.eskf

    def ready(self) -> bool:
        """The keyframe window is full."""
        return len(self.eng.kf_poses) >= self.opts.num_kfs_in_local_map
