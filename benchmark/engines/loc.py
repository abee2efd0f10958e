"""Drives the program's map-based localization engine (`pipeline.loc.Loc`)
for a configuration whose engine is "loc": the prior map and the options
from the configuration, the initial pose, and per scan the same scan filter
as LIO (`pipeline.lio.preprocess_scan` at the configuration's leaf and
capacity) then `Loc.update_measure` with the scan's IMU packet. The engine
pulls the pose to the host itself and re-crops its local map there.

Loc's step result does not carry its match's GN iterations; the step here
adds them as `iterations`: on the card the `gn_step` launches over the
call (one an iteration, and the step's one match is all that launches
it), on the CPU, where launches are not counted, None."""

from __future__ import annotations

import collections

import numpy as np
import torch


def options(cfg: dict):
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.pipeline import loc

    e = cfg["engine_options"]
    return loc.LocOptions(
        matcher=e["matcher"], icp=icp.IcpOptions(method=e["icp_method"]),
        box_size=e["box_size"], recrop_margin=e["recrop_margin"],
        scan_filter_leaf=e["scan_filter_leaf"], scan_capacity=e["scan_capacity"],
        local_map_capacity=e["local_map_capacity"], with_eskf=e["with_eskf"])


class Engine:
    """One Loc engine on `device` over the prior map `prior_map` ((M, 3)
    float32 on the host). It reports poses in the map's (world) frame."""

    frame = "world"

    def __init__(self, cfg: dict, device, prior_map: np.ndarray):
        from loc_lib_tpu_torch.ops import kernels
        from loc_lib_tpu_torch.pipeline import lio, loc

        self._lio = lio
        self.opts = options(cfg)
        self.eng = loc.Loc(prior_map, self.opts, device=device)
        self._result = collections.namedtuple("StepResult", (*loc.StepResult._fields, "iterations"))
        self._launches = kernels.LAUNCHES if torch.device(device).type == "cuda" else None

    def start(self, static, first_pose: np.ndarray) -> None:
        """Seed the pose with the true pose of scan 0 (crops the first local
        map). The filter starts at rest, as the vehicle does."""
        self.eng.set_init_pose(first_pose[:3, :3].astype(np.float32),
                               first_pose[:3, 3].astype(np.float32))

    def filter(self, xyz, mask):
        return self._lio.preprocess_scan(self.opts, xyz, mask)

    def step(self, scan, packet):
        """(StepResult with `iterations`, rebuilt: the local map was
        re-cropped and the target rebuilt)."""
        n = self.eng.num_recrops
        steps = self._launches["gn_step"] if self._launches is not None else None
        out = self.eng.update_measure(scan, *packet)
        iters = self._launches["gn_step"] - steps if steps is not None else None
        return self._result(*out, iterations=iters), self.eng.num_recrops > n

    def pose(self) -> np.ndarray:
        return self.eng.poses[-1]

    def filter_state(self):
        return self.eng.state.eskf

    def ready(self) -> bool:
        """The local map has been re-cropped once."""
        return self.eng.num_recrops >= 1
