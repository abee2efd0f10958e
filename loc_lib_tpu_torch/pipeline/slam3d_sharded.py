"""3D SLAM over the sharded mapping front end (port of
loc_lib_tpu/pipeline/slam3d_sharded.py).

  * The front end is a `LioSharded`: per scan the replicated ESKF predict,
    the distributed NDT match (source rows over "dp", Gaussian table over
    "mp") and the shard-local keyframe absorption.
  * The back end is `Slam3d` unchanged (ScanContext retrieval, batched loop
    registration, the two-phase pose graph), run alike on every rank: its
    front-end contract is init_imu / add_measure / imu_inited /
    apply_correction.
  * An accepted pose-graph solve corrects the front end THROUGH the sharded
    map (`map_shard.apply_correction_sharded`): every live Gaussian is
    moved, re-binned, handed to the shard that now owns it (slab bounds
    re-derived from the corrected map) and merged exactly on key
    collisions.
"""

from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh

from ..ops.pointcloud import card_device
from .lio_sharded import LioSharded
from .slam3d import Slam3d, Slam3dOptions


class Slam3dSharded(Slam3d):
    """Slam3d with the sharded mapping front end."""

    def __init__(self, mesh: DeviceMesh, opts: Slam3dOptions = Slam3dOptions(), R_il=None,
                 t_il=None, *, device=None):
        device = card_device(device)
        front = LioSharded(mesh, opts.lio, R_il=R_il, t_il=t_il, device=device)
        super().__init__(opts, front_end=front, device=device)
        self.mesh = mesh

    def live_voxels_per_shard(self):
        return self.lio.live_voxels_per_shard()

    @property
    def imbalance_warnings(self):
        return self.lio.imbalance_warnings
