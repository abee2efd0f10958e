"""Localization app: map-based matching over a replayed log (port of
loc_lib_tpu/apps/matching.py).

The reference's matching node and flow: load the global map, seed the
initial pose (explicit, else the GNSS first fix in ENU, else identity),
then per scan: ESKF predict through the IMU packet, box-cropped scan match,
re-crop near the box edge.

    python -m loc_lib_tpu_torch.apps.matching --demo [--mp-shards N]
        [--log DIR --map MAP.npz|MAP.pcd] [--config slam.yaml] [--out DIR]

It runs on the card; `--mp-shards` starts its own ranks as the mapping app
does (apps/mapping.py). Only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

from ..io import config as config_io, logdir, trajectory
from ..io.replay import EnuConverter
from ..ops.pointcloud import card_device
from ..pipeline import loc as loc_mod
from ..utils.timing import StageTimer
from .mapping import is_writer, join_world, launch_ranks, needs_launch, scan_cloud, sharded_mesh


def run_matching(log: logdir.SensorLog, global_map_xyz: np.ndarray,
                 opts: loc_mod.LocOptions, out_dir: str,
                 init_pose: np.ndarray | None = None,
                 mp_shards: int = 0,
                 shard_capacity: int | None = None, device=None) -> dict:
    """Drive Loc over the log against the prior map and export. `device`:
    where the engine runs (default: the card; it raises without one).

    mp_shards > 0 runs the spatially sharded Loc (pipeline/loc_sharded.py):
    the box-cropped local map split over the mesh's "mp" axis, on the
    caller's process group (a size that mp_shards divides)."""
    device = card_device(device)
    writer = is_writer()
    if mp_shards > 0:
        from ..pipeline import loc_sharded

        engine = loc_sharded.LocSharded(sharded_mesh(mp_shards), global_map_xyz, opts,
                                        shard_capacity=shard_capacity, device=device)
    else:
        engine = loc_mod.Loc(global_map_xyz, opts, device=device)

    # initial pose: explicit > GNSS first fix > identity
    if init_pose is None and log.gnss is not None and len(log.gnss.stamps):
        enu = EnuConverter(*log.gnss.lla[0])
        init_pose = np.eye(4, dtype=np.float32)
        init_pose[:3, 3] = enu.to_enu(*log.gnss.lla[0])
    if init_pose is None:
        init_pose = np.eye(4, dtype=np.float32)
    engine.set_init_pose(init_pose[:3, :3], init_pose[:3, 3])

    timer = StageTimer()
    stamps = []
    for mg in log.measures(imu_capacity=64):
        scan = scan_cloud(log, mg.scan_index, device)
        with timer.stage("loc_step"):
            engine.update_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        stamps.append(mg.scan_stamp)

    poses = np.stack(engine.poses) if engine.poses else np.zeros((0, 4, 4))
    if writer:
        os.makedirs(out_dir, exist_ok=True)
        trajectory.save_kitti(os.path.join(out_dir, "trajectory_kitti.txt"), poses)
        trajectory.save_tum(os.path.join(out_dir, "trajectory_tum.txt"),
                            np.asarray(stamps), poses)
    report = {"frames": len(poses), "stage_ms": timer.report()}
    if log.gt_poses is not None and len(poses):
        from ..eval.metrics import ate
        report["ate_rmse_m"] = float(ate(poses, log.gt_poses[: len(poses)]).rmse)
    if writer:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--log", help="sensor log directory")
    ap.add_argument("--map", help="global map (.npz with xyz, or .pcd)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize log + map (mapping-free localization demo)")
    ap.add_argument("--demo-frames", type=int, default=20)
    ap.add_argument("--config", help="slam.yaml-style config file")
    ap.add_argument("--out", default="./matching_out")
    ap.add_argument("--mp-shards", type=int, default=0,
                    help="shard the local map over this many ranks (0 = single-device Loc)")
    ap.add_argument("--shard-capacity", type=int, default=None,
                    help="per-shard point budget (default: 2*local_map_capacity/mp)")
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Parse the CLI and run it in this process (inside a rank, or alone)."""
    ap = parser()
    args = ap.parse_args(argv)
    init_pose = None
    if args.demo:
        from ..io import synthetic
        log = logdir.make_demo_log(num_frames=args.demo_frames, with_imu=False)
        gmap = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
        init_pose = log.gt_poses[0]
    else:
        if not (args.log and args.map):
            ap.error("--log and --map, or --demo, required")
        log = logdir.load_log(args.log)
        if args.map.endswith(".pcd"):
            from ..io.pcd import load_pcd
            gmap = load_pcd(args.map)
        else:
            gmap = np.load(args.map)["xyz"]
    if args.config:
        cfg = config_io.Config.from_file(args.config)
        opts = config_io.loc_options(cfg)
    else:
        opts = loc_mod.LocOptions(scan_capacity=log.scan_xyz.shape[1])
    if args.mp_shards > 0:
        join_world()
    return run_matching(log, gmap, opts, args.out, init_pose=init_pose,
                        mp_shards=args.mp_shards, shard_capacity=args.shard_capacity)


def main(argv: Optional[list] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if needs_launch(args.mp_shards):
        report = launch_ranks("loc_lib_tpu_torch.apps.matching:run", argv, args.mp_shards)[0]
    else:
        report = run(argv)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
