"""SLAM app: full 3D SLAM (LIO + loop closure + pose graph) over a log (port
of loc_lib_tpu/apps/slam.py).

The reference's mapping node has no 3D loop closure; this driver is the
completed version: the mapping flow of apps/mapping.py with the Slam3d
back end, exporting both the raw odometry and the loop-optimized keyframe
trajectory plus the re-assembled map.

    python -m loc_lib_tpu_torch.apps.slam --demo [--log DIR] [--out DIR]

It runs on the card.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from ..io import logdir, trajectory
from ..ops.pointcloud import card_device
from ..pipeline import lio as lio_mod, slam3d
from ..utils.timing import StageTimer
from .mapping import init_imu_gate, scan_cloud


def run_slam(log: logdir.SensorLog, opts: slam3d.Slam3dOptions, out_dir: str,
             device=None) -> dict:
    """Drive Slam3d over the log, optimize and export. `device`: where the
    engine runs (default: the card; it raises without one)."""
    device = card_device(device)
    os.makedirs(out_dir, exist_ok=True)
    engine = slam3d.Slam3d(opts, device=device)
    timer = StageTimer()
    stamps, odom_poses = [], []
    for mg in log.measures(imu_capacity=64):
        if opts.lio.with_eskf and not engine.imu_inited and log.imu is not None:
            if not init_imu_gate(engine, log, mg.scan_stamp):
                continue
        scan = scan_cloud(log, mg.scan_index, device)
        with timer.stage("slam_step"):
            engine.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        stamps.append(mg.scan_stamp)
        # the step's pose, as the front end recorded it (its one pull a scan)
        odom_poses.append(engine.lio.poses[-1])

    with timer.stage("final_optimize"):
        engine.optimize()

    odom = np.stack(odom_poses) if odom_poses else np.zeros((0, 4, 4))
    trajectory.save_kitti(os.path.join(out_dir, "odometry_kitti.txt"), odom)
    kf = engine.keyframe_poses()
    trajectory.save_kitti(os.path.join(out_dir, "keyframes_optimized_kitti.txt"), kf)
    gmap = engine.assemble_global_map(voxel_size=0.3)
    np.savez(os.path.join(out_dir, "global_map.npz"), xyz=gmap)
    from ..io import viz
    viz.write_png(
        os.path.join(out_dir, "map_topdown.png"),
        viz.render_map_topdown(
            gmap, traj_t=kf[:, :3, 3] if len(kf) else None,
            ref_t=odom[:, :3, 3] if len(odom) else None))
    # the last keyframe's ScanContext descriptor
    if engine.scdb.count > 0:
        slot = (engine.scdb.count - 1) % engine.scdb.capacity
        viz.write_png(os.path.join(out_dir, "scan_context.png"),
                      viz.render_scan_context(engine.scdb.desc[slot].cpu().numpy()))
    report = {
        "frames": len(odom), "keyframes": len(engine.kf_R),
        "loops": len(engine.loops),
        "loop_inliers": int(engine.loop_inliers.sum())
        if engine.loop_inliers is not None else 0,
        "map_points": int(len(gmap)), "stage_ms": timer.report(),
    }
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--log", help="sensor log directory (io.logdir format)")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--demo-frames", type=int, default=60)
    ap.add_argument("--out", default="./slam_out")
    args = ap.parse_args(argv)

    if args.demo:
        log = logdir.make_demo_log(num_frames=args.demo_frames)
    else:
        if not args.log:
            ap.error("--log or --demo required")
        log = logdir.load_log(args.log)

    opts = slam3d.Slam3dOptions(lio=lio_mod.LioOptions(scan_capacity=log.scan_xyz.shape[1]))
    report = run_slam(log, opts, args.out)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
