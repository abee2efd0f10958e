"""2D mapping app: submap SLAM over a replayed 2D scan log (port of
loc_lib_tpu/apps/mapping2d.py).

The reference's 2D pipeline driven from a laser-scan subscriber, over the
offline log format: each frame is a padded (B, 2) sensor-frame endpoint
array + validity mask (scans2d.npz). Exports the stitched occupancy map as
npz and PNG and the trajectory as TUM.

    python -m loc_lib_tpu_torch.apps.mapping2d --demo [--host-driven]
        [--log DIR] [--out DIR]

It runs on the card: the device-resident engine by default, the
host-driven one (its pinned twin) with --host-driven.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from ..io import trajectory
from ..ops.pointcloud import card_device
from ..pipeline import mapping2d as m2d


def run_mapping2d(xy: np.ndarray, valid: np.ndarray, stamps: np.ndarray,
                  opts: m2d.Mapping2dOptions, out_dir: str,
                  device_resident: bool = True, warm_start: bool = True,
                  device=None) -> dict:
    """device_resident=True runs Mapping2DDevice (one device step and one
    pull per scan); False runs the host-driven Mapping2D, its pinned twin.
    `warm_start` is accepted for the JAX package's signature and does
    nothing (nothing compiles ahead of time here). `device`: where the
    engine runs (default: the card; it raises without one)."""
    device = card_device(device)
    os.makedirs(out_dir, exist_ok=True)
    if device_resident:
        from ..pipeline.mapping2d_device import Mapping2DDevice
        engine = Mapping2DDevice(opts, num_beams=xy.shape[1], warm_start=warm_start,
                                 device=device)
    else:
        engine = m2d.Mapping2D(opts, device=device)
    poses2d = []
    for k in range(len(xy)):
        th, t = engine.process_scan(xy[k], valid[k])
        poses2d.append((th, t))

    # SE(2) -> SE(3) on z=0 for the standard writers
    poses = np.tile(np.eye(4, dtype=np.float32), (len(poses2d), 1, 1))
    for k, (th, t) in enumerate(poses2d):
        c, s = np.cos(th), np.sin(th)
        poses[k, :2, :2] = [[c, -s], [s, c]]
        poses[k, :2, 3] = t
    trajectory.save_tum(os.path.join(out_dir, "trajectory_tum.txt"),
                        np.asarray(stamps), poses)
    # global_occupancy() is the one correct source for BOTH engines: the
    # device-resident engine keeps the live submap's grid in device state
    occ = engine.global_occupancy()
    np.savez(os.path.join(out_dir, "submaps.npz"),
             counts=np.stack([c for c, _, _ in occ]),
             theta_ws=np.asarray([th for _, th, _ in occ]),
             t_ws=np.stack([t for _, _, t in occ]))
    from ..io import viz
    img = viz.render_occupancy_global(
        occ, resolution=opts.grid.resolution, unknown=opts.grid.unknown,
        traj_xy=np.stack([t for _, t in poses2d]) if poses2d else None)
    viz.write_png(os.path.join(out_dir, "occupancy_global.png"), img)
    report = {"frames": len(poses2d), "submaps": len(engine.submaps),
              "loops": len(engine.loops)}
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def demo_scans(n: int):
    """The demo's 2D log: a quarter circle of radius 6 m through
    `make_world_2d(seed=2)`, 720 beams a scan, 10 Hz."""
    from ..io import synthetic
    world = synthetic.make_world_2d(seed=2)
    xy = np.zeros((n, 720, 2), np.float32)
    valid = np.zeros((n, 720), bool)
    stamps = np.arange(n) * 0.1
    for k in range(n):
        a = 0.5 * np.pi * k / n
        t = np.array([6 * np.cos(a) - 6, 6 * np.sin(a)], np.float32)
        xy[k], valid[k] = synthetic.render_scan_2d(world, a, t, seed=k)
    return xy, valid, stamps


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--log", help="log dir containing scans2d.npz")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--demo-frames", type=int, default=40)
    ap.add_argument("--out", default="./mapping2d_out")
    ap.add_argument("--host-driven", action="store_true",
                    help="run the host-driven twin engine instead of the device-resident one")
    args = ap.parse_args(argv)

    if args.demo:
        xy, valid, stamps = demo_scans(args.demo_frames)
    else:
        if not args.log:
            ap.error("--log or --demo required")
        d = np.load(os.path.join(args.log, "scans2d.npz"))
        xy, valid, stamps = d["xy"], d["valid"], d["stamps"]

    report = run_mapping2d(xy, valid, stamps, m2d.Mapping2dOptions(), args.out,
                           device_resident=not args.host_driven)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
