"""Mapping app: LIO over a replayed log -> keyframes, global map, trajectory
(port of loc_lib_tpu/apps/mapping.py).

The reference's mapping node and flow: config -> options, static-IMU init,
the per-scan update and the save-map / save-trajectory command, with ROS ingestion replaced by the
offline log replay and the save-map thread by a synchronous export plus
rolling state checkpoints (checkpoint / resume).

    python -m loc_lib_tpu_torch.apps.mapping --demo [--mp-shards N]
        [--config slam.yaml] [--ckpt-every N] [--resume] [--out DIR]

It runs on the card. With `--mp-shards N` and no world configured (no
RANK / WORLD_SIZE in the environment) it starts N ranks on this machine
(`multihost.launch`): one a card over NCCL where there are N cards, else
all on the card over gloo. Only rank 0 writes files.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..io import checkpoint as ckpt_io, config as config_io, logdir, trajectory
from ..ops.pointcloud import PointCloud, card_device
from ..pipeline import lio as lio_mod
from ..utils.timing import StageTimer


def is_writer() -> bool:
    """True on the process that writes an app's files: the only one, or
    rank 0 of a process group (every rank computes the same bits)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sharded_mesh(mp_shards: int):
    """The (world / mp, mp) mesh of the caller's process group; raises
    without a group whose size is a multiple of mp_shards."""
    from ..parallel import multihost

    if not dist.is_initialized():
        raise RuntimeError(f"mp_shards={mp_shards} needs a torch.distributed process group "
                           "(multihost.init or multihost.launch); none is initialized")
    world = dist.get_world_size()
    if world % mp_shards:
        raise ValueError(f"mp_shards={mp_shards} does not divide the world size {world}")
    return multihost.global_mesh(mp=mp_shards)


def scan_cloud(log: logdir.SensorLog, k: int, device) -> PointCloud:
    """Frame k's padded scan on `device`: one host-to-device copy per tensor."""
    return PointCloud(xyz=torch.from_numpy(log.scan_xyz[k]).to(device),
                      mask=torch.from_numpy(log.scan_mask[k]).to(device))


def init_imu_gate(engine, log: logdir.SensorLog, scan_stamp: float) -> bool:
    """The static-IMU init gate: feed the last 400 samples up to the scan;
    True once the filter is seeded (until then the flow skips scans)."""
    sel = log.imu.stamps <= scan_stamp
    for t, g, a in zip(log.imu.stamps[sel][-400:], log.imu.gyro[sel][-400:],
                       log.imu.acce[sel][-400:]):
        engine.init_imu(g, a, t)
    return engine.imu_inited


def run_mapping(log: logdir.SensorLog, opts: lio_mod.LioOptions, out_dir: str,
                ckpt_every: int = 0, resume: bool = False, mp_shards: int = 0,
                device=None) -> dict:
    """Drive Lio over the log and export. `device`: where the engine runs
    (default: the card; it raises without one).

    mp_shards > 0 runs the spatially sharded mapping pipeline
    (pipeline/lio_sharded.py): the incremental voxel map split over the
    mesh's "mp" axis so the mapping working set scales past one card. It
    needs the caller's process group (a size that mp_shards divides) and
    matcher 'ndt_inc'; checkpoint / resume stays single-device."""
    device = card_device(device)
    writer = is_writer()
    if mp_shards > 0:
        from ..pipeline import lio_sharded

        if opts.matcher != "ndt_inc":
            raise ValueError(f"sharded mapping runs the incremental NDT matcher "
                             f"(got {opts.matcher!r})")
        if ckpt_every or resume:
            raise ValueError("checkpoint / resume is single-device only")
        engine = lio_sharded.LioSharded(sharded_mesh(mp_shards), opts, device=device)
    else:
        engine = lio_mod.Lio(opts, device=device)
    if writer:
        os.makedirs(out_dir, exist_ok=True)
        kf_store = ckpt_io.KeyframeStore(os.path.join(out_dir, "key_frames"),
                                         fresh=not resume)
    ckpt = (ckpt_io.Checkpointer(os.path.join(out_dir, "ckpt"))
            if ckpt_every and writer else None)
    start = 0
    if resume and ckpt is not None and ckpt.latest() is not None:
        engine.state, start = ckpt.restore(engine.state)
        start += 1
        engine.imu_inited = True

    timer = StageTimer()
    stamps, frame_idxs = [], []
    num_kfs = 0
    for mg in log.measures(imu_capacity=64):
        if mg.scan_index < start:
            continue
        if opts.with_eskf and not engine.imu_inited and log.imu is not None:
            if not init_imu_gate(engine, log, mg.scan_stamp):
                continue  # still collecting stationary samples; skip the scan
        scan = scan_cloud(log, mg.scan_index, device)
        with timer.stage("lio_step"):
            out = engine.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                                     mg.imu_valid)
        stamps.append(mg.scan_stamp)
        frame_idxs.append(mg.scan_index)
        if bool(out.is_keyframe):
            num_kfs += 1
            if writer:
                with timer.stage("kf_store"):
                    xyz = log.scan_xyz[mg.scan_index][log.scan_mask[mg.scan_index]]
                    kf_store.append(xyz, engine.poses[-1])
        if ckpt is not None and (mg.scan_index + 1) % ckpt_every == 0:
            ckpt.save(mg.scan_index, engine.state)

    poses = np.stack(engine.poses) if engine.poses else np.zeros((0, 4, 4))
    report = {"frames": len(poses), "keyframes": len(kf_store) if writer else num_kfs}
    if writer:
        trajectory.save_kitti(os.path.join(out_dir, "trajectory_kitti.txt"), poses)
        trajectory.save_tum(os.path.join(out_dir, "trajectory_tum.txt"),
                            np.asarray(stamps), poses)
        gmap = kf_store.assemble_global_map(voxel_size=0.3)
        np.savez(os.path.join(out_dir, "global_map.npz"), xyz=gmap)
        from ..io import viz
        viz.write_png(
            os.path.join(out_dir, "map_topdown.png"),
            viz.render_map_topdown(
                gmap, traj_t=poses[:, :3, 3] if len(poses) else None,
                ref_t=(log.gt_poses[np.asarray(frame_idxs)][:, :3, 3]
                       if log.gt_poses is not None and frame_idxs else None)))
        report["map_points"] = int(len(gmap))
    report["stage_ms"] = timer.report()
    if mp_shards > 0:
        report["mp_shards"] = mp_shards
        report["live_voxels_per_shard"] = [int(v) for v in engine.live_voxels_per_shard()]
    if log.gt_poses is not None and len(poses) >= 3:
        from ..eval import metrics
        a = metrics.ate(poses, log.gt_poses[np.asarray(frame_idxs)])
        report["ate_rmse_m"] = round(a.rmse, 4)
        report["ate_max_m"] = round(a.max, 4)
    if writer:
        with open(os.path.join(out_dir, "report.json"), "w") as f:
            json.dump(report, f, indent=1)
    return report


def launch_ranks(target: str, argv: list, world: int) -> list:
    """Run `target(argv)` in `world` ranks on this machine: one a card over
    NCCL when there are that many cards, else all on the card over gloo
    (NCCL refuses two ranks on one card). Returns the ranks' results."""
    from ..parallel import multihost

    card_device(None)   # a clear error where there is no card
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    return multihost.launch(target, world, (argv,), device="cuda", backend=backend,
                            threads=max(1, (os.cpu_count() or 1) // world))


def needs_launch(mp_shards: int) -> bool:
    """A sharded run with no process group and no world in the environment
    starts its own ranks."""
    return (mp_shards > 0 and not dist.is_initialized()
            and "RANK" not in os.environ and "WORLD_SIZE" not in os.environ)


def join_world() -> None:
    """Join the world the environment configures (torchrun-style), if any
    and if the caller has not joined one already."""
    if not dist.is_initialized():
        from ..parallel import multihost
        multihost.init()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--log", help="sensor log directory (io.logdir format)")
    ap.add_argument("--demo", action="store_true",
                    help="synthesize a demo log instead of reading --log")
    ap.add_argument("--demo-frames", type=int, default=30)
    ap.add_argument("--config", help="slam.yaml-style config file")
    ap.add_argument("--out", default="./mapping_out")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint the LIO state every N scans (0 = off)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mp-shards", type=int, default=0,
                    help="shard the incremental voxel map over this many mesh 'mp' "
                         "slices (matcher becomes ndt_inc; the mapping working set "
                         "scales past one card)")
    return ap


def run(argv: Optional[list] = None) -> dict:
    """Parse the CLI and run it in this process (inside a rank, or alone)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.demo:
        log = logdir.make_demo_log(num_frames=args.demo_frames)
    else:
        if not args.log:
            ap.error("--log or --demo required")
        log = logdir.load_log(args.log)
    if args.config:
        cfg = config_io.Config.from_file(args.config)
        opts = config_io.lio_options(cfg)
    else:
        opts = lio_mod.LioOptions(scan_capacity=log.scan_xyz.shape[1])
    if args.mp_shards > 0 and opts.matcher != "ndt_inc":
        opts = dataclasses.replace(opts, matcher="ndt_inc")
    if args.mp_shards > 0:
        join_world()
    return run_mapping(log, opts, args.out, ckpt_every=args.ckpt_every,
                       resume=args.resume, mp_shards=args.mp_shards)


def main(argv: Optional[list] = None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    if needs_launch(args.mp_shards):
        report = launch_ranks("loc_lib_tpu_torch.apps.mapping:run", argv, args.mp_shards)[0]
    else:
        report = run(argv)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
