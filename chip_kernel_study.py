#!/usr/bin/env python3
"""Parent tree against this tree on one GPU; not part of the smoke run.

    python3 chip_kernel_study.py PARENT_DIR

Both trees' port packages are loaded in ONE process under two module names
and alternated (host times spread too widely between processes): the
wrappers' host time per call, the linearizations (gather + kernel) per
call, launches and ms per headline match, and per-scan times of LIO `icp`
and Loc with both methods. PARENT_DIR holds a checkout of the parent commit
(e.g. unpacked with `git archive`).

Every line of output carries the card's name and power limit. Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import importlib
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

def _load_tree(alias, root):
    """The port package of the tree at `root`, imported under `alias` (the
    package uses only relative imports)."""
    pkg_dir = Path(root) / "loc_lib_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg_dir / "__init__.py",
                                                  submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return lambda sub: importlib.import_module(f"{alias}.{sub}")


def _lio_p50(get, device, log):
    lio, icp = get("pipeline.lio"), get("models.icp")
    opts = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=8192, with_eskf=True)
    eng = lio.Lio(opts, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    times = []
    for mg in log.measures(imu_capacity=64):
        scan = log.frame(mg.scan_index, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times[cs.LIO_WARMUP:], 50)), np.stack(eng.poses)


def _loc_p50(get, device, log, world, method):
    loc, icp = get("pipeline.loc"), get("models.icp")
    eng = loc.Loc(world, loc.LocOptions(icp=icp.IcpOptions(method=method)), device=device)
    eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
    times = []
    for mg in log.measures(imu_capacity=64):
        scan = log.frame(mg.scan_index, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.update_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(times[4:], 50)), np.stack(eng.poses)


def _pairs(name, unit, p, c, card):
    """One line: medians, the median pair difference, pairs the change lost,
    the parent's own interquartile range."""
    p, c = np.asarray(p), np.asarray(c)
    q1, q3 = np.percentile(p, [25, 75])
    print(f"ab {name} [{card}]: parent {np.median(p):.4f} / change {np.median(c):.4f} {unit} "
          f"(medians of {len(p)}), median pair difference {np.median(c - p):+.4f}, change "
          f"slower in {int(np.sum(c > p))}/{len(p)} pairs, parent IQR {q3 - q1:.4f}", flush=True)


def ab(device, card, parent_dir, reps=10):
    trees = {"parent": _load_tree("port_parent", parent_dir),
             "change": lambda sub: importlib.import_module(f"loc_lib_tpu_torch.{sub}")}
    for get in trees.values():
        get("ops.kernels").build()
    workload = cs.headline_workload(device)
    tgt_pc, src, _, _, R, t = workload
    order = lambda r: ("parent", "change") if r % 2 == 0 else ("change", "parent")

    # per call: the wrappers alone (rows / plane given: the interface both
    # trees have) and the whole linearization (gather + kernel)
    calls = {}
    for side, get in trees.items():
        icp, kernels = get("models.icp"), get("ops.kernels")
        pc = get("ops.pointcloud")
        mk = lambda c: pc.PointCloud(xyz=c.xyz, mask=c.mask)
        s, T = mk(src), mk(tgt_pc)
        oo = icp.IcpOptions(method="p2plane_vox_oct")
        ov = icp.IcpOptions(method="p2plane_vox")
        target = icp.set_target(T, oo)
        rows7 = icp._p2plane_vox_rows7(target, ov, s, R, t)
        orow, ow = icp._p2plane_vox_oct_rows(target, oo, s, R, t)
        w = s.mask.to(torch.float32)
        gate = torch.full((1,), 0.1, device=device)
        calls[side] = {
            "K2 wrapper, rows given": lambda k=kernels, r=rows7, s=s, w=w, g=gate:
                k.p2plane_pick_fused_terms(s.xyz, r, w, R, t, g),
            "K1 wrapper, plane given": lambda k=kernels, r=orow, s=s, w=ow, g=gate:
                k.p2plane_fused_terms(s.xyz, r[:, 0:4], w, R, t, g),
            "p2plane_vox linearization": lambda i=icp, tg=target, o=ov, s=s, g=gate:
                i._p2plane_vox_terms(tg, o, s, R, t, gate=g),
            "p2plane_vox_oct linearization": lambda i=icp, tg=target, o=oo, s=s, g=gate:
                i._p2plane_vox_oct_terms(tg, o, s, R, t, gate=g),
            "match p2plane_vox": lambda i=icp, tg=target, o=ov, s=s: i.scan_match(tg, o, s, R, t),
            "match p2plane_vox_oct": lambda i=icp, tg=target, o=oo, s=s:
                i.scan_match(tg, o, s, R, t),
        }
    # every timing first, the profiler runs last (once the profiler has
    # run, later launches in the process cost the host more)
    iters = {}
    for name in calls["parent"]:
        host = {"parent": [], "change": []}
        evt = {"parent": [], "change": []}
        is_match = name.startswith("match")
        for r in range(reps):
            for side in order(r):
                fn = calls[side][name]
                if is_match:
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    iters[name] = fn().iterations
                    torch.cuda.synchronize()
                    host[side].append((time.perf_counter() - t0) * 1e3)
                else:
                    host[side].append(cs._enqueue_us(fn, 200))
                    evt[side].append(cs._time_in_turns({"k": fn}, 25)["k"])
        if is_match:
            _pairs(f"{name}, host ms per match ({iters[name]} iterations)", "ms",
                   host["parent"], host["change"], card)
        else:
            _pairs(f"{name}, host us to enqueue one call", "us", host["parent"], host["change"],
                   card)
            _pairs(f"{name}, per-call CUDA-event median", "ms", evt["parent"], evt["change"],
                   card)
    per_scan(device, card, trees, order, reps)
    for name in calls["parent"]:
        prof = {side: cs._profiled(calls[side][name], 5)[:2] for side in ("parent", "change")}
        print(f"ab {name} [{card}]: device launches {prof['parent'][0]:.0f} -> "
              f"{prof['change'][0]:.0f}, device ms {prof['parent'][1]:.4f} -> "
              f"{prof['change'][1]:.4f} (torch.profiler, 5 calls)", flush=True)


def per_scan(device, card, trees, order, reps):
    """LIO icp and Loc with both methods, 40 frames each, per tree in turns."""
    log = cs.demo_log()
    from loc_lib_tpu_torch.io import synthetic
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    runs = {"LIO icp p50": lambda get: _lio_p50(get, device, log),
            "Loc p2plane_vox p50": lambda get: _loc_p50(get, device, log, world, "p2plane_vox"),
            "Loc p2plane_vox_oct p50": lambda get: _loc_p50(get, device, log, world,
                                                            "p2plane_vox_oct")}
    for name, run in runs.items():
        p50 = {"parent": [], "change": []}
        poses = {}
        for r in range(reps):
            for side in order(r):
                ms, poses[side] = run(trees[side])
                p50[side].append(ms)
        gap = float(np.abs(poses["parent"][:, :3, 3] - poses["change"][:, :3, 3]).max())
        _pairs(f"{name}, ms per scan", "ms", p50["parent"], p50["change"], card)
        print(f"ab {name}: largest position gap parent vs change over 40 frames {gap:.3g} m",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_study: no CUDA device available", file=sys.stderr)
        return 2
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = cs.phase_device(device)
    ab(device, card, sys.argv[1])
    print(f"card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
