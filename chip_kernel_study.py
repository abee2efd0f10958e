#!/usr/bin/env python3
"""Parent tree against this tree on one GPU; not part of the smoke run.

    python3 chip_kernel_study.py PARENT_DIR

Both trees' port packages are loaded in ONE process under two module names
and alternated (host times spread too widely between processes): the
wrappers' host time per call, the linearizations (gather + kernel) per
call for p2plane_vox, p2plane_vox_oct, NDT (`ndt._ndt_terms`) and
p2line_vox, launches and ms per headline match, per 3-iteration NDT match
and per batched match (64 lanes, 20 iterations), launches and ms of the
ESKF's propagation through one IMU packet, of its update by one pose
(`observe_se3`) and one wheel speed (`observe_wheel_speed`), of one LIO icp
and one Loc `step_measure`; the packet's three ways to the propagation
kernel (the parent's, read in place, copied first); and per-scan times of
LIO `icp`, LIO `ndt_inc`, LOAM and Loc with both methods, and the host
synchronizations per LIO scan. First it asserts that both trees' ESKF
kernels give equal outputs on the same finite inputs. Rows with no parent
side: 64 loop-registration matches as ONE `icp.scan_match_batch` call
against 64 scalar `icp.scan_match` calls of this tree, and the ESKF probe
(`eskf_predict_scan`'s device time against its updating rows, SASS counts).
Every timing comes before the profiler is first opened. Rows
whose code is the same in both trees are the control: they show what the
comparison reads for no change. PARENT_DIR holds a checkout of the parent
commit (e.g. unpacked with `git archive`).

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


def _lio_p50(get, device, log, matcher="icp", ringed=None):
    """p50 ms per scan and the poses of one 40-frame LIO run of the tree
    `get` loads: chip_smoke's options for `matcher` ("icp", "ndt_inc", or
    "loam" on the ring-annotated scans `ringed`, features extracted outside
    the timed step)."""
    lio, icp, ndt, loam = (get(m) for m in ("pipeline.lio", "models.icp", "models.ndt",
                                            "models.loam"))
    if matcher == "loam":
        fo = loam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
        opts = lio.LioOptions(matcher="loam", loam=loam.LoamOption(feature=fo),
                              scan_capacity=8192, with_eskf=True)
    else:
        opts = lio.LioOptions(matcher=matcher, icp=icp.IcpOptions(method="p2plane_vox"),
                              ndt=ndt.NdtOptions(method="incremental", voxel_size=1.0),
                              scan_capacity=8192, with_eskf=True)
    eng = lio.Lio(opts, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    times = []
    for mg in log.measures(imu_capacity=64):
        edge = None
        if matcher == "loam":
            f = loam.extract_features(ringed[mg.scan_index], opts.loam.feature)
            scan, edge = f.surf, f.edge
        else:
            scan = log.frame(mg.scan_index, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid,
                        edge_scan=edge)
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


def _lio_syncs(get, device, log):
    """Host synchronizations per LIO icp scan of the tree `get` loads:
    warnings of torch.cuda.set_sync_debug_mode("warn") over frames 4-11."""
    import warnings

    lio, icp, ndt = get("pipeline.lio"), get("models.icp"), get("models.ndt")
    opts = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                          ndt=ndt.NdtOptions(method="incremental", voxel_size=1.0),
                          scan_capacity=8192, with_eskf=True)
    eng = lio.Lio(opts, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    mgs = list(log.measures(imu_capacity=64))[:12]
    scans = [log.frame(mg.scan_index, device) for mg in mgs]
    step = lambda k: eng.add_measure(scans[k], mgs[k].imu_gyro, mgs[k].imu_acce,
                                     mgs[k].imu_stamp, mgs[k].imu_valid)
    for k in range(4):
        step(k)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for k in range(4, len(mgs)):
                step(k)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / (len(mgs) - 4)


def batched_against_scalar(device, card, reps=5):
    """This tree only: 64 loop-registration matches (chip_smoke's phase 8
    workload, p2plane_vox and p2plane_vox_oct, fixed 20 iterations) as one
    scan_match_batch call against 64 scalar scan_match calls, alternated."""
    from loc_lib_tpu_torch.models import icp

    bw = cs.batch_workload(device)
    targets = icp.set_target_batch(bw["tgts"], cs._loop_icp_options("p2plane_vox_oct"))
    B = cs.BATCH_LANES
    for method in ("p2plane_vox", "p2plane_vox_oct"):
        o = cs._loop_icp_options(method, max_iteration=20, eps=0.0)
        lanes = [(icp.take_lane(targets, b), o, icp.take_lane(bw["srcs"], b), bw["R0"][b],
                  bw["t0"][b]) for b in range(B)]
        fns = {"scalar": lambda: [icp.scan_match(*a) for a in lanes],
               "batched": lambda: icp.scan_match_batch(targets, o, bw["srcs"], bw["R0"],
                                                       bw["t0"])}
        ms = {"scalar": [], "batched": []}
        for r in range(reps):
            for side in (("scalar", "batched") if r % 2 == 0 else ("batched", "scalar")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[side]()
                torch.cuda.synchronize()
                ms[side].append((time.perf_counter() - t0) * 1e3)
        sc, ba = np.median(ms["scalar"]), np.median(ms["batched"])
        print(f"batched {method}, {B} matches of 20 iterations [{card}]: {B} scalar scan_match "
              f"calls {sc:.2f} ms ({B / sc * 1e3:.0f} matches/s), one scan_match_batch call "
              f"{ba:.2f} ms ({B / ba * 1e3:.0f} matches/s), medians of {reps} in turns; batched "
              f"slower in {int(np.sum(np.asarray(ms['batched']) > np.asarray(ms['scalar'])))}/"
              f"{reps} pairs (host clock; this tree only)",
              flush=True)


def _pairs(name, unit, p, c, card):
    """One line: medians, the median pair difference, pairs the change won
    and lost, the parent's own interquartile range."""
    p, c = np.asarray(p), np.asarray(c)
    q1, q3 = np.percentile(p, [25, 75])
    print(f"ab {name} [{card}]: parent {np.median(p):.4f} / change {np.median(c):.4f} {unit} "
          f"(medians of {len(p)}), median pair difference {np.median(c - p):+.4f}, change "
          f"faster in {int(np.sum(c < p))}/{len(p)} pairs, slower in {int(np.sum(c > p))}, "
          f"parent IQR {q3 - q1:.4f}", flush=True)


def _static_init(lio, log, device):
    init = lio.ImuStaticInit(device=device)
    for t, g, a in zip(log.imu.stamps, log.imu.gyro, log.imu.acce):
        state = init.add(g, a, t)
        if state is not None:
            return state
    raise AssertionError("the static IMU init never succeeded")


def eskf_equal(device, card, trees) -> None:
    """The parent's ESKF kernels and this tree's give equal outputs on the
    same finite inputs (torch.equal: a zero's sign aside): eskf_predict_scan
    on the demo log's 40 packets (this tree's state carried), on chip_smoke's
    gate packets, on a 300-row packet and on 24 random states; eskf_update for a pose and a wheel
    speed on the demo log's states and on the random states, every bias-flag
    pair."""
    ks = {side: get("ops.kernels") for side, get in trees.items()}
    eskf, lio = trees["change"]("models.eskf"), trees["change"]("pipeline.lio")
    counts = {"eskf_predict_scan": 0, "eskf_update": 0}

    def same(label, name, *args):
        out = {side: getattr(k, name)(*args) for side, k in ks.items()}
        for f, (a, b) in enumerate(zip(out["parent"], out["change"])):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}, {label}: output {f} differs from the parent's "
                                     f"by up to {float(torch.max(torch.abs(a - b))):.3g}")
        counts[name] += 1
        return out["change"]

    log = cs.demo_log()
    opts = eskf.EskfOptions()
    Q = eskf.process_noise(opts, device)
    rng = np.random.default_rng(5)
    s_init = _static_init(lio, log, device)
    s, mid = s_init, None
    mgs = list(log.measures(imu_capacity=64))
    for i, mg in enumerate(mgs):
        packet = (mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        if i == len(mgs) // 2:
            mid = (s, packet)
        s = s._replace(**dict(zip(cs.ESKF_OUT, same(f"demo packet {i}", "eskf_predict_scan", *s,
                                                    *packet, Q, opts.imu_dt))))
        obs = cs._eskf_observations(rng, s[:7], device)
        T = torch.tensor(log.gt_poses[mg.scan_index], dtype=torch.float32, device=device)
        same(f"demo state {i} wheel", "eskf_update", *s[:7], "wheel", *obs["wheel"], True, True)
        got = same(f"demo state {i} pose", "eskf_update", *s[:7], "se3", (T[:3, :3], T[:3, 3]),
                   obs["se3"][1], True, True)
        s = s._replace(**dict(zip(cs.ESKF_UPDATE_OUT, got)))
    s0, packet = mid
    for label, gate in cs._eskf_gate_packets(log, float(s0.time)).items():
        same(label, "eskf_predict_scan", *s0, *gate, Q, opts.imu_dt)
    k0 = int(np.searchsorted(log.imu.stamps, float(s_init.time), side="right"))
    same("300 rows", "eskf_predict_scan", *s_init, log.imu.gyro[k0:k0 + 300],
         log.imu.acce[k0:k0 + 300], log.imu.stamps[k0:k0 + 300], np.ones(300, bool), Q,
         opts.imu_dt)
    flag_pairs = ((True, True), (False, False), (True, False), (False, True))
    for k in range(24):
        state = cs._random_eskf_state(rng, device)
        same(f"random state {k}", "eskf_predict_scan", *state, s0.time, *packet, Q, opts.imu_dt)
        for kind, (obs, noise) in cs._eskf_observations(rng, state, device, ang=0.05).items():
            same(f"random state {k} {kind}", "eskf_update", *state, kind, obs, noise,
                 *flag_pairs[k % 4])
    print(f"ab ESKF outputs, parent == change (torch.equal) [{card}]: "
          f"{counts['eskf_predict_scan']} eskf_predict_scan calls (40 demo-log packets, "
          f"{len(cs._eskf_gate_packets(log, float(s0.time)))} gate packets, a 300-row packet, "
          f"24 random states), "
          f"{counts['eskf_update']} eskf_update calls (pose and wheel, every bias-flag pair)",
          flush=True)


def eskf_probe(device, card) -> None:
    """This tree only: eskf_predict_scan's device time against the number of
    updating rows of a 64-row packet on the card (torch.profiler, 20 calls
    each), and ptxas' view of the two kernels: registers, and the SASS of
    each body (`cuobjdump -sass`), whole and for the predict kernel's
    per-sample loop (the shortest loop with over 100 SHFL: the covariance
    warp's structured path)."""
    import re
    import subprocess
    from collections import Counter

    from loc_lib_tpu_torch.models import eskf
    from loc_lib_tpu_torch.ops import kernels

    log = cs.demo_log(10)
    opts = eskf.EskfOptions()
    Q = eskf.process_noise(opts, device)
    st = eskf.init_state(gravity=[0.0, 0.0, -9.81], time=float(log.imu.stamps[0]) - 0.01,
                         device=device)
    rows = []
    for n_upd in (0, 1, 10, 32, 64):
        valid = np.arange(64) < n_upd
        pk = kernels.imu_packet(log.imu.gyro[:64], log.imu.acce[:64], log.imu.stamps[:64], valid,
                                device)
        _, ms, _, _ = cs._profiled(
            lambda pk=pk: kernels._eskf_predict_scan_launch(*st, pk, Q, opts.imu_dt), 20)
        rows.append((n_upd, ms * 1e3))
    slope = (rows[-1][1] - rows[0][1]) / 64
    print(f"probe eskf_predict_scan device us by updating rows of 64 [{card}]: "
          + ", ".join(f"{n}: {us:.2f}" for n, us in rows)
          + f"; {slope:.3f} us an updating row over an intercept of {rows[0][1]:.2f} us",
          flush=True)
    sass = subprocess.run([kernels._nvcc().replace("nvcc", "cuobjdump"), "-sass",
                           str(kernels.build().path)], capture_output=True, text=True).stdout
    for body in sass.split("Function : ")[1:]:
        name = body.split()[0]
        if "eskf" not in name:
            continue
        ins = [(int(a, 16), op.split(".")[0], rest) for a, op, rest in re.findall(
            r"/\*([0-9a-f]{4,5})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);", body)]
        count = Counter(op for _, op, _ in ins)
        line = (f"probe sass {name} [{card}]: {len(ins)} instructions, SHFL {count['SHFL']}, "
                f"FMUL {count['FMUL']}, FADD {count['FADD']}, LDS {count['LDS']}")
        loops = []
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
            if m and int(m.group(1), 16) < addr:
                inside = [o for a, o, _ in ins if int(m.group(1), 16) <= a <= addr]
                if inside.count("SHFL") > 100:
                    loops.append((len(inside), inside.count("SHFL")))
        if loops and "predict" in name:
            n_ins, n_shfl = min(loops)
            line += f"; per-sample loop {n_ins} instructions, {n_shfl} SHFL"
        print(line, flush=True)


def packet_paths(device, card, trees, reps=10) -> None:
    """eskf_predict_scan on one demo-log packet of host arrays three ways, in
    turns: the parent's (its page-locked ring and copy), this tree's (the
    kernel reads the packet in place) and this tree's kernel on a packet
    copied to the card first (numpy pack, pageable copy: the earlier way).
    Host us to enqueue a call, and ms a call between CUDA events."""
    log = cs.demo_log(10)
    mg = list(log.measures(imu_capacity=64))[8]
    packet = (mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
    eskf = trees["change"]("models.eskf")
    st = eskf.init_state(gravity=[0.0, 0.0, -9.81], time=float(mg.imu_stamp[0]) - 0.01,
                         device=device)
    opts = eskf.EskfOptions()
    Q = eskf.process_noise(opts, device)
    kp, kc = trees["parent"]("ops.kernels"), trees["change"]("ops.kernels")
    fns = {"parent ring copy": lambda: kp.eskf_predict_scan(*st, *packet, Q, opts.imu_dt),
           "in place": lambda: kc.eskf_predict_scan(*st, *packet, Q, opts.imu_dt),
           "pageable copy": lambda: kc._eskf_predict_scan_launch(
               *st, kc.imu_packet(*packet, device), Q, opts.imu_dt)}
    host = {k: [] for k in fns}
    evt = {k: [] for k in fns}
    names = list(fns)
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            host[name].append(cs._enqueue_us(fns[name], 200))
            evt[name].append(cs._time_in_turns({"k": fns[name]}, 25)["k"])
    for a, b in (("parent ring copy", "in place"), ("pageable copy", "in place")):
        _pairs(f"predict_scan packet path, {a} -> {b}, host us to enqueue one call", "us",
               host[a], host[b], card)
        _pairs(f"predict_scan packet path, {a} -> {b}, per-call CUDA-event median", "ms",
               evt[a], evt[b], card)


def ab(device, card, parent_dir, reps=10):
    trees = {"parent": _load_tree("port_parent", parent_dir),
             "change": lambda sub: importlib.import_module(f"loc_lib_tpu_torch.{sub}")}
    for get in trees.values():
        get("ops.kernels").build()
    eskf_equal(device, card, trees)
    workload = cs.headline_workload(device)
    tgt_pc, src, _, _, R, t = workload
    order = lambda r: ("parent", "change") if r % 2 == 0 else ("change", "parent")

    # per call: the wrappers alone (rows / plane given: the interface both
    # trees have) and the whole linearization (gather + kernel)
    calls = {}
    tgt_edges, src_edges = cs._loam_style_edges(tgt_pc, device), cs._loam_style_edges(src, device)
    log = cs.demo_log(10)
    mgs = list(log.measures(imu_capacity=64))
    mg = mgs[8]
    packet = (mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
    gt = torch.tensor(log.gt_poses[mg.scan_index], dtype=torch.float32, device=device)
    bw = cs.batch_workload(device)
    from loc_lib_tpu_torch.io import synthetic
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    for side, get in trees.items():
        icp, ndt, kernels = get("models.icp"), get("models.ndt"), get("ops.kernels")
        pc = get("ops.pointcloud")
        mk = lambda c: pc.PointCloud(xyz=c.xyz, mask=c.mask)
        s, T = mk(src), mk(tgt_pc)
        no = ndt.NdtOptions(method="incremental", voxel_size=1.0)
        n3 = ndt.NdtOptions(method="incremental", voxel_size=1.0, max_iteration=3)
        nmap = ndt.update_incremental(ndt.empty_incremental(no, device=device), T, no)
        ol = icp.IcpOptions(method="p2line_vox")
        line_tgt, e = icp.set_target(mk(tgt_edges), ol), mk(src_edges)
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
            "NDT linearization (ndt._ndt_terms, weighted, S=7)":
                lambda d=ndt, m=nmap, o=no, s=s: d._ndt_terms(m, o, s, R, t, True),
            "p2line_vox linearization": lambda i=icp, tg=line_tgt, o=ol, e=e:
                i._p2line_vox_terms(tg, o, e, R, t),
            "match ndt incremental, max 3 iterations":
                lambda d=ndt, m=nmap, o=n3, s=s: d.scan_match(m, o, s, R, t),
            "match p2plane_vox": lambda i=icp, tg=target, o=ov, s=s: i.scan_match(tg, o, s, R, t),
            "match p2plane_vox_oct": lambda i=icp, tg=target, o=oo, s=s:
                i.scan_match(tg, o, s, R, t),
        }
        ob = cs._loop_icp_options("p2plane_vox", max_iteration=20, eps=0.0)
        ob = icp.IcpOptions(**{f: getattr(ob, f) for f in ob.__dataclass_fields__})
        btg = icp.set_target_batch(mk(bw["tgts"]), ob)
        calls[side]["match batched p2plane_vox, 64 lanes, 20 iterations"] = \
            lambda i=icp, tg=btg, o=ob, s=mk(bw["srcs"]): i.scan_match_batch(
                tg, o, s, bw["R0"], bw["t0"])
        # the ESKF's propagation through one IMU packet, and a whole LIO icp
        # step from the state a run reaches at frame 8 (both pure functions)
        eskf, lio = get("models.eskf"), get("pipeline.lio")
        st = eskf.init_state(gravity=[0.0, 0.0, -9.81], time=float(mg.imu_stamp[0]) - 0.01,
                             device=device)
        calls[side]["step ESKF predict_scan, one demo-log packet"] = \
            lambda e=eskf, st=st: e.predict_scan(st, *packet, e.EskfOptions())
        lopts = lio.LioOptions(icp=icp.IcpOptions(method="p2plane_vox"), scan_capacity=8192,
                               with_eskf=True)
        eng = lio.Lio(lopts, device=device)
        for tk, gk, ak in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
            eng.init_imu(gk, ak, tk)
        for m in mgs[:8]:
            eng.add_measure(log.frame(m.scan_index, device), m.imu_gyro, m.imu_acce,
                            m.imu_stamp, m.imu_valid)
        calls[side]["step ESKF observe_se3, the state after frame 8"] = \
            lambda e=eskf, st=eng.state.eskf: e.observe_se3(st, gt[:3, :3], gt[:3, 3],
                                                            e.EskfOptions())
        # the update's wrapper alone (host us to enqueue, CUDA-event ms), on
        # contiguous pose tensors
        Rc, tc = gt[:3, :3].contiguous(), gt[:3, 3].contiguous()
        calls[side]["ESKF eskf_update wrapper, pose"] = \
            lambda k=kernels, st=eng.state.eskf, Rc=Rc, tc=tc: k.eskf_update(
                *st[:7], "se3", (Rc, tc), (0.1, 0.0174533), True, True)
        calls[side]["ESKF eskf_update wrapper, wheel"] = \
            lambda k=kernels, st=eng.state.eskf: k.eskf_update(
                *st[:7], "wheel", (31.0, 33.0, 0.01), (0.5,), True, True)
        calls[side]["step ESKF observe_wheel_speed, the state after frame 8"] = \
            lambda e=eskf, st=eng.state.eskf: e.observe_wheel_speed(st, 31.0, 33.0,
                                                                    e.EskfOptions())
        calls[side]["step LIO icp step_measure, frame 8"] = \
            lambda l=lio, st=eng.state, sc=log.frame(mg.scan_index, device), o=lopts: \
            l.step_measure(st, sc, *packet, o)
        loc = get("pipeline.loc")
        leng = loc.Loc(world, loc.LocOptions(icp=icp.IcpOptions(method="p2plane_vox")),
                       device=device)
        leng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
        for m in mgs[:8]:
            leng.update_measure(log.frame(m.scan_index, device), m.imu_gyro, m.imu_acce,
                                m.imu_stamp, m.imu_valid)
        calls[side]["step Loc p2plane_vox step_measure, frame 8"] = \
            lambda l=loc, st=leng.state, sc=log.frame(mg.scan_index, device), o=leng.opts: \
            l.step_measure(st, sc, *packet, o)
    # every timing first, the profiler runs last (once the profiler has
    # run, later launches in the process cost the host more)
    iters = {}
    for name in calls["parent"]:
        host = {"parent": [], "change": []}
        evt = {"parent": [], "change": []}
        is_match = name.startswith("match")
        is_step = is_match or name.startswith("step")
        for r in range(reps):
            for side in order(r):
                fn = calls[side][name]
                if is_step:
                    fn()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = fn()
                    torch.cuda.synchronize()
                    host[side].append((time.perf_counter() - t0) * 1e3)
                    if is_match:
                        it = out.iterations
                        iters[name] = int(it.max()) if isinstance(it, torch.Tensor) else it
                else:
                    host[side].append(cs._enqueue_us(fn, 200))
                    evt[side].append(cs._time_in_turns({"k": fn}, 25)["k"])
        if is_match:
            _pairs(f"{name}, host ms per match ({iters[name]} iterations)", "ms",
                   host["parent"], host["change"], card)
        elif is_step:
            _pairs(f"{name}, host ms per call", "ms", host["parent"], host["change"], card)
        else:
            _pairs(f"{name}, host us to enqueue one call", "us", host["parent"], host["change"],
                   card)
            _pairs(f"{name}, per-call CUDA-event median", "ms", evt["parent"], evt["change"],
                   card)
    packet_paths(device, card, trees, reps)
    per_scan(device, card, trees, order, reps)
    log12 = cs.demo_log(12)
    syncs = {side: [_lio_syncs(get, device, log12) for _ in range(2)]
             for side, get in trees.items()}
    print(f"ab host synchronizations per LIO icp scan (frames 4-11, two runs each) [{card}]: "
          f"parent {syncs['parent']} -> change {syncs['change']}", flush=True)
    batched_against_scalar(device, card)
    eskf_probe(device, card)
    for name in calls["parent"]:
        prof = {side: cs._profiled(calls[side][name], 5)[:2] for side in ("parent", "change")}
        print(f"ab {name} [{card}]: device launches {prof['parent'][0]:.0f} -> "
              f"{prof['change'][0]:.0f}, device ms {prof['parent'][1]:.4f} -> "
              f"{prof['change'][1]:.4f} (torch.profiler, 5 calls)", flush=True)


def per_scan(device, card, trees, order, reps):
    """LIO ndt_inc, LOAM, LIO icp and Loc with both methods, 40 frames each,
    per tree in turns."""
    log = cs.demo_log()
    from loc_lib_tpu_torch.io import synthetic
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    ringed = [synthetic.annotate_rings(log.frame(k, device), num_rings=16, device=device)
              for k in range(log.scan_xyz.shape[0])]
    runs = {"LIO ndt_inc p50": lambda get: _lio_p50(get, device, log, "ndt_inc"),
            "LOAM p50": lambda get: _lio_p50(get, device, log, "loam", ringed),
            "LIO icp p50": lambda get: _lio_p50(get, device, log),
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
