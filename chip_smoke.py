#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (loc_lib_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from csrc/, holds each against its plain
PyTorch version on the card, then drives the port's main path through the
entry points a user calls: the headline scan-to-map match (set_target +
scan_match, p2plane_vox_oct, 65,536-point target, 8,192-point source) and
40 frames of LIO mapping (Lio.add_measure, p2plane_vox + ESKF, scan capacity
8192). Launch counters show the main path went through the kernels. A last
phase breaks the time of both paths down per layer (torch.profiler; tables
in chiprun_out/).

Prints one line per phase, then a JSON line with the kernels, then the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failing phase raises
and the script exits non-zero; without a CUDA device it exits non-zero
before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_TARGET = 65536
N_SOURCE = 8192
TIMING_REPS = 50
PARITY_ROT_RAD = 0.0088   # 0.5 deg
PARITY_TRANS_M = 0.03     # 3 cm
INIT_ROT_RAD = 0.0087     # 0.5 deg
INIT_TRANS_M = 0.07       # 7 cm
LIO_FRAMES = 40
LIO_WARMUP = 6
ATE_LIMIT_M = 0.10


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th ** 2 * (K @ K)


def _rot_err(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)))


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def phase_device(device) -> str:
    name = torch.cuda.get_device_name(device)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    import loc_lib_tpu_torch  # noqa: F401  (pins TF32 off)
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul must be off"
    assert not torch.backends.cudnn.allow_tf32, "TF32 cudnn must be off"
    print(f"phase 1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | tf32 off", flush=True)
    return smi


# ---------------------------------------------------------------------------
# Phase 2: build
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from loc_lib_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    info = kernels.build()
    secs = time.perf_counter() - t0
    report = []
    for line in info.log.splitlines():
        if "Compiling entry function" in line:
            report.append(line.split("'")[1] if "'" in line else line.strip())
        elif "registers" in line or "spill" in line:
            report.append(line.replace("ptxas info    :", "").strip())
    print(f"phase 2 build: {info.library.name} in {secs:.1f} s "
          f"({'compiled' if info.built_now else 'cached'}); ptxas: " + " | ".join(report),
          flush=True)


# ---------------------------------------------------------------------------
# Shared workload
# ---------------------------------------------------------------------------

def headline_workload(device):
    """bench.py's workload from the port's numpy generator: world (200000
    points, extent 80, seed 7), 65,536-point target, 8,192-point source,
    ground truth perturbed by 0.5 deg / 7 cm."""
    from loc_lib_tpu_torch.io import synthetic

    world = synthetic.make_world(num_points=200000, extent=80.0, seed=7)
    traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    tgt = synthetic.render_scan(world, traj.R[0], traj.t[0], max_range=70.0,
                                max_points=N_TARGET, noise=0.01, seed=0,
                                capacity=N_TARGET, device=device)
    src = synthetic.render_scan(world, traj.R[1], traj.t[1], max_range=70.0,
                                max_points=N_SOURCE, noise=0.01, seed=1,
                                capacity=N_SOURCE, device=device)
    R0w, R1w = traj.R[0].astype(np.float64), traj.R[1].astype(np.float64)
    t0w, t1w = traj.t[0].astype(np.float64), traj.t[1].astype(np.float64)
    R_gt = R0w.T @ R1w
    t_gt = R0w.T @ (t1w - t0w)
    rng = np.random.default_rng(42)
    w = rng.normal(size=3)
    w *= INIT_ROT_RAD / np.linalg.norm(w)
    dt = rng.normal(size=3)
    dt *= INIT_TRANS_M / np.linalg.norm(dt)
    R_init = torch.tensor(R_gt @ _so3_exp(w), dtype=torch.float32, device=device)
    t_init = torch.tensor(t_gt + dt, dtype=torch.float32, device=device)
    return tgt, src, R_gt, t_gt, R_init, t_init


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _time_alternating(kernel_fn, plain_fn, reps=TIMING_REPS):
    """Median per-call time of kernel and plain version between CUDA events
    around one wrapper call (its device work plus any host enqueue gaps),
    timed in turns plain, kernel, kernel, plain after a warm-up."""
    for _ in range(5):
        kernel_fn()
        plain_fn()
    torch.cuda.synchronize()
    samples = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn = kernel_fn if which == "kernel" else plain_fn
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            samples[which].append(a.elapsed_time(b))
    return float(np.median(samples["kernel"])), float(np.median(samples["plain"]))


def _profiled(fn, reps):
    """Run fn() reps times under torch.profiler. Returns (device launches
    per call, summed device kernel ms per call, host ms per call with the
    profiler on, the profile)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(dev) / reps, sum(dev) / 1e3 / reps, host_ms, prof


def _compare(name, got, plain, A):
    """Hold a kernel result against its plain version on the same inputs.
    The count must equal the plain version's and the rows' exact count.
    H, b and chi2 must lie, entry by entry, within
    kernels.check_against_rows' bound of the float64 sum of the plain
    version's rows A (2 gamma_{h+1} (|A|^T|A|)_ij for the kernel's reduction
    depth h), so chi2 and b are held to their own scale. Returns the max
    abs error against the plain float32 result and the largest
    error / tolerance ratio."""
    from loc_lib_tpu_torch.ops import kernels

    chk = kernels.check_against_rows(got, A)
    cnt = int(got[2])
    if cnt != int(plain[2]) or cnt != chk.count:
        raise AssertionError(f"{name}: count {cnt} != plain {int(plain[2])} / exact {chk.count}")
    if not chk.ratio <= 1.0:
        raise AssertionError(f"{name}: abs error {chk.max_abs_err:g} is {chk.ratio:.3g} "
                             "times its per-entry bound")
    err = max(float(torch.max(torch.abs(x - r)))
              for x, r in ((got[0], plain[0]), (got[1], plain[1]), (got[3], plain[3])))
    return err, chk.ratio


def _planted_errors_are_caught(name, got, A):
    """The check must reject a result with chi2 = 0, with b's translation
    part dropped, or with one H entry off by 1e-3 of itself."""
    from loc_lib_tpu_torch.ops import kernels

    H, b, cnt, chi2 = got
    b_t = b.clone()
    b_t[3:] = 0.0
    H_1 = H.clone()
    H_1[0, 0] *= 1.001
    for label, bad in (("chi2 = 0", (H, b, cnt, torch.zeros_like(chi2))),
                       ("b[3:] = 0", (H, b_t, cnt, chi2)),
                       ("H[0,0] * 1.001", (H_1, b, cnt, chi2))):
        if kernels.check_against_rows(bad, A).ratio <= 1.0:
            raise AssertionError(f"{name}: the check accepts a planted error ({label})")


def _random_k1(n, device, rng):
    q = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
    nv = rng.normal(size=(n, 3)).astype(np.float32)
    nv /= np.linalg.norm(nv, axis=1, keepdims=True)
    d = (-(nv * q).sum(1) + rng.normal(scale=0.1, size=n)).astype(np.float32)
    w = (rng.uniform(size=n) < 0.8).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(q), t(np.concatenate([nv, d[:, None]], 1)), t(w)


def _random_k2(n, device, rng, S=7):
    q = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
    rows = np.zeros((n, S, 8), np.float32)
    for s in range(S):
        nv = rng.normal(size=(n, 3)).astype(np.float32)
        nv /= np.linalg.norm(nv, axis=1, keepdims=True)
        mu = q + rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)
        rows[:, s, 0:3] = nv
        rows[:, s, 3] = -(nv * mu).sum(1)
        rows[:, s, 4:7] = mu
        rows[:, s, 7] = rng.uniform(size=n) < 0.6
    w = (rng.uniform(size=n) < 0.9).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(q), t(rows), t(w)


def phase_kernels(device, card, workload):
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels
    from loc_lib_tpu_torch.utils import lie

    K1, K1p = kernels.p2plane_fused_terms, kernels.p2plane_fused_terms_plain
    K2, K2p = kernels.p2plane_pick_fused_terms, kernels.p2plane_pick_fused_terms_plain
    rows_of = {"p2plane_fused_terms": kernels.p2plane_rows_plain,
               "p2plane_pick_fused_terms": kernels.p2plane_pick_rows_plain}
    rng = np.random.default_rng(0)
    dw = torch.tensor([0.01, -0.02, 0.015], device=device)
    R = lie.so3_exp(dw)
    t = torch.tensor([0.2, -0.1, 0.05], device=device)
    errs = {"p2plane_fused_terms": 0.0, "p2plane_pick_fused_terms": 0.0}
    ratio = [0.0]
    cases = []

    def check(kname, label, fn, plain, args, pose=None, gate=0.1):
        Rc, tc = (R, t) if pose is None else pose
        got = fn(*args, Rc, tc, gate)
        torch.cuda.synchronize()
        A = rows_of[kname](*args, Rc, tc, gate)
        e, r = _compare(f"{kname} {label}", got, plain(*args, Rc, tc, gate), A)
        errs[kname] = max(errs[kname], e)
        ratio[0] = max(ratio[0], r)
        cases.append(f"{label} ok (cnt {int(got[2])}, err {e:.3g}, err/bound {r:.3g})")
        return got, A

    for n in (8192, 8191, 65536):
        check("p2plane_fused_terms", f"K1 N={n}", K1, K1p, _random_k1(n, device, rng))
    for n in (8192, 8191):
        check("p2plane_pick_fused_terms", f"K2 N={n}", K2, K2p, _random_k2(n, device, rng))

    # the main path's own inputs: headline target, source at the init pose
    tgt_pc, src, _, _, R_init, t_init = workload
    opts = icp.IcpOptions(method="p2plane_vox_oct")
    target = icp.set_target(tgt_pc, opts)
    oct_rows, oct_w = icp._p2plane_vox_oct_rows(target, opts, src, R_init, t_init)
    k1_args = (src.xyz, oct_rows[:, 0:4], oct_w)
    rows7 = icp._p2plane_vox_rows7(target, opts, src, R_init, t_init)
    k2_args = (src.xyz, rows7, src.mask.to(torch.float32))
    for kname, fn, plain, args in (("p2plane_fused_terms", K1, K1p, k1_args),
                                   ("p2plane_pick_fused_terms", K2, K2p, k2_args)):
        got, A = check(kname, f"{kname} headline inputs", fn, plain, args)
        _planted_errors_are_caught(kname, got, A)
    cases.append("planted chi2 / b / H errors rejected")

    # determinism: the grid depends on N only, so repeated runs give the same bits
    a, b = K1(*k1_args, R, t, 0.1), K1(*k1_args, R, t, 0.1)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("K1 is not bitwise deterministic")

    # all-masked input (PAD_COORD points, w = 0) must give G = 0 exactly
    n = 8192
    pad_q = torch.full((n, 3), 1e6, device=device)
    zero_w = torch.zeros(n, device=device)
    for kname, fn, extra in (("p2plane_fused_terms", K1,
                              torch.zeros((n, 4), device=device)),
                             ("p2plane_pick_fused_terms", K2,
                              torch.zeros((n, 7, 8), device=device))):
        H, bb, cnt, chi2 = fn(pad_q, extra, zero_w, R, t, 0.1)
        if int(cnt) != 0 or torch.any(H != 0) or torch.any(bb != 0) or float(chi2) != 0:
            raise AssertionError(f"{kname}: all-masked input did not give G = 0")
    cases.append("all-masked G=0 ok")

    # K2 tie: two candidates equidistant from the point, the first must win
    q = (torch.randint(-320, 320, (n, 3), device=device) / 8.0).float()
    rows = torch.zeros((n, 7, 8), device=device)
    for s, off, axis in ((2, 0.5, 2), (4, -0.5, 1)):
        mu = q.clone()
        mu[:, 0] += off
        rows[:, s, axis] = 1.0
        rows[:, s, 3] = -mu[:, axis]
        rows[:, s, 4:7] = mu
        rows[:, s, 7] = 1.0
    only_first = rows.clone()
    only_first[:, 4, 7] = 0.0
    eye, z = torch.eye(3, device=device), torch.zeros(3, device=device)
    ones = torch.ones(n, device=device)
    tie, _ = check("p2plane_pick_fused_terms", "K2 tie", K2, K2p, (q, rows, ones),
                   pose=(eye, z), gate=1.0)
    first = K2(q, only_first, ones, eye, z, 1.0)
    if not all(torch.equal(x, y) for x, y in zip(tie, first)):
        raise AssertionError("K2 tie: the first stencil candidate did not win")
    cases.append("K2 tie first-wins ok")

    # times at the main path's N = 8192, in turns plain, kernel, kernel, plain
    ms1, pms1 = _time_alternating(lambda: K1(*k1_args, R, t, 0.1),
                                  lambda: K1p(*k1_args, R, t, 0.1))
    ms2, pms2 = _time_alternating(lambda: K2(*k2_args, R, t, 0.1),
                                  lambda: K2p(*k2_args, R, t, 0.1))
    dev = {}
    for label, fn in (("K1", lambda: K1(*k1_args, R, t, 0.1)),
                      ("K1 plain", lambda: K1p(*k1_args, R, t, 0.1)),
                      ("K2", lambda: K2(*k2_args, R, t, 0.1)),
                      ("K2 plain", lambda: K2p(*k2_args, R, t, 0.1))):
        fn()
        n_launch, ms, _, _ = _profiled(fn, 20)
        dev[label] = (ms, n_launch)
    print("phase 3 kernels vs plain: " + "; ".join(cases), flush=True)
    print(f"phase 3 largest error / per-entry bound: {ratio[0]:.4g}", flush=True)
    print(f"phase 3 times at N=8192 (median of {2 * TIMING_REPS} per-call CUDA-event "
          f"samples) [{card}]: K1 {ms1:.4f} ms vs plain {pms1:.4f} ms; "
          f"K2 {ms2:.4f} ms vs plain {pms2:.4f} ms", flush=True)
    print("phase 3 device time per call at N=8192 (torch.profiler, kernels only) "
          f"[{card}]: " + "; ".join(f"{k} {ms:.4f} ms in {n:.0f} launches"
                                   for k, (ms, n) in dev.items()), flush=True)
    return {"p2plane_fused_terms": (ms1, pms1, errs["p2plane_fused_terms"]),
            "p2plane_pick_fused_terms": (ms2, pms2, errs["p2plane_pick_fused_terms"])}


# ---------------------------------------------------------------------------
# Phase 4: the headline match
# ---------------------------------------------------------------------------

def phase_headline(device, card, workload):
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    tgt_pc, src, R_gt, t_gt, R_init, t_init = workload
    opts = icp.IcpOptions(method="p2plane_vox_oct")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    target = icp.set_target(tgt_pc, opts)
    torch.cuda.synchronize()
    set_target_ms = (time.perf_counter() - t0) * 1e3
    k1_before = kernels.LAUNCHES["p2plane_fused_terms"]
    res = icp.scan_match(target, opts, src, R_init, t_init)
    R = res.R.double().cpu().numpy()
    tt = res.t.double().cpu().numpy()
    rot_e, trans_e = _rot_err(R, R_gt), float(np.linalg.norm(tt - t_gt))
    if not (np.isfinite(R).all() and np.isfinite(tt).all()):
        raise AssertionError("headline match produced a non-finite pose")
    if not (rot_e < PARITY_ROT_RAD and trans_e < PARITY_TRANS_M):
        raise AssertionError(f"headline match off ground truth: {np.degrees(rot_e):.3f} deg / "
                             f"{trans_e:.4f} m")
    k1 = kernels.LAUNCHES["p2plane_fused_terms"] - k1_before
    if k1 != res.iterations:
        raise AssertionError(f"K1 launched {k1} times for {res.iterations} iterations")
    print(f"phase 4 headline p2plane_vox_oct: {res.iterations} iterations, "
          f"n_eff {int(res.num_effective)}, err {np.degrees(rot_e):.4f} deg / "
          f"{trans_e * 100:.3f} cm, K1 launches {k1}; set_target {set_target_ms:.2f} ms "
          f"(second build, host clock) [{card}]", flush=True)
    return target


def phase_headline_timing(device, card, workload, target):
    from loc_lib_tpu_torch.models import icp

    _, src, _, _, R_init, t_init = workload
    opts = icp.IcpOptions(method="p2plane_vox_oct")
    for _ in range(3):
        icp.scan_match(target, opts, src, R_init, t_init)
    times = []
    for _ in range(TIMING_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp.scan_match(target, opts, src, R_init, t_init)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"phase 4 headline timing: median {np.median(times):.3f} ms per match "
          f"(p95 {np.percentile(times, 95):.3f} ms, {res.iterations} iterations, "
          f"{TIMING_REPS} runs, host clock) [{card}]", flush=True)
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 5: LIO mapping
# ---------------------------------------------------------------------------

def phase_lio(device, card):
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.io import logdir
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.pipeline import lio

    log = logdir.make_demo_log(num_frames=LIO_FRAMES, capacity=8192, yaw_rate=0.0, speed=2.0)
    opts = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                          scan_capacity=8192, with_eskf=True)
    eng = lio.Lio(opts, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    if not eng.imu_inited:
        raise AssertionError("static IMU init failed")
    times, idxs, iters = [], [], []
    for mg in log.measures(imu_capacity=64):
        scan = log.frame(mg.scan_index, device)
        before = eng.state          # the state the last scan is matched against
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        idxs.append(mg.scan_index)
        iters.append(out.iterations)
    poses = np.stack(eng.poses)
    if not np.isfinite(poses).all():
        raise AssertionError("LIO produced a non-finite pose")
    n_kf = len(eng.kf_poses)
    if n_kf < 2:
        raise AssertionError(f"LIO accepted only {n_kf} keyframes")
    ate = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    if not ate.rmse <= ATE_LIMIT_M:
        raise AssertionError(f"LIO ATE RMSE {ate.rmse:.4f} m > {ATE_LIMIT_M} m")
    steady = np.asarray(times[LIO_WARMUP:])
    print(f"phase 5 LIO {LIO_FRAMES} frames (p2plane_vox + ESKF, capacity 8192): "
          f"ATE RMSE {ate.rmse:.4f} m (max {ate.max:.4f}), {n_kf} keyframes, "
          f"mean GN iterations {np.mean(iters[1:]):.2f}, health {eng.health.status}; "
          f"p50 {np.percentile(steady, 50):.2f} ms/scan, p95 "
          f"{np.percentile(steady, 95):.2f} ms/scan over frames {LIO_WARMUP}-"
          f"{LIO_FRAMES - 1} (host clock) [{card}]", flush=True)
    return before.icp_target, opts.icp, scan, out


def phase_lio_k2_check(lio_last):
    """K2 against its plain version on the LIO path's own target: the
    local map the last scan was matched to, at that scan's final pose."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    target, opts, scan, out = lio_last
    rows7 = icp._p2plane_vox_rows7(target, opts, scan, out.R, out.t)
    args = (scan.xyz, rows7, scan.mask.to(torch.float32), out.R, out.t,
            opts.max_plane_distance)
    got = kernels.p2plane_pick_fused_terms(*args)
    err, ratio = _compare("K2 LIO local map", got, kernels.p2plane_pick_fused_terms_plain(*args),
                          kernels.p2plane_pick_rows_plain(*args))
    if int(got[2]) < opts.min_effective_pts:
        raise AssertionError(f"K2 on the LIO local map kept only {int(got[2])} points")
    print(f"phase 5 K2 vs plain on the LIO local map ({int(target.plane_valid.sum())} valid "
          f"planes, N={scan.capacity}): cnt {int(got[2])}, err {err:.3g}, "
          f"err/bound {ratio:.3g}", flush=True)
    return err


# ---------------------------------------------------------------------------
# Phase 6: where the time goes
# ---------------------------------------------------------------------------

def phase_profile(device, card, workload, target, out_dir):
    """Per-layer breakdown of both paths. Writes torch.profiler tables to
    out_dir and prints one line per path."""
    from loc_lib_tpu_torch.io import logdir
    from loc_lib_tpu_torch.models import eskf, icp
    from loc_lib_tpu_torch.pipeline import lio

    out_dir.mkdir(parents=True, exist_ok=True)
    _, src, _, _, R_init, t_init = workload
    opts = icp.IcpOptions(method="p2plane_vox_oct")
    res = icp.scan_match(target, opts, src, R_init, t_init)
    n, dev_ms, host_ms, prof = _profiled(
        lambda: icp.scan_match(target, opts, src, R_init, t_init), 5)
    (out_dir / "profile_match.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    print(f"phase 6 profile headline match: {n:.0f} device launches per match "
          f"({n / res.iterations:.0f} per iteration), device {dev_ms:.3f} ms vs host "
          f"{host_ms:.3f} ms per match (profiler on) [{card}]", flush=True)
    n, dev_ms, host_ms, prof = _profiled(lambda: icp.set_target(workload[0], opts), 1)
    (out_dir / "profile_set_target.txt").write_text(
        prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    print(f"phase 6 profile set_target: {n:.0f} device launches, device {dev_ms:.3f} ms vs host "
          f"{host_ms:.3f} ms (profiler on) [{card}]", flush=True)

    # LIO: 8 frames of warm-up, then a host-clock breakdown of frames 8-13
    frames = 14
    log = logdir.make_demo_log(num_frames=frames, capacity=8192, yaw_rate=0.0, speed=2.0)
    lo = lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                        scan_capacity=8192, with_eskf=True)
    eng = lio.Lio(lo, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    mgs = list(log.measures(imu_capacity=64))
    for mg in mgs[:8]:
        eng.add_measure(log.frame(mg.scan_index, device), mg.imu_gyro, mg.imu_acce,
                        mg.imu_stamp, mg.imu_valid)
    stage = {"predict_scan": [], "scan_match": [], "step": [], "step_kf": []}

    def clock(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stage[key].append((time.perf_counter() - t0) * 1e3)
        return r

    for mg in mgs[8:-1]:
        scan = log.frame(mg.scan_index, device)
        e2 = clock("predict_scan", lambda: eskf.predict_scan(
            eng.state.eskf, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid,
            eskf.EskfOptions()))
        st = eng.state._replace(eskf=e2)
        R0, t0 = lio._predict_pose(lo, st)
        clock("scan_match", lambda: icp.scan_match(st.icp_target, lo.icp, scan, R0, t0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        stage["step_kf" if out.is_keyframe else "step"].append((time.perf_counter() - t0) * 1e3)
    s0 = eng.state
    last = log.frame(mgs[-1].scan_index, device)
    kf_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lio._push_keyframe(lo, s0, last.xyz, last.mask, s0.R, s0.t)
        torch.cuda.synchronize()
        kf_ms.append((time.perf_counter() - t0) * 1e3)
    mg = mgs[-1]
    n, dev_ms, host_ms, prof = _profiled(
        lambda: eng.add_measure(last, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid), 1)
    (out_dir / "profile_lio_step.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    ranges = "; ".join(f"{k} {min(v):.2f}-{max(v):.2f} ms" for k, v in stage.items() if v)
    print(f"phase 6 profile LIO frames 8-{frames - 2} (host clock): {ranges}; _push_keyframe "
          f"{np.median(kf_ms):.2f} ms; one step under the profiler: {n:.0f} device "
          f"launches, device {dev_ms:.3f} ms vs host {host_ms:.3f} ms [{card}]", flush=True)


def main() -> int:
    from pathlib import Path

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from loc_lib_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    card = phase_device(device)
    phase_build()
    workload = headline_workload(device)
    timing = phase_kernels(device, card, workload)

    # the main path, counted: every counter starts at 0 here
    kernels.reset_launch_counts()
    target = phase_headline(device, card, workload)
    lio_last = phase_lio(device, card)
    launches = dict(kernels.LAUNCHES)
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched by the main path")
    k2_err = phase_lio_k2_check(lio_last)
    phase_headline_timing(device, card, workload, target)
    phase_profile(device, card, workload, target,
                  Path(__file__).resolve().parent / "chiprun_out")

    src = {"p2plane_fused_terms": ("loc_lib_tpu_torch/csrc/p2plane_fused_terms.cu",
                                   "loc_lib_tpu/ops/pallas_kernels.py:75"),
           "p2plane_pick_fused_terms": ("loc_lib_tpu_torch/csrc/p2plane_pick_fused_terms.cu",
                                        "loc_lib_tpu/ops/pallas_kernels.py:185")}
    errs = {k: v[2] for k, v in timing.items()}
    errs["p2plane_pick_fused_terms"] = max(errs["p2plane_pick_fused_terms"], k2_err)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name][0], "plain_ms": timing[name][1]}
        for name in ("p2plane_fused_terms", "p2plane_pick_fused_terms")]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
