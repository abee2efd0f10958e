#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (loc_lib_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from csrc/ (failing if a body spills
registers), holds each against its plain PyTorch version on the card (the
pose-update kernels gn_step and so3_renormalize at 1 to 300 lanes, and every
fused-terms kernel in all its modes: plane / rows given, and from the target or the map
with the gather inside the kernel, where K3 must also give the bits of the
torch gather followed by the rows-given kernel), then drives the
port's paths through the entry points a user calls: the headline scan-to-map match (set_target +
scan_match, p2plane_vox_oct, 65,536-point target, 8,192-point source), 40
frames of LIO mapping (Lio.add_measure, p2plane_vox + ESKF, scan capacity
8192), and the NDT family on the same log: incremental NDT (ndt_inc, the
repo's ndt_inc_odometry cell), direct NDT (ndt) and the moment-table voxel
planes (icp_vox_inc). Then it checks that the map builds give the same bits
on every run, and drives LOAM odometry (annotate_rings + extract_features +
Lio.add_measure with edge_scan) and localization against a prior map
(Loc.update_measure with p2plane_vox and p2plane_vox_oct, and two runs
that re-crop). Then batched matching (phase 8): the batched forms of K2 and
K1 are held per lane against their plain versions and, bit for bit, against
the scalar launch (B = 1, 3, 64; masked, out-of-window and off-table lanes;
lanes switched off; a second stream), and 64 loop-registration matches
(8,192-point targets, 2,048-point sources) run through
icp.scan_match_batch with p2plane_vox and p2plane_vox_oct: one kernel launch
per Gauss-Newton iteration for all lanes, every lane bit-equal to its scalar
scan_match, the chunked call equal to the direct one, every converged lane
under 3 cm, and matches per second at B = 1, 8 and 64. One frozen-election
match and one match of each knn method run on the card too. Then 3D SLAM
(phase 10): Slam3d.add_measure over bench_suite.py's slam3d_loop cell (92
frames, two laps of a circle, ScanContext top-3 candidates re-registered as
one batched match on K2-batch, the two-phase pose graph, the write-back):
an inlier loop, the keyframe ATE lowered by the pose graph and within its
bound, never LOST, one batched launch per GN iteration of every loop
registration, two runs bit-equal; the default loop registration
(p2plane_vox_oct: K1 and K1-batch) at 46 frames; and the pose graph at
4,096 nodes and 512 loop edges. Then the 2D stack (phase 11):
Mapping2DDevice.process_scan over bench_suite.py's mapping2d run (80 frames,
1000 x 1000 grid): submaps, a valid loop, trans RMSE within its bound, two
runs and the pipelined mode bit-equal; the host-driven Mapping2D against it
at 48 frames; archives spilled to host memory and matched back on the card
at 64 frames. Then the distributed layer (phase 12) on torch.distributed:
12a a world of one rank (NCCL) through the sharded pipelines at a (1, 1)
mesh: LioSharded on phase 5b's log (ndt_inc; ATE, the gap to 5b's
single-device run), Slam3dSharded on 64 frames of the 3D SLAM log (loops,
ATE lowered by the pose graph, the correction written through the sharded
map) and LocSharded on phase 7's run (ATE, no shard overflow, one K1 launch
per Gauss-Newton iteration); 12b several ranks spawned on the one card
(gloo) at meshes (2, 2) and (1, 4): the headline target sharded, the
sharded ICP and direct-NDT matches against the single-device ones, unique
voxel ownership, LioSharded with per-shard tables below the live map, the
edge-sharded two-phase pose graph on phase 10c's graph, every rank's K1
and K3 against their plain versions on its own shard, and every rank's
poses equal to rank 0's bits. Phase 13 runs the leaves on the card:
bfnn.knn against a float64 oracle and voxel.knn, the filters, the ring
search match and the reflector fix. Phase 14 runs the four apps through
their CLIs with no device argument (the card): mapping --demo, then
--config with a written slam.yaml selecting ndt_inc (K3), --ckpt-every 10
and --resume (the resumed poses are the uninterrupted run's bits),
matching --demo (K2), run_slam on the slam3d_loop log with the app's
default options (K1 / K1-batch loop registration, a loop with an inlier),
mapping2d --demo and --host-driven, mapping and matching --mp-shards 1 in
a one-rank NCCL world (the single-device bits), and entry(); every report's
ATE within the JAX package's plus 0.04 m, every artifact written, the
native host runtime built. Launch counters,
set to 0 before each path and read after
it, show each path went through its kernels (one K3 launch per NDT or
p2line_vox linearization). Then it compares a match with
the gather in torch ops against the shipped one (same bits; launches per
Gauss-Newton iteration), and only then opens the profiler: device time per
kernel call, and the time of the paths broken down per layer
(torch.profiler tables go to an output directory beside this script).

`python3 chip_smoke.py --cards` runs only phase 12b, one rank a card over
NCCL, on a machine with 4 cards or more.

Prints one line per phase, then a JSON line with the kernels, then the
card's name and power limit, and as its last line
{"ok": true, "device": {"platform": "gpu", ...}}. Any failing phase raises
and the script exits non-zero; without a CUDA device it exits non-zero
before doing anything.
"""

from __future__ import annotations

import json
import re
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
# ATE RMSE bounds of the NDT-family LIO phases (40 frames, capacity 8192).
# ndt_inc: 0.10 m, as for icp (the reference engine recorded 0.0542 m for
# this cell, BENCH_SUITE.json ndt_inc_odometry). ndt and icp_vox_inc: the
# JAX package's ATE on the same workload (one run on the CPU, PERF.md
# section 6) plus 0.04 m, the ATE change a 1-ulp nudge of the input makes in
# the JAX engine's own free run (0.234 -> 0.275 m, tests/test_torch_lio.py).
ATE_LIMIT_NDT_INC_M = 0.10
ATE_LIMIT_NDT_M = 0.106254 + 0.04
ATE_LIMIT_VOX_INC_M = 0.045601 + 0.04
# The same rule for LOAM odometry and localization against the prior map:
# the JAX package's ATE on each phase's workload (one CPU run each, PERF.md
# section 2) plus 0.04 m.
ATE_LIMIT_LOAM_M = 0.058190 + 0.04
ATE_LIMIT_LOC_M = 0.073056 + 0.04            # p2plane_vox, 150 m box
ATE_LIMIT_LOC_OCT_M = 0.073002 + 0.04        # p2plane_vox_oct, 150 m box
ATE_LIMIT_LOC_RECROP_M = 0.073085 + 0.04     # p2plane_vox, 110 m box: one re-crop
DETERMINISM_FRAMES = 12
NDT_TH = 20.0             # NdtOptions.res_outlier_th
# batched matching: bench_suite.py's throughput_batched workload
BATCH_LANES = 64
BATCH_TARGET_POINTS = 8192
BATCH_SOURCE_POINTS = 2048
BATCH_INIT_SIGMA_M = 0.05
BATCH_TAIL_M = 0.03       # every converged lane within 3 cm of the ground truth
BATCH_MIN_MEDIAN_EFFECTIVE = 700
# 3D SLAM: bench_suite.py's slam3d_loop cell (two laps of a circle)
SLAM_FRAMES = 92
SLAM_CAPACITY = 2048
SLAM_SHORT_FRAMES = 46
# the JAX package's keyframe ATE after the pose graph on the same workload
# (one CPU run, PERF.md section 2) plus 0.04 m, the section's rule
ATE_LIMIT_SLAM_M = 0.045000 + 0.04
PGO_NODES = 4096          # Slam3dOptions.sc_capacity
PGO_LOOPS = 512           # LoopOptions.max_loops
MAP2D_FRAMES = 80         # bench_suite.py's mapping2d run
MAP2D_PARITY_FRAMES = 48  # tests/test_mapping2d.py:277
MAP2D_SPILL_FRAMES = 64   # tests/test_mapping2d.py:320
# JAX + 0.04 m (Mapping2DDevice on the CPU, 80 frames), capped by
# tests/test_mapping2d.py:307's 0.08 m
JAX_RMSE_2D_M = 0.026151   # my CPU run of the JAX package (yaw 0.002486 rad, 6 submaps, 10 loops)
RMSE_LIMIT_2D_M = min(JAX_RMSE_2D_M + 0.04, 0.08)


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
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", info.log)
    if not spills or any(int(a) or int(b) for a, b in spills):
        raise AssertionError("a kernel body spills registers (or ptxas reported none):\n"
                             + "\n".join(report))
    print(f"phase 2 build: {info.path.name} in {secs:.1f} s ({len(spills)} kernel bodies, "
          f"none spills; "
          f"{'compiled' if info.built_now else 'cached'}); ptxas: " + " | ".join(report),
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

def _time_in_turns(fns, reps=TIMING_REPS):
    """Median per-call time of each function in `fns` (a dict) between CUDA
    events around one call (its device work plus any host enqueue gaps),
    timed in turns a, b, ..., b, a after a warm-up. Returns {name: ms}."""
    for _ in range(5):
        for fn in fns.values():
            fn()
    torch.cuda.synchronize()
    samples = {k: [] for k in fns}
    for which in list(fns) + list(fns)[::-1]:
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[which]()
            b.record()
            b.synchronize()
            samples[which].append(a.elapsed_time(b))
    return {k: float(np.median(v)) for k, v in samples.items()}


def _time_alternating(kernel_fn, plain_fn, reps=TIMING_REPS):
    """Kernel and plain version in turns plain, kernel, kernel, plain."""
    ms = _time_in_turns({"plain": plain_fn, "kernel": kernel_fn}, reps)
    return ms["kernel"], ms["plain"]


def _enqueue_us(fn, calls=300):
    """Host time of one call of fn in microseconds: `calls` calls enqueued
    back to back without a synchronise in between (the wrapper's own cost:
    checks, allocation, the ctypes call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def _profiled(fn, reps):
    """Run fn() reps times under torch.profiler. Returns (device launches
    per call, summed device kernel ms per call, host ms per call with the
    profiler on, the profile). A session can come back without one device
    event although fn() launched (the activity buffers of a short session
    are not always handed over): it is then repeated, up to 3 sessions, and
    0 launches after that mean "not recorded", never "not launched"."""
    from torch.profiler import ProfilerActivity, profile

    for _session in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3 / reps
        dev = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    return len(dev) / reps, sum(dev) / 1e3 / reps, host_ms, prof


def _compare(name, got, plain, A, rows_per_point=1):
    """Hold a kernel result against its plain version on the same inputs.
    The count must equal the plain version's and the rows' exact count.
    H, b and chi2 must lie, entry by entry, within
    kernels.check_against_rows' bound of the float64 sum of the plain
    version's rows A (2 gamma_{h+1} (|A|^T|A|)_ij for the kernel's reduction
    depth h, which counts `rows_per_point` rows per thread and point), so
    chi2 and b are held to their own scale. Returns the max abs error
    against the plain float32 result and the largest error / tolerance
    ratio."""
    from loc_lib_tpu_torch.ops import kernels

    chk = kernels.check_against_rows(got, A, rows_per_point)
    cnt = int(got[2])
    if cnt != int(plain[2]) or cnt != chk.count:
        raise AssertionError(f"{name}: count {cnt} != plain {int(plain[2])} / exact {chk.count}")
    if not chk.ratio <= 1.0:
        raise AssertionError(f"{name}: abs error {chk.max_abs_err:g} is {chk.ratio:.3g} "
                             "times its per-entry bound")
    err = max(float(torch.max(torch.abs(x - r)))
              for x, r in ((got[0], plain[0]), (got[1], plain[1]), (got[3], plain[3])))
    return err, chk.ratio


def _gram_is_zero(got) -> bool:
    H, b, cnt, chi2 = got
    return int(cnt) == 0 and not torch.any(H != 0) and not torch.any(b != 0) \
        and float(chi2) == 0.0


def _planted_errors_are_caught(name, got, A, rows_per_point=1):
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
        if kernels.check_against_rows(bad, A, rows_per_point).ratio <= 1.0:
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
        if not _gram_is_zero(fn(pad_q, extra, zero_w, R, t, 0.1)):
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

    # the kernel is built for the stencil's S = 7: another S on the card raises
    launched = kernels.LAUNCHES["p2plane_pick_fused_terms"]
    try:
        K2(q, rows[:, :5].contiguous(), ones, eye, z, 1.0)
    except ValueError:
        pass
    else:
        raise AssertionError("K2 with S = 5 rows on the card did not raise")
    if kernels.LAUNCHES["p2plane_pick_fused_terms"] != launched:
        raise AssertionError("K2 with S = 5 rows counted a launch")
    cases.append("K2 S=5 raises")

    # times at the main path's N = 8192, in turns plain, kernel, kernel, plain
    ms1, pms1 = _time_alternating(lambda: K1(*k1_args, R, t, 0.1),
                                  lambda: K1p(*k1_args, R, t, 0.1))
    ms2, pms2 = _time_alternating(lambda: K2(*k2_args, R, t, 0.1),
                                  lambda: K2p(*k2_args, R, t, 0.1))
    n = src.capacity
    b1, by1 = _bound(n * 32 + POSE_BYTES + OUT_BYTES, FLOPS_K1_GIVEN * n)
    b2, by2 = _bound(n * (16 + 7 * 32) + POSE_BYTES + OUT_BYTES, FLOPS_K2_GIVEN * n)
    print("phase 3 kernels vs plain (plane / rows given): " + "; ".join(cases), flush=True)
    print(f"phase 3 largest error / per-entry bound: {ratio[0]:.4g}", flush=True)
    print(f"phase 3 times at N=8192, plane / rows given (median of {2 * TIMING_REPS} per-call "
          f"CUDA-event samples) [{card}]: K1 {ms1:.4f} ms vs plain {pms1:.4f} ms (bound "
          f"{b1:.6f} ms by {by1}); K2 {ms2:.4f} ms vs plain {pms2:.4f} ms (bound {b2:.6f} ms "
          f"by {by2})", flush=True)
    profile_later = {"K1 plane given": (lambda: K1(*k1_args, R, t, 0.1), True),
                     "K1 plane given, plain": (lambda: K1p(*k1_args, R, t, 0.1), False),
                     "K2 rows given": (lambda: K2(*k2_args, R, t, 0.1), True),
                     "K2 rows given, plain": (lambda: K2p(*k2_args, R, t, 0.1), False)}
    return errs, profile_later


# Published peaks of the H100 SXM (NVIDIA's data sheet): the bounds below
# are the larger of bytes over the memory rate and float32 operations over
# the rate outside the tensor cores.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
# float32 operations per point (K3: per (point, voxel)), counted from the
# kernels' sources: qs 18, the row (dis 7, R^T n 15, J 12, scaling 8) 42,
# its 36 products and sums 72; per K2 candidate 10; voxel coordinates 9
# (K1 from the target: 15 with the octant bits); K3 per voxel e, z, res 25,
# W^T R 45 (weighted), three rows of 89.
FLOPS_K1_GIVEN, FLOPS_K1_TARGET = 132, 147
FLOPS_K2_GIVEN, FLOPS_K2_TARGET = 132 + 7 * 10, 132 + 9 + 7 * 10
FLOPS_K3_VOXEL = 25 + 45 + 3 * 89
OUT_BYTES = 44 * 4
POSE_BYTES = 13 * 4
INDEX_BYTES = 7 * 4


def _bound(n_bytes, flops):
    """(bound_ms, bound_by): the least time the card could take."""
    tb, to = n_bytes / H100_BYTES_PER_S * 1e3, flops / H100_FP32_FLOPS * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


# bytes and float32 operations a lane of the pose-update kernels: gn_step
# reads dx 24 + ok 1 + R 36 + t 12 and writes R 36 + t 12 + converged 1;
# so3_renormalize reads and writes R. Operations counted from the source:
# two 3x3 products (45 each), the Rodrigues terms, filters and norm ~60;
# the projection's four products and two scalings ~200.
POSE_UPDATE_BYTES = {"gn_step": 73 + 49, "so3_renormalize": 72}
POSE_UPDATE_FLOPS = {"gn_step": 150, "so3_renormalize": 200}
POSE_UPDATE_TOL = 1e-6     # |R - plain| per entry (entries <= 1); t and converged exact


def _pose_update_case(lanes, device, seed):
    """`lanes` pose updates (a tuple: () for one match): rotations up to
    ~0.5 rad, steps of ~2 cm / 0.02 rad, and, with 5 lanes or more, lane 1
    not ok, lane 2 with an infinite entry, lane 3 under eps, lane 4 a zero
    step."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lanes, dtype=np.int64))
    R = np.stack([_so3_exp(rng.normal(size=3) * 0.3) for _ in range(n)])
    t = rng.normal(size=(n, 3)) * 10.0
    dx = rng.normal(scale=0.02, size=(n, 6))
    ok = np.ones(n, bool)
    if n >= 5:
        ok[1] = False
        dx[2, 4] = np.inf
        dx[3] *= 1e-4
        dx[4] = 0.0
    f = lambda a, shape: torch.tensor(a, dtype=torch.float32, device=device).reshape(shape)
    return (f(dx, (*lanes, 6)), torch.tensor(ok, device=device).reshape(lanes),
            f(R, (*lanes, 3, 3)), f(t, (*lanes, 3)))


def _pose_update_close(got, want) -> float:
    """gn_step's (R, t, converged) or so3_renormalize's (R,) against the
    plain version: R within POSE_UPDATE_TOL, t and converged equal. Returns
    the largest |R - plain|; raises where they disagree."""
    err = float(torch.max(torch.abs(got[0] - want[0])))
    if not err <= POSE_UPDATE_TOL or not all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])):
        raise AssertionError(f"pose update differs from its plain version: |dR| {err:g}")
    return err


def phase_kernels_pose_update(device, card):
    """The pose-update kernels (gn_step, so3_renormalize) against their plain
    versions at one match (the scalar paths' shape) and at 3, 64 and 300
    lanes (the batched path's; 300 spans three blocks): R within 1e-6 per
    entry, t and converged equal; lane k of a batched launch bit-equal to
    the scalar launch on lane k; the projection orthonormal to 1e-6; a
    planted error rejected. Then times at one match and at 64 lanes."""
    from loc_lib_tpu_torch.ops import kernels

    EPS = 1e-3
    fns = {"gn_step": (kernels.gn_step, kernels.gn_step_plain),
           "so3_renormalize": (kernels.so3_renormalize, kernels.so3_renormalize_plain)}
    errs = dict.fromkeys(fns, 0.0)
    cases = []
    for lanes in ((), (3,), (BATCH_LANES,), (300,)):
        dx, ok, R, t = _pose_update_case(lanes, device, seed=len(lanes) + sum(lanes))
        for may in (True, False):
            got = kernels.gn_step(dx, ok, R, t, EPS, may)
            want = kernels.gn_step_plain(dx, ok, R, t, EPS, may)
            errs["gn_step"] = max(errs["gn_step"], _pose_update_close(got, want))
            if lanes and lanes[0] >= 5 and got[2][:5].tolist() != [False, False, False, may, may]:
                raise AssertionError(f"gn_step: converged {got[2][:5].tolist()} on the planted "
                                     "lanes")
        got = kernels.gn_step(dx, ok, R, t, EPS, True)
        noisy = got[0] + 1e-3 * torch.randn(got[0].shape, device=device,
                                            generator=torch.Generator(device).manual_seed(1))
        proj = kernels.so3_renormalize(noisy)
        errs["so3_renormalize"] = max(errs["so3_renormalize"], _pose_update_close(
            (proj,), (kernels.so3_renormalize_plain(noisy),)))
        # two Newton-Schulz steps take a 1e-3 defect to ~1e-9; float32 leaves ~1e-7
        defect = float(torch.max(torch.abs(proj.transpose(-1, -2) @ proj
                                           - torch.eye(3, device=device))))
        if not defect < POSE_UPDATE_TOL:
            raise AssertionError(f"so3_renormalize: R^T R - I = {defect:g}")
        for k in range(lanes[0] if lanes else 0):
            one = kernels.gn_step(dx[k], ok[k], R[k], t[k], EPS, True)
            if not (all(torch.equal(a[k], b) for a, b in zip(got, one))
                    and torch.equal(proj[k], kernels.so3_renormalize(noisy[k].contiguous()))):
                raise AssertionError(f"pose update, {lanes[0]} lanes: lane {k} differs from the "
                                     "scalar launch")
        cases.append(f"{lanes[0] if lanes else 1} lane(s) ok")
    want = kernels.gn_step_plain(dx, ok, R, t, EPS, True)
    bad = (got[0].clone(), got[1], got[2])
    bad[0][5, 1, 2] += 1e-5
    for planted in (bad, (got[0], got[1] + 1e-4, got[2]), (got[0], got[1], ~got[2])):
        try:
            _pose_update_close(planted, want)
        except AssertionError:
            continue
        raise AssertionError("pose update: the check accepts a planted error")
    cases.append("every lane of 3 / 64 / 300 bit-equal to its scalar launch; planted errors in "
                 "R, t and converged rejected")
    print("phase 3 pose-update kernels vs plain (|dR| <= 1e-6, t and converged equal): "
          + "; ".join(cases) + f"; largest |dR| gn_step {errs['gn_step']:.3g}, so3_renormalize "
          f"{errs['so3_renormalize']:.3g}", flush=True)

    timing, profile_later = {}, {}
    for lanes in ((), (BATCH_LANES,)):
        dx, ok, R, t = _pose_update_case(lanes, device, seed=5)
        n = lanes[0] if lanes else 1
        calls = {"gn_step": lambda f, a=(dx, ok, R, t): f(*a, EPS, True),
                 "so3_renormalize": lambda f, a=R: f(a)}
        for name, call in calls.items():
            kern, plain = fns[name]
            ms, pms = _time_alternating(lambda: call(kern), lambda: call(plain))
            host = _enqueue_us(lambda: call(kern))
            bound_ms, by = _bound(POSE_UPDATE_BYTES[name] * n, POSE_UPDATE_FLOPS[name] * n)
            print(f"phase 3 {name}, {n} lane(s) [{card}]: {ms:.4f} ms vs plain {pms:.4f} ms "
                  f"(median of {2 * TIMING_REPS} per-call CUDA-event samples in turns) | host "
                  f"time to enqueue {host:.1f} us | bound {bound_ms:.9f} ms by {by} "
                  f"({POSE_UPDATE_BYTES[name] * n} B, {POSE_UPDATE_FLOPS[name] * n} float32 "
                  "ops)", flush=True)
            label = name if not lanes else f"{name} B={n}"
            profile_later[label] = (lambda c=call, k=kern: c(k), True)
            profile_later[label + ", plain"] = (lambda c=call, k=plain: c(k), False)
            if not lanes:
                timing[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": by,
                                "err": errs[name]}
    return timing, profile_later


def _cells_and_slots(index, keys):
    """The distinct dense-table cells a lookup of `keys` reads, and the slot
    each key gets (0 for a miss, as the kernels read row 0 then)."""
    from loc_lib_tpu_torch.ops import voxel

    rel = voxel.key_to_coords(keys) - index.lo
    ok = (keys != voxel.INVALID_KEY) & voxel._in_dims(rel, index.dims)
    flat = torch.where(ok, (rel[..., 0] * index.dims[1] + rel[..., 1]) * index.dims[2]
                       + rel[..., 2], 0)
    return torch.unique(flat).numel(), torch.clamp(index.table[flat.to(torch.int64)], min=0)


def _k2_target_bytes(q, mask, R, t, index):
    """Bytes K2 from the target must move for these inputs: points and mask,
    each distinct table cell (4 B) and plane row (32 B) the 7-voxel stencils
    touch, the pose and index scalars, the outputs."""
    from loc_lib_tpu_torch.ops import kernels, voxel

    c = voxel.voxel_coords(kernels.transform_plain(q, R, t), index.inv_leaf, index.origin)
    keys7 = voxel.coords_to_key(c[:, None, :] + voxel.nearby6(q.device)[None], mask[:, None])
    cells, slots = _cells_and_slots(index, keys7)
    return (q.shape[0] * 13 + cells * 4 + torch.unique(slots).numel() * 32
            + POSE_BYTES + INDEX_BYTES + OUT_BYTES)


def _k1_target_bytes(q, mask, R, t, oct_table, index):
    """Bytes K1 from the target must move: points and mask, each distinct
    table cell, octant entry (4 B) and plane row (32 B) touched, scalars,
    outputs."""
    from loc_lib_tpu_torch.ops import kernels, voxel

    u = (kernels.transform_plain(q, R, t) - index.origin) * index.inv_leaf
    fl = torch.floor(u)
    octant = ((u - fl > 0.5).to(torch.int64) * torch.tensor([1, 2, 4], device=q.device)).sum(1)
    cells, slots = _cells_and_slots(index, voxel.coords_to_key(fl.to(torch.int32), mask))
    entry = slots.to(torch.int64) * 8 + octant
    rows = oct_table.reshape(-1)[entry]
    return (q.shape[0] * 13 + cells * 4 + torch.unique(entry).numel() * 4
            + torch.unique(rows).numel() * 32 + POSE_BYTES + INDEX_BYTES + OUT_BYTES)


def _lattice_target(device, side=16):
    """A hand-made target for the boundary cases: every 1 m cell of a
    side^3 block around the origin is occupied, its centroid at the cell
    centre, its plane through the centroid with the normal along the axis
    (cx + cy + cz) mod 3, so face neighbours carry different planes. A point
    on a voxel corner (integer coordinates) is then exactly equidistant from
    its own centroid and those of its -x, -y and -z neighbours. The same
    cells carry a line through the centroid along that axis (line_packed:
    W = [v0 v1 0], the two other axes). Returns (target with the octant
    tables and the line table, options)."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import voxel

    opts = icp.IcpOptions(method="p2plane_vox_oct", dense_dims=(2 * side,) * 3)
    r = torch.arange(side, device=device) - side // 2
    c = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), dim=-1).reshape(-1, 3).to(torch.int32)
    keys = voxel.coords_to_key(c, torch.ones(c.shape[0], dtype=torch.bool, device=device))
    if not bool(torch.all(keys[1:] > keys[:-1])):
        raise AssertionError("lattice keys are not sorted")
    v = keys.shape[0]
    mu = c.to(torch.float32) + 0.5
    normal = torch.nn.functional.one_hot((c.sum(1) % 3).to(torch.int64), 3).to(torch.float32)
    packed = torch.cat([normal, -(normal * mu).sum(1, keepdim=True), mu,
                        torch.ones((v, 1), device=device)], dim=1).contiguous()
    grid = voxel.HashGrid(
        voxel_keys=keys, bucket_xyz=torch.zeros((v, 3), device=device),
        bucket_idx=torch.full((v, 1), -1, dtype=torch.int32, device=device),
        bucket_cnt=torch.zeros((v,), dtype=torch.int32, device=device),
        num_voxels=torch.tensor(v, dtype=torch.int32, device=device),
        overflow=torch.zeros((), dtype=torch.int32, device=device),
        inv_leaf=torch.ones((), device=device), origin=torch.zeros(3, device=device))
    dense = voxel.build_dense_index(keys, dims=opts.dense_dims)
    dense_oct, oct_table, packed_ext = icp._build_oct_tables(grid, dense, packed, opts)
    v0, v1 = normal.roll(1, dims=1), normal.roll(2, dims=1)
    W = torch.stack([v0, v1, torch.zeros_like(v0)], dim=2).reshape(v, 9)
    line_packed = torch.cat([mu, W, torch.ones((v, 1), device=device)], dim=1).contiguous()
    return icp.IcpTarget(grid=grid, packed=packed, dense=dense, dense_oct=dense_oct,
                         oct_table=oct_table, packed_ext=packed_ext,
                         line_packed=line_packed), opts


def phase_kernels_from_target(device, card, workload):
    """K2 and K1 from the target (the gather inside the kernel, the mode the
    matchers run) against their plain versions: on the headline's 65,536-point
    target at the init pose, on a second 65,536-point map at N = 8192 and
    8191 under a random pose, with every point masked, with every point
    missing the map (outside the key window; inside it but off the table),
    and on a lattice target with points exactly on voxel corners (4-way ties
    in the election: the point's own voxel must win) and exactly on the
    octant boundary. Counts exact, every entry within the per-entry bound;
    planted errors rejected; repeated calls bit-equal (the ticket resets).
    Then times at the headline inputs, in turns: the plain version, the
    composition this replaces (the gather in torch ops, then the kernel with
    the rows given) and the kernel from the target.
    Returns ({kernel name: dict of ms, plain_ms, bound, err}, the calls to
    profile at the end of the run)."""
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels
    from loc_lib_tpu_torch.utils import lie

    K1, K2 = "p2plane_fused_terms", "p2plane_pick_fused_terms"
    modes = {
        K2: (kernels.p2plane_pick_fused_terms_from_target,
             kernels.p2plane_pick_from_target_terms_plain,
             kernels.p2plane_pick_from_target_rows_plain),
        K1: (kernels.p2plane_fused_terms_from_target,
             kernels.p2plane_from_target_terms_plain,
             kernels.p2plane_from_target_rows_plain)}
    errs, ratio, cases = {K1: 0.0, K2: 0.0}, [0.0], []

    def tables(kname, target, opts):
        if kname == K2:
            return (target.packed, icp._index(target, opts, target.dense))
        return (target.packed_ext, target.oct_table, icp._index(target, opts, target.dense_oct))

    def check(kname, label, target, opts, src, R, t, gate=0.1, expect_zero=False):
        fn, plain, rows_fn = modes[kname]
        args = (src.xyz, src.mask, R, t, gate, *tables(kname, target, opts))
        got = fn(*args)
        torch.cuda.synchronize()
        A = rows_fn(*args)
        e, r = _compare(f"{kname} from target, {label}", got, plain(*args), A)
        if expect_zero and not _gram_is_zero(got):
            raise AssertionError(f"{kname} from target, {label}: expected G = 0")
        if not expect_zero and int(got[2]) < opts.min_effective_pts:
            raise AssertionError(f"{kname} from target, {label}: kept {int(got[2])} points")
        errs[kname], ratio[0] = max(errs[kname], e), max(ratio[0], r)
        short = "K2" if kname == K2 else "K1"
        cases.append(f"{short} {label} ok (cnt {int(got[2])}, err {e:.3g}, err/bound {r:.3g})")
        return got, A, args

    # the main path's own inputs: headline target, source at the init pose
    tgt_pc, src, _, _, R_init, t_init = workload
    opts = icp.IcpOptions(method="p2plane_vox_oct")
    target = icp.set_target(tgt_pc, opts)
    main = {}
    for kname in (K2, K1):
        got, A, args = check(kname, "headline inputs", target, opts, src, R_init, t_init)
        _planted_errors_are_caught(f"{kname} from target", got, A)
        for _ in range(50):     # the ticket must be back at 0 after every call
            again = modes[kname][0](*args)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{kname} from target: repeated calls differ")
        main[kname] = args
    cases.append("planted chi2 / b / H errors rejected; 50 repeats bit-equal")

    # a second stream gets its own scratch (partials and ticket) and the same bits
    torch.cuda.synchronize()
    before = len(kernels._scratch)
    side = torch.cuda.Stream(device=device)
    with torch.cuda.stream(side):
        on_side = [modes[K2][0](*main[K2]) for _ in range(20)][-1]
    on_main = modes[K2][0](*main[K2])
    torch.cuda.synchronize()
    if len(kernels._scratch) != before + 1 or not all(
            torch.equal(x, y) for x, y in zip(on_side, on_main)):
        raise AssertionError("K2 from target: a second stream did not get its own scratch "
                             "or gave other bits")
    cases.append("second stream: own scratch, same bits")

    # a second 65,536-point map, random poses, N = 8192 and 8191
    world = synthetic.make_world(num_points=200000, extent=80.0, seed=11)
    traj = synthetic.make_trajectory(num_frames=2, dt=0.1, speed=2.0)
    tgt2 = icp.set_target(synthetic.render_scan(
        world, traj.R[0], traj.t[0], max_range=70.0, max_points=N_TARGET, noise=0.01, seed=0,
        capacity=N_TARGET, device=device), opts)
    src2 = synthetic.render_scan(world, traj.R[0], traj.t[0], max_range=70.0,
                                 max_points=N_SOURCE, noise=0.01, seed=5, capacity=N_SOURCE,
                                 device=device)
    odd = src2._replace(xyz=src2.xyz[:8191].contiguous(), mask=src2.mask[:8191].contiguous())
    R2 = lie.so3_exp(torch.tensor([0.004, -0.006, 0.005], device=device))
    t2 = torch.tensor([0.05, -0.04, 0.02], device=device)
    eye, zero = torch.eye(3, device=device), torch.zeros(3, device=device)
    nobody = src2._replace(xyz=torch.full_like(src2.xyz, 1e6),
                           mask=torch.zeros_like(src2.mask))
    for kname in (K2, K1):
        check(kname, "second map N=8192", tgt2, opts, src2, R2, t2)
        check(kname, "second map N=8191", tgt2, opts, odd, R2, t2)
        check(kname, "all masked", tgt2, opts, nobody, R2, t2, expect_zero=True)
        check(kname, "all outside the key window", tgt2, opts,
              src2._replace(xyz=src2.xyz + 5000.0), eye, zero, expect_zero=True)
        check(kname, "all off the table", tgt2, opts, src2._replace(xyz=src2.xyz + 400.0),
              eye, zero, expect_zero=True)

    # voxel corners (4-way election ties) and octant boundaries, exactly
    lattice, lopts = _lattice_target(device)
    g = torch.Generator().manual_seed(1)
    corners = torch.randint(-7, 7, (4096, 3), generator=g).to(torch.float32)
    xyz = torch.cat([corners, corners + 0.5]).to(device)
    on_faces = src2._replace(xyz=xyz, mask=torch.ones(8192, dtype=torch.bool, device=device))
    rows7 = icp._p2plane_vox_rows7(lattice, lopts, on_faces, eye, zero)
    d2 = torch.sum((rows7[..., 4:7] - xyz[:, None, :]) ** 2, dim=-1)
    ties = int(torch.sum(torch.sum(d2 == d2.min(dim=1, keepdim=True).values, dim=1) > 1))
    if ties != 4096:
        raise AssertionError(f"lattice case: {ties} tied points, expected 4096")
    for kname in (K2, K1):
        got, _, _ = check(kname, "points on voxel corners and octant boundaries", lattice, lopts,
                          on_faces, eye, zero, gate=1.0)
        if int(got[2]) != 8192:
            raise AssertionError(f"{kname} from target: lattice case kept {int(got[2])} of 8192")
    cases.append(f"{ties} election ties: the point's own voxel wins")

    # times at the headline inputs, in turns
    def old_k2():
        rows = icp._p2plane_vox_rows7(target, opts, src, R_init, t_init)
        return kernels.p2plane_pick_fused_terms(src.xyz, rows, src.mask.to(torch.float32),
                                                R_init, t_init, 0.1)

    def old_k1():
        rows, w = icp._p2plane_vox_oct_rows(target, opts, src, R_init, t_init)
        return kernels.p2plane_fused_terms(src.xyz, rows[:, 0:4], w, R_init, t_init, 0.1)

    out, profile_later = {}, {}
    for kname, old, short in ((K2, old_k2, "K2"), (K1, old_k1, "K1")):
        fn, plain, _ = modes[kname]
        args = main[kname]
        fns = {"plain": lambda plain=plain, a=args: plain(*a), "torch gather + kernel": old,
               "from target": lambda fn=fn, a=args: fn(*a)}
        ms = _time_in_turns(fns)
        host = {label: _enqueue_us(f) for label, f in fns.items() if label != "plain"}
        if kname == K2:
            n_bytes = _k2_target_bytes(*args[:4], args[6])
            flops = FLOPS_K2_TARGET * src.capacity
        else:
            n_bytes = _k1_target_bytes(*args[:4], args[6], args[7])
            flops = FLOPS_K1_TARGET * src.capacity
        bound_ms, bound_by = _bound(n_bytes, flops)
        print(f"phase 3 {short} from the target at the headline inputs (N={src.capacity}) "
              f"[{card}]: per-call CUDA-event medians of {2 * TIMING_REPS} in turns: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + " | host time to enqueue one call: "
              + "; ".join(f"{k} {v:.1f} us" for k, v in host.items())
              + f" | bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} B, {flops} float32 ops)",
              flush=True)
        out[kname] = {"ms": ms["from target"], "plain_ms": ms["plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "err": errs[kname]}
        for label, f in fns.items():
            profile_later[f"{short} {label}"] = (f, label == "from target")
    print("phase 3 kernels from the target vs plain: " + "; ".join(cases), flush=True)
    print(f"phase 3 from the target, largest error / per-entry bound: {ratio[0]:.4g}", flush=True)
    return out, profile_later


def _random_k3(n, S, device, rng):
    """K3 inputs at the 50 m scale, laid out as the NDT path lays them out:
    mu and W are strided views of one gathered (N, S, 13) row tensor.
    Voxel means 0.4 m from the points, random SPD information, 70% of the
    (point, voxel) pairs valid."""
    q = rng.uniform(-50, 50, size=(n, 3)).astype(np.float32)
    R = _so3_exp(rng.normal(size=3) * 0.05).astype(np.float32)
    t = (rng.normal(size=3) * 0.2).astype(np.float32)
    qs = (q @ R.T + t).astype(np.float32)
    rows = np.zeros((n, S, 13), np.float32)
    rows[..., 0:3] = qs[:, None, :] + rng.normal(scale=0.4, size=(n, S, 3))
    B = rng.normal(size=(n, S, 3, 3))
    rows[..., 3:12] = np.linalg.cholesky(B @ np.swapaxes(B, -1, -2) + 0.5 * np.eye(3)) \
        .reshape(n, S, 9)
    rows[..., 12] = 1.0
    valid = (rng.uniform(size=(n, S)) < 0.7).astype(np.float32)
    d = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    rows_d = d(rows)
    return (d(q), d(qs), rows_d[..., 0:3], rows_d[..., 3:12], d(valid)), d(R), d(t)


def phase_kernels_k3(device, card):
    """K3 against its plain version: N = 8192 and 8191 with S = 7, weighted
    and direct; N = 8192, S = 1, weighted (the p2line_vox shape); all
    invalid (G = 0). Counts exact, every entry within the per-entry bound of
    K3's reduction depth; planted errors rejected; times at the NDT path's
    shape (N = 8192, S = 7, weighted)."""
    from loc_lib_tpu_torch.ops import kernels

    K3, K3p = kernels.ndt_fused_terms, kernels.ndt_fused_terms_plain
    rng = np.random.default_rng(3)
    err, ratio, cases = 0.0, 0.0, []
    main = None
    for n, S, weighted in ((8192, 7, True), (8192, 7, False), (8191, 7, True),
                           (8191, 7, False), (8192, 1, True)):
        args, R, t = _random_k3(n, S, device, rng)
        label = f"K3 N={n} S={S} {'weighted' if weighted else 'direct'}"
        got = K3(*args, R, t, NDT_TH, weighted)
        torch.cuda.synchronize()
        A = kernels.ndt_rows_plain(*args, R, t, NDT_TH, weighted)
        e, r = _compare(label, got, K3p(*args, R, t, NDT_TH, weighted), A, 3 * S)
        err, ratio = max(err, e), max(ratio, r)
        cases.append(f"{label} ok (cnt {int(got[2])}, err {e:.3g}, err/bound {r:.3g})")
        if n == 8192 and S == 7:
            _planted_errors_are_caught(label, got, A, 3 * S)
            again = K3(*args, R, t, NDT_TH, weighted)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{label}: not bitwise deterministic")
            if weighted:
                main = (args, R, t)
    cases.append("planted chi2 / b / H errors rejected; repeat calls bit-equal")

    n, S = 8192, 7
    pad = torch.full((n, 3), 1e6, device=device)
    zrows = torch.zeros((n, S, 13), device=device)
    for weighted in (True, False):
        if not _gram_is_zero(K3(pad, pad, zrows[..., 0:3], zrows[..., 3:12],
                                torch.zeros((n, S), device=device), torch.eye(3, device=device),
                                torch.zeros(3, device=device), NDT_TH, weighted)):
            raise AssertionError("K3: all-invalid input did not give G = 0")
    cases.append("all-invalid G=0 ok")

    args, R, t = main
    ms, pms = _time_alternating(lambda: K3(*args, R, t, NDT_TH, True),
                                lambda: K3p(*args, R, t, NDT_TH, True))
    # q and qs 24 B a point; mu 12, W 36 and valid 4 B a (point, voxel); R
    n_bytes = n * (24 + S * 52) + 36 + OUT_BYTES
    bound_ms, bound_by = _bound(n_bytes, FLOPS_K3_VOXEL * n * S)
    print("phase 3 K3 vs plain: " + "; ".join(cases), flush=True)
    print(f"phase 3 K3 largest error / per-entry bound: {ratio:.4g}", flush=True)
    print(f"phase 3 K3 times at N=8192, S=7, weighted (median of {2 * TIMING_REPS} per-call "
          f"CUDA-event samples) [{card}]: K3 {ms:.4f} ms vs plain {pms:.4f} ms; "
          f"bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} B)", flush=True)
    profile_later = {"K3": (lambda: K3(*args, R, t, NDT_TH, True), True),
                     "K3 plain": (lambda: K3p(*args, R, t, NDT_TH, True), False)}
    return {"ms": ms, "plain_ms": pms, "bound_ms": bound_ms, "bound_by": bound_by,
            "err": err}, profile_later


def _k3_map_bound(q, mask, R, t, packed, index, S, bin_mode, valid):
    """(bound_ms, bound_by, bytes, float32 operations) of K3 finding its own
    voxels, for these inputs: points and mask, each distinct table cell
    (4 B) and packed row the stencils touch, the pose and index scalars, the
    outputs; qs and the voxel coordinates per point and K3's rows per valid
    (point, voxel) pair (`valid` of them)."""
    from loc_lib_tpu_torch.ops import kernels, voxel

    c = voxel.voxel_coords(kernels.transform_plain(q, R, t), index.inv_leaf, index.origin,
                           mode=bin_mode)
    st = voxel.nearby6(q.device) if S == 7 else voxel.center1(q.device)
    cells, slots = _cells_and_slots(index, voxel.coords_to_key(c[:, None, :] + st[None],
                                                               mask[:, None]))
    n_bytes = (q.shape[0] * 13 + cells * 4 + torch.unique(slots).numel() * packed.shape[1] * 4
               + POSE_BYTES + INDEX_BYTES + OUT_BYTES)
    flops = q.shape[0] * (18 + 9) + int(valid) * FLOPS_K3_VOXEL
    return (*_bound(n_bytes, flops), n_bytes, flops)


def _loam_style_edges(cloud, device):
    """The edge points of a cloud as the LOAM path finds them: ring
    annotation (16 rings), then extract_features with bench_loam's options."""
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import loam

    fo = loam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    return loam.extract_features(synthetic.annotate_rings(cloud, num_rings=16, device=device),
                                 fo).edge


def phase_kernels_k3_from_map(device, card, workload):
    """K3 finding its own voxels (the modes the matchers run) against its
    plain versions and against the composition it replaces, which must give
    the same bits: the gather (and, for p2line, the election) in torch ops,
    then K3 with the rows given.

    From the map: every built body (S = 7 and 1, weighted on an
    update_incremental map and direct on a build_direct map, trunc and floor
    binning), N = 8192 and 8191, maps from the headline's 65,536-point target,
    the 8,192-point source at the headline's initial pose; all masked, an
    empty map, all outside the key window, all off the table (G = 0). p2line:
    a line target over the LOAM-style edge points of the headline target,
    the source's edge points; the same rejections; a lattice target with
    points on voxel corners (4-way ties: the point's own voxel must win).
    Counts exact, every entry within the per-entry bound; planted errors
    rejected; 50 repeats bit-equal; an S or binning the kernel was not built
    for raises. Then times at the main path's shape, in turns.
    Returns ({"ndt_fused_terms": dict of ms, plain_ms, bound, err}, the calls
    to profile at the end of the run)."""
    from loc_lib_tpu_torch.models import icp, ndt
    from loc_lib_tpu_torch.ops import kernels

    tgt_pc, src, _, _, R_init, t_init = workload
    odd = src._replace(xyz=src.xyz[:8191].contiguous(), mask=src.mask[:8191].contiguous())
    nobody = src._replace(xyz=torch.full_like(src.xyz, 1e6), mask=torch.zeros_like(src.mask))
    eye, zero = torch.eye(3, device=device), torch.zeros(3, device=device)
    state = {"err": 0.0, "ratio": 0.0}
    cases = []

    def same_bits(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def hold(label, got, plain, A, rows_per_point, composed, expect_zero, min_count):
        torch.cuda.synchronize()
        e, r = _compare(label, got, plain, A, rows_per_point)
        if not same_bits(got, composed):
            raise AssertionError(f"{label}: differs from the torch gather + rows-given kernel")
        if expect_zero and not _gram_is_zero(got):
            raise AssertionError(f"{label}: expected G = 0")
        if not expect_zero and int(got[2]) < min_count:
            raise AssertionError(f"{label}: kept only {int(got[2])} residuals")
        state["err"], state["ratio"] = max(state["err"], e), max(state["ratio"], r)
        cases.append(f"{label} ok (cnt {int(got[2])}, err {e:.3g}, err/bound {r:.3g})")

    def check_map(label, args, expect_zero=False):
        q, mask, R, t, th, weighted, packed, index, S, bin_mode = args
        got = kernels.ndt_fused_terms_from_map(*args)
        qs, mu, W, valid = kernels.ndt_stencil_rows_plain(q, mask, R, t, packed, index, S,
                                                          bin_mode)
        composed = kernels.ndt_fused_terms(q, qs, mu, W, valid, R, t, th, weighted)
        hold(f"K3 from map, {label}", got, kernels.ndt_from_map_terms_plain(*args),
             kernels.ndt_from_map_rows_plain(*args), 3 * S, composed, expect_zero, 100)
        return got

    def check_line(label, args, expect_zero=False, min_count=100):
        q, mask, R, t, gate, packed, index = args
        got = kernels.p2line_fused_terms_from_target(*args)
        qs, mu, W, w = kernels.p2line_elect_plain(q, mask, R, t, packed, index)
        composed = kernels.ndt_fused_terms(q, qs, mu, W, w, R, t, float(gate) ** 2, True)
        hold(f"K3 p2line, {label}", got, kernels.p2line_from_target_terms_plain(*args),
             kernels.p2line_from_target_rows_plain(*args), 3, composed, expect_zero, min_count)
        return got

    # from the map: every built body
    main = direct_main = None
    for bin_mode in ("trunc", "floor"):
        for method, weighted in (("incremental", True), ("direct", False)):
            for nearby, S in (("nearby6", 7), ("center", 1)):
                o = ndt.NdtOptions(method=method, voxel_size=1.0, nearby=nearby,
                                   bin_mode=bin_mode)
                m = (ndt.update_incremental(ndt.empty_incremental(o, device=device), tgt_pc, o)
                     if weighted else ndt.build_direct(tgt_pc, o))
                what = f"{'weighted' if weighted else 'direct'} S={S} {bin_mode}"
                args = ndt._from_map_args(m, o, src, R_init, t_init, weighted)
                got = check_map(f"{what} N={src.capacity}", args)
                check_map(f"{what} N={odd.capacity}",
                          ndt._from_map_args(m, o, odd, R_init, t_init, weighted))
                if (bin_mode, weighted, S) == ("trunc", False, 7):
                    direct_main = (m, o)
                if (bin_mode, weighted, S) == ("trunc", True, 7):
                    main = (m, o, args)
                    _planted_errors_are_caught("K3 from map", got,
                                               kernels.ndt_from_map_rows_plain(*args), 3 * S)
                    for _ in range(50):     # the ticket must be back at 0 after every call
                        again = kernels.ndt_fused_terms_from_map(*args)
                    if not same_bits(got, again):
                        raise AssertionError("K3 from map: repeated calls differ")
    m, o, main_args = main
    for weighted in (True, False):
        check_map(f"all masked, weighted={weighted}",
                  ndt._from_map_args(m, o, nobody, R_init, t_init, weighted), expect_zero=True)
        check_map(f"empty map, weighted={weighted}",
                  ndt._from_map_args(ndt.empty_incremental(o, device=device), o, src, R_init,
                                     t_init, weighted), expect_zero=True)
    check_map("all outside the key window",
              ndt._from_map_args(m, o, src._replace(xyz=src.xyz + 5000.0), eye, zero, True),
              expect_zero=True)
    check_map("all off the table",
              ndt._from_map_args(m, o, src._replace(xyz=src.xyz + 400.0), eye, zero, True),
              expect_zero=True)
    launched = kernels.LAUNCHES["ndt_fused_terms"]
    for bad in ((*main_args[:8], 5, "trunc"), (*main_args[:8], 7, "round")):
        try:
            kernels.ndt_fused_terms_from_map(*bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"K3 from map with S={bad[8]}, {bad[9]} binning did not raise")
    if kernels.LAUNCHES["ndt_fused_terms"] != launched:
        raise AssertionError("a refused K3 call counted a launch")
    cases.append("planted chi2 / b / H errors rejected; 50 repeats bit-equal; S=5 and "
                 "'round' binning raise")

    # p2line: a line target over LOAM-style edge points
    lo = icp.IcpOptions(method="p2line_vox")
    line_tgt = icp.set_target(_loam_style_edges(tgt_pc, device), lo)
    edges = _loam_style_edges(src, device)

    def line_args(target, opts, cloud, R, t, gate):
        return (cloud.xyz, cloud.mask, R, t, gate, target.line_packed,
                icp._index(target, opts, target.dense))

    line_main = line_args(line_tgt, lo, edges, R_init, t_init, lo.max_line_distance)
    got = check_line(f"headline edge points ({int(edges.mask.sum())} of N={edges.capacity}, "
                     f"{int(line_tgt.line_packed[:, 12].sum())} valid lines)", line_main,
                     min_count=lo.min_effective_pts)
    _planted_errors_are_caught("K3 p2line", got,
                               kernels.p2line_from_target_rows_plain(*line_main), 3)
    for _ in range(50):
        again = kernels.p2line_fused_terms_from_target(*line_main)
    if not same_bits(got, again):
        raise AssertionError("K3 p2line: repeated calls differ")
    odd_edges = edges._replace(xyz=edges.xyz[:8191].contiguous(),
                               mask=edges.mask[:8191].contiguous())
    check_line("N=8191, wide gate", line_args(line_tgt, lo, odd_edges, R_init, t_init, 2.5),
               min_count=lo.min_effective_pts)
    check_line("all masked", line_args(line_tgt, lo, nobody, R_init, t_init, 0.5),
               expect_zero=True)
    check_line("all outside the key window",
               line_args(line_tgt, lo, edges._replace(xyz=edges.xyz + 5000.0), eye, zero, 0.5),
               expect_zero=True)
    check_line("all off the table",
               line_args(line_tgt, lo, edges._replace(xyz=edges.xyz + 400.0), eye, zero, 0.5),
               expect_zero=True)
    # voxel corners: 4-way ties, the point's own voxel (the centre gather) must win
    lattice, lopts = _lattice_target(device)
    g = torch.Generator().manual_seed(2)
    corners = src._replace(
        xyz=torch.randint(-7, 7, (8192, 3), generator=g).to(torch.float32).to(device),
        mask=torch.ones(8192, dtype=torch.bool, device=device))
    largs = line_args(lattice, lopts, corners, eye, zero, 1.0)
    tie = check_line("points on voxel corners", largs)
    own = kernels.ndt_fused_terms(corners.xyz, *kernels.ndt_stencil_rows_plain(
        corners.xyz, corners.mask, eye, zero, lattice.line_packed, largs[6], 1, "floor"),
        eye, zero, 1.0, True)
    if int(tie[2]) != 8192 or not same_bits(tie, own):
        raise AssertionError("K3 p2line: on a 4-way tie the point's own voxel did not win")
    cases.append("8192 election ties: the point's own voxel wins")

    # times at the main path's shape, in turns
    def composed_map():
        q, mask, R, t, th, weighted, packed, index, S, bin_mode = main_args
        qs, mu, W, valid = kernels.ndt_stencil_rows_plain(q, mask, R, t, packed, index, S,
                                                          bin_mode)
        return kernels.ndt_fused_terms(q, qs, mu, W, valid, R, t, th, weighted)

    def composed_line():
        q, mask, R, t, gate, packed, index = line_main
        qs, mu, W, w = kernels.p2line_elect_plain(q, mask, R, t, packed, index)
        return kernels.ndt_fused_terms(q, qs, mu, W, w, R, t, float(gate) ** 2, True)

    out, profile_later = {}, {}
    valid_pairs = kernels.ndt_stencil_rows_plain(*main_args[:4], *main_args[6:])[3].sum()
    line_valid = kernels.p2line_elect_plain(*line_main[:4], *line_main[5:])[3].sum()
    for short, fns, bound in (
            ("K3 from map", {
                "plain": lambda: kernels.ndt_from_map_terms_plain(*main_args),
                "torch gather + kernel": composed_map,
                "from map": lambda: kernels.ndt_fused_terms_from_map(*main_args)},
             _k3_map_bound(*main_args[:4], *main_args[6:], valid_pairs)),
            ("K3 p2line", {
                "plain": lambda: kernels.p2line_from_target_terms_plain(*line_main),
                "torch gather + election + kernel": composed_line,
                "from target": lambda: kernels.p2line_fused_terms_from_target(*line_main)},
             _k3_map_bound(*line_main[:4], *line_main[5:], 7, "floor", line_valid))):
        ms = _time_in_turns(fns)
        host = {label: _enqueue_us(f) for label, f in fns.items() if label != "plain"}
        bound_ms, bound_by, n_bytes, flops = bound
        print(f"phase 3 {short} at the headline inputs (N={src.capacity}) [{card}]: per-call "
              f"CUDA-event medians of {2 * TIMING_REPS} in turns: "
              + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + " | host time to enqueue one call: "
              + "; ".join(f"{k} {v:.1f} us" for k, v in host.items())
              + f" | bound {bound_ms:.6f} ms by {bound_by} ({n_bytes} B, {flops} float32 ops)",
              flush=True)
        kernel_label = list(fns)[-1]
        out[short] = {"ms": ms[kernel_label], "plain_ms": ms["plain"], "bound_ms": bound_ms,
                      "bound_by": bound_by, "err": state["err"]}
        for label, f in fns.items():
            profile_later[f"{short}: {label}"] = (f, label == kernel_label)
    # the matchers' own linearizations: each must be ONE launch
    profile_later["ndt._ndt_terms weighted"] = (
        lambda: ndt._ndt_terms(m, o, src, R_init, t_init, True), True)
    profile_later["ndt._ndt_terms direct"] = (
        lambda: ndt._ndt_terms(*direct_main, src, R_init, t_init, False), True)
    profile_later["icp._p2line_vox_terms"] = (
        lambda: icp._p2line_vox_terms(line_tgt, lo, edges, R_init, t_init), True)
    print("phase 3 K3 from the map / p2line vs plain and vs torch gather + rows given "
          "(bit-equal): " + "; ".join(cases), flush=True)
    print(f"phase 3 K3 from the map / p2line, largest error / per-entry bound: "
          f"{state['ratio']:.4g}", flush=True)
    return out, profile_later


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


def phase_gather_before_after(device, card, workload, target):
    """What moving the gather into the kernels changes in a match, for
    p2plane_vox (K2) and p2plane_vox_oct (K1) on the headline workload:
    the matcher's GN loop over the composition the from-target kernels
    replace (the gather in torch ops, then the kernel with the rows / the
    plane given) against icp.scan_match as it ships. Both must give the same bits (the same
    rows, summed in the same order). Reports device launches per match and
    per GN iteration, device and host time under the profiler, and
    host-clock medians per match in turns (old, new, new, old)."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    _, src, _, _, R_init, t_init = workload

    def old_vox(tgt, opts, s, R, t, gate=None):
        rows7 = icp._p2plane_vox_rows7(tgt, opts, s, R, t)
        return kernels.p2plane_pick_fused_terms(s.xyz, rows7, s.mask.to(torch.float32), R, t,
                                                icp._gate(opts, gate))

    def old_oct(tgt, opts, s, R, t, gate=None):
        rows, w = icp._p2plane_vox_oct_rows(tgt, opts, s, R, t)
        return kernels.p2plane_fused_terms(s.xyz, rows[:, 0:4], w, R, t, icp._gate(opts, gate))

    for method, old in (("p2plane_vox", old_vox), ("p2plane_vox_oct", old_oct)):
        opts = icp.IcpOptions(method=method)

        def match_old():
            return icp._gauss_newton(old, target, opts, src, R_init, t_init)

        def match_new():
            return icp.scan_match(target, opts, src, R_init, t_init)

        res = {"old": match_old(), "new": match_new()}
        a, b = res["old"], res["new"]
        if a.iterations != b.iterations or not (torch.equal(a.R, b.R) and torch.equal(a.t, b.t)):
            raise AssertionError(f"{method}: the from-target kernel and the torch gather "
                                 "disagree on the match")
        fns = {"old": match_old, "new": match_new}
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            for _ in range(15):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[which]()
                torch.cuda.synchronize()
                times[which].append((time.perf_counter() - t0) * 1e3)
        prof = {k: _profiled(f, 5)[:3] for k, f in fns.items()}
        it = res["new"].iterations
        print(f"phase 4b {method}, {it} GN iterations, torch gather + kernel -> kernel from "
              f"the target [{card}]: device launches per match {prof['old'][0]:.0f} -> "
              f"{prof['new'][0]:.0f} (per iteration {prof['old'][0] / it:.0f} -> "
              f"{prof['new'][0] / it:.0f}); device ms per match {prof['old'][1]:.3f} -> "
              f"{prof['new'][1]:.3f}; host ms per match, profiler on {prof['old'][2]:.3f} -> "
              f"{prof['new'][2]:.3f}; host-clock median of 30 in turns "
              f"{np.median(times['old']):.3f} -> {np.median(times['new']):.3f} ms; same bits",
              flush=True)


# ---------------------------------------------------------------------------
# Phase 5: LIO mapping
# ---------------------------------------------------------------------------

def lio_options(matcher):
    """The LIO configuration of each matcher's phase: p2plane_vox planes
    (icp, icp_vox_inc) or 1 m NDT voxels (incremental for ndt_inc, direct
    for ndt), ESKF on, scan capacity 8192, every other option at its
    default (map_capacity 65,536, dense dims (256, 256, 64))."""
    from loc_lib_tpu_torch.models import icp, ndt
    from loc_lib_tpu_torch.pipeline import lio

    method = "incremental" if matcher == "ndt_inc" else "direct"
    return lio.LioOptions(matcher=matcher, icp=icp.IcpOptions(method="p2plane_vox"),
                          ndt=ndt.NdtOptions(method=method, voxel_size=1.0),
                          scan_capacity=8192, with_eskf=True)


def demo_log(frames=LIO_FRAMES):
    """The LIO / LOAM / Loc phases' log: make_demo_log(frames, capacity
    8192, yaw rate 0, 2 m/s), rendered from make_world(120000, extent 80,
    seed 0)."""
    from loc_lib_tpu_torch.io import logdir

    return logdir.make_demo_log(num_frames=frames, capacity=8192, yaw_rate=0.0, speed=2.0)


def drive_lio(device, opts, log, frames=None, features=None):
    """Drive Lio.add_measure over the log's measure groups (the first
    `frames`, or all) after a static IMU init from the first 150 samples.
    `features(k)` gives (surf, edge) clouds for matcher="loam", prepared
    outside the timed step. Returns (engine, per-step ms, scan indices, GN
    iterations, the state the last scan was matched against, the last scan,
    its edge cloud or None, its StepResult)."""
    from loc_lib_tpu_torch.pipeline import lio

    eng = lio.Lio(opts, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    if not eng.imu_inited:
        raise AssertionError("static IMU init failed")
    times, idxs, iters = [], [], []
    edge = None
    for mg in list(log.measures(imu_capacity=64))[:frames]:
        if features is None:
            scan = log.frame(mg.scan_index, device)
        else:
            scan, edge = features(mg.scan_index)
        before = eng.state          # the state the last scan is matched against
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid,
                              edge_scan=edge)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        idxs.append(mg.scan_index)
        iters.append(out.iterations)
    return eng, times, idxs, iters, before, scan, edge, out


def phase_lio(device, card, matcher="icp", label="phase 5", ate_limit=ATE_LIMIT_M):
    """LIO_FRAMES frames of the demo log (capacity 8192, yaw rate 0, 2 m/s)
    through Lio.add_measure after a static IMU init from the first 150
    samples. Returns (options, the state the last scan was matched against,
    the last scan, its StepResult, the GN iterations of the whole run, the
    per-frame poses)."""
    from loc_lib_tpu_torch.eval import metrics

    log = demo_log()
    opts = lio_options(matcher)
    eng, times, idxs, iters, before, scan, _, out = drive_lio(device, opts, log)
    poses = np.stack(eng.poses)
    if not np.isfinite(poses).all():
        raise AssertionError("LIO produced a non-finite pose")
    n_kf = len(eng.kf_poses)
    if n_kf < 2:
        raise AssertionError(f"LIO accepted only {n_kf} keyframes")
    ate = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    if not ate.rmse <= ate_limit:
        raise AssertionError(f"LIO {matcher} ATE RMSE {ate.rmse:.4f} m > {ate_limit} m")
    if eng.health.status == eng.health.LOST:
        raise AssertionError(f"LIO {matcher}: tracking health LOST "
                             f"({eng.health.total_bad} bad frames)")
    steady = np.asarray(times[LIO_WARMUP:])
    what = "p2plane_vox" if matcher == "icp" else matcher
    print(f"{label} LIO {LIO_FRAMES} frames ({what} + ESKF, capacity 8192): "
          f"ATE RMSE {ate.rmse:.4f} m (max {ate.max:.4f}, bound {ate_limit:.4f}), {n_kf} keyframes, "
          f"mean GN iterations {np.mean(iters[1:]):.2f}, health {eng.health.status} "
          f"({eng.health.total_bad} bad); "
          f"p50 {np.percentile(steady, 50):.2f} ms/scan, p95 "
          f"{np.percentile(steady, 95):.2f} ms/scan over frames {LIO_WARMUP}-"
          f"{LIO_FRAMES - 1} (host clock) [{card}]", flush=True)
    return opts, before, scan, out, int(np.sum(iters)), poses


def _modes_on_map(kernel, name, target, opts, scan, modes):
    """One kernel in both its modes against its plain versions on a path's
    own target; `modes` lists (mode, wrapper, plain version, rows function,
    arguments). Returns (max error, report text)."""
    err, text = 0.0, []
    for mode, fn, plain, rows_fn, args in modes:
        got = fn(*args)
        e, r = _compare(f"{kernel} {mode} on {name}", got, plain(*args), rows_fn(*args))
        if int(got[2]) < opts.min_effective_pts:
            raise AssertionError(f"{kernel} {mode} on {name} kept only {int(got[2])} points")
        err = max(err, e)
        text.append(f"{mode}: cnt {int(got[2])}, err {e:.3g}, err/bound {r:.3g}")
    return err, (f"{kernel} vs plain on {name} ({int(target.plane_valid.sum())} valid planes, "
                 f"N={scan.capacity}): " + "; ".join(text))


def _k2_on_map(name, target, opts, scan, R, t):
    """K2 with the rows given and from the target, on a path's own target."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    gate = opts.max_plane_distance
    given = (scan.xyz, icp._p2plane_vox_rows7(target, opts, scan, R, t),
             scan.mask.to(torch.float32), R, t, gate)
    from_target = (scan.xyz, scan.mask, R, t, gate, target.packed,
                   icp._index(target, opts, target.dense))
    return _modes_on_map("K2", name, target, opts, scan, (
        ("rows given", kernels.p2plane_pick_fused_terms,
         kernels.p2plane_pick_fused_terms_plain, kernels.p2plane_pick_rows_plain, given),
        ("from target", kernels.p2plane_pick_fused_terms_from_target,
         kernels.p2plane_pick_from_target_terms_plain,
         kernels.p2plane_pick_from_target_rows_plain, from_target)))


def _k1_on_map(name, target, opts, scan, R, t):
    """K1 with the plane given and from the target, on a path's own octant
    target."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    gate = opts.max_plane_distance
    rows, w = icp._p2plane_vox_oct_rows(target, opts, scan, R, t)
    given = (scan.xyz, rows[:, 0:4], w, R, t, gate)
    from_target = (scan.xyz, scan.mask, R, t, gate, target.packed_ext, target.oct_table,
                   icp._index(target, opts, target.dense_oct))
    return _modes_on_map("K1", name, target, opts, scan, (
        ("plane given", kernels.p2plane_fused_terms, kernels.p2plane_fused_terms_plain,
         kernels.p2plane_rows_plain, given),
        ("from target", kernels.p2plane_fused_terms_from_target,
         kernels.p2plane_from_target_terms_plain, kernels.p2plane_from_target_rows_plain,
         from_target)))


def phase_lio_k2_check(lio_last):
    """K2 against its plain version, in both modes, on the LIO path's own
    target: the local map the last scan was matched to, at that scan's
    final pose."""
    lio_opts, before, scan, out = lio_last[:4]
    err, text = _k2_on_map("the LIO local map", before.icp_target, lio_opts.icp, scan,
                           out.R, out.t)
    print(f"phase 5 {text}", flush=True)
    return err


def phase_lio_k3_check(ndt_last, label):
    """K3 against its plain versions on an NDT LIO path's own inputs: the
    map the last scan was matched to (incremental for ndt_inc, weighted;
    direct for ndt), that scan, its final pose. From the map (what the path
    runs) and with the rows given (the gather in torch ops): the two must
    give the same bits."""
    from loc_lib_tpu_torch.models import ndt
    from loc_lib_tpu_torch.ops import kernels

    lio_opts, before, scan, out = ndt_last[:4]
    m = before.ndt_map
    opts = lio_opts.ndt_inc if lio_opts.matcher == "ndt_inc" else lio_opts.ndt
    weighted = opts.method == "incremental"
    args = ndt._from_map_args(m, opts, scan, out.R, out.t, weighted)
    S = args[8]
    name = f"K3 on the LIO {lio_opts.matcher} map"
    got = kernels.ndt_fused_terms_from_map(*args)
    err, ratio = _compare(f"{name}, from map", got, kernels.ndt_from_map_terms_plain(*args),
                          kernels.ndt_from_map_rows_plain(*args), 3 * S)
    given = (scan.xyz, *kernels.ndt_stencil_rows_plain(*args[:4], *args[6:]), out.R, out.t,
             opts.res_outlier_th, weighted)
    got_given = kernels.ndt_fused_terms(*given)
    err_g, ratio_g = _compare(f"{name}, rows given", got_given,
                              kernels.ndt_fused_terms_plain(*given),
                              kernels.ndt_rows_plain(*given), 3 * S)
    if not all(torch.equal(x, y) for x, y in zip(got, got_given)):
        raise AssertionError(f"{name}: from map and rows given differ")
    if int(got[2]) < opts.min_effective_pts:
        raise AssertionError(f"{name} kept only {int(got[2])} residuals")
    print(f"{label} {name} vs plain ({int(m.estimated.sum())} estimated voxels, "
          f"N={scan.capacity}, S={S}, {'weighted' if weighted else 'direct'}, {opts.bin_mode}): "
          f"from map: cnt {int(got[2])}, err {err:.3g}, err/bound {ratio:.3g}; rows given: "
          f"err {err_g:.3g}, err/bound {ratio_g:.3g}; same bits", flush=True)
    return max(err, err_g)


# ---------------------------------------------------------------------------
# Phase 5f: run-to-run determinism of the map builds
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    """Two results (tensors, or NamedTuples of them, nested) hold the same
    bits: float tensors compared as raw int32 words (NaN-safe), the rest
    with ==."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and bool(torch.equal(a, b))
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_bits_equal(x, y) for x, y in zip(a, b))
    return a == b


def phase_determinism(device, card, workload):
    """The same map builds twice must give the same bits: icp.set_target on
    the headline's 65,536-point target (p2plane_vox_oct: grid, moments,
    planes, octant tables), one ndt.update_incremental merging the 8,192-point
    source into a map built from that target, and the first
    DETERMINISM_FRAMES frames of LIO icp and ndt_inc (poses)."""
    from loc_lib_tpu_torch.models import icp, ndt

    tgt_pc, src = workload[0], workload[1]
    opts = icp.IcpOptions(method="p2plane_vox_oct")
    if not _bits_equal(icp.set_target(tgt_pc, opts), icp.set_target(tgt_pc, opts)):
        raise AssertionError("icp.set_target is not run-to-run deterministic")
    nopts = ndt.NdtOptions(method="incremental", voxel_size=1.0)
    m0 = ndt.update_incremental(ndt.empty_incremental(nopts, device=device), tgt_pc, nopts)
    m1 = ndt.update_incremental(m0, src, nopts)
    if not _bits_equal(m1, ndt.update_incremental(m0, src, nopts)):
        raise AssertionError("ndt.update_incremental is not run-to-run deterministic")
    log = demo_log(DETERMINISM_FRAMES)
    cases = [f"set_target (65,536 points, {int(icp.set_target(tgt_pc, opts).plane_valid.sum())} "
             f"valid planes) bit-equal",
             f"update_incremental ({int(m1.estimated.sum())} estimated voxels) bit-equal"]
    for matcher in ("icp", "ndt_inc"):
        runs = [np.stack(drive_lio(device, lio_options(matcher), log)[0].poses) for _ in range(2)]
        if not np.array_equal(runs[0], runs[1]):
            raise AssertionError(f"LIO {matcher}: two runs of the same frames gave different "
                                 f"poses (max gap {np.abs(runs[0] - runs[1]).max():.3g})")
        cases.append(f"LIO {matcher} {DETERMINISM_FRAMES} frames x2: poses bit-equal")
    print("phase 5f determinism: " + "; ".join(cases) + f" [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 5e: LOAM odometry
# ---------------------------------------------------------------------------

def loam_options():
    """bench_suite.py's bench_loam configuration: LoamFeatureOptions(num_scan
    16, min_ring_pts 64), LoamOption defaults (surf p2plane_vox on K2, edge
    p2line_vox on K3 at S = 1, eps 1e-3), ESKF on, scan capacity 8192."""
    from loc_lib_tpu_torch.models import loam
    from loc_lib_tpu_torch.pipeline import lio

    fo = loam.LoamFeatureOptions(num_scan=16, min_ring_pts=64)
    return lio.LioOptions(matcher="loam", loam=loam.LoamOption(feature=fo),
                          scan_capacity=8192, with_eskf=True)


def phase_loam(device, card):
    """LIO_FRAMES frames of LOAM odometry: each scan ring-annotated up front
    (as the bench does: a sensor delivers the ring), then extract_features
    (timed on its own) and Lio.add_measure(surf, ..., edge_scan=edge) (the
    step time). Returns (options, the state the last scan was matched
    against, its surf and edge clouds, its StepResult, the GN iterations of
    the whole run)."""
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import loam

    log = demo_log()
    opts = loam_options()
    fo = opts.loam.feature
    ringed = [synthetic.annotate_rings(log.frame(k, device), num_rings=fo.num_scan, device=device)
              for k in range(log.scan_xyz.shape[0])]
    fe_ms, n_edge = [], []

    def features(k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f = loam.extract_features(ringed[k], fo)
        torch.cuda.synchronize()
        fe_ms.append((time.perf_counter() - t0) * 1e3)
        n_edge.append(int(f.edge.mask.sum()))
        return f.surf, f.edge

    eng, times, idxs, iters, before, surf, edge, out = drive_lio(device, opts, log,
                                                                 features=features)
    poses = np.stack(eng.poses)
    if not np.isfinite(poses).all():
        raise AssertionError("LOAM produced a non-finite pose")
    n_kf = len(eng.kf_poses)
    if n_kf < 2:
        raise AssertionError(f"LOAM accepted only {n_kf} keyframes")
    ate = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    if not ate.rmse <= ATE_LIMIT_LOAM_M:
        raise AssertionError(f"LOAM ATE RMSE {ate.rmse:.4f} m > {ATE_LIMIT_LOAM_M} m")
    if eng.health.status == eng.health.LOST:
        raise AssertionError(f"LOAM: tracking health LOST ({eng.health.total_bad} bad frames)")
    steady = np.asarray(times[LIO_WARMUP:])
    print(f"phase 5e LOAM {LIO_FRAMES} frames (surf p2plane_vox + edge p2line_vox + ESKF, "
          f"capacity 8192): ATE RMSE {ate.rmse:.4f} m (max {ate.max:.4f}, bound "
          f"{ATE_LIMIT_LOAM_M:.4f}), {n_kf} keyframes, mean GN iterations "
          f"{np.mean(iters[1:]):.2f}, health {eng.health.status} ({eng.health.total_bad} bad); "
          f"step p50 {np.percentile(steady, 50):.2f} ms/scan, p95 "
          f"{np.percentile(steady, 95):.2f} ms/scan over frames {LIO_WARMUP}-{LIO_FRAMES - 1} "
          f"(host clock) [{card}]", flush=True)
    fe = np.asarray(fe_ms[LIO_WARMUP:])
    print(f"phase 5e LOAM extract_features: p50 {np.percentile(fe, 50):.2f} ms, p95 "
          f"{np.percentile(fe, 95):.2f} ms per scan (host clock), {np.mean(n_edge):.0f} edge "
          f"points per scan [{card}]", flush=True)
    return opts, before, surf, edge, out, int(np.sum(iters))


def phase_loam_checks(loam_last):
    """K3 in p2line mode (what the path runs) and at S = 1, weighted, with
    the elected rows given, on the LOAM path's own edge map (same bits), and
    K2 on its own surf map: the maps the last scan was matched to, at that
    scan's final pose. Returns (K3 error, K2 error)."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    opts, before, surf, edge, out = loam_last[:5]
    tgt, eo, so = before.loam_target, opts.loam.edge_icp, opts.loam.surf_icp
    args = (edge.xyz, edge.mask, out.R, out.t, eo.max_line_distance, tgt.edge.line_packed,
            icp._index(tgt.edge, eo, tgt.edge.dense))
    got = kernels.p2line_fused_terms_from_target(*args)
    k3_err, r3 = _compare("K3 p2line on the LOAM edge map", got,
                          kernels.p2line_from_target_terms_plain(*args),
                          kernels.p2line_from_target_rows_plain(*args), 3)
    given = (edge.xyz, *icp._p2line_vox_rows(tgt.edge, eo, edge, out.R, out.t), out.R, out.t,
             eo.max_line_distance ** 2, True)
    got_given = kernels.ndt_fused_terms(*given)
    e_g, r_g = _compare("K3 S=1 on the LOAM edge map", got_given,
                        kernels.ndt_fused_terms_plain(*given), kernels.ndt_rows_plain(*given), 3)
    if not all(torch.equal(x, y) for x, y in zip(got, got_given)):
        raise AssertionError("K3 on the LOAM edge map: p2line mode and rows given differ")
    if int(got[2]) < eo.min_effective_pts:
        raise AssertionError(f"K3 on the LOAM edge map kept only {int(got[2])} residuals")
    k2_err, k2_text = _k2_on_map("the LOAM surf map", tgt.surf, so, surf, out.R, out.t)
    print(f"phase 5e K3 vs plain on the LOAM edge map "
          f"({int(tgt.edge.line_packed[:, 12].sum())} valid lines, N={edge.capacity}, "
          f"{int(edge.mask.sum())} edge points): p2line from target: cnt {int(got[2])}, err "
          f"{k3_err:.3g}, err/bound {r3:.3g}; S=1 weighted, rows given: err {e_g:.3g}, "
          f"err/bound {r_g:.3g}; same bits; {k2_text}", flush=True)
    return max(k3_err, e_g), k2_err


# ---------------------------------------------------------------------------
# Phase 7: localization against the prior map
# ---------------------------------------------------------------------------

def phase_loc(device, card, method, label, ate_limit=None, frames=None, **kw):
    """bench_suite.py's bench_loc configuration: the global map
    make_world(120000, extent 80, seed 0) (the demo log's world), its
    8,192-row scans, LocOptions(icp method `method`, ESKF on; box 150 m,
    margin 50 m and local_map_capacity 131,072 unless `kw` says otherwise),
    set_init_pose(gt[0]), then Loc.update_measure per frame. Returns (engine,
    options, the state the last scan was matched against, the last scan,
    its StepResult)."""
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.pipeline import loc

    log = demo_log()
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    opts = loc.LocOptions(icp=icp.IcpOptions(method=method), **kw)
    eng = loc.Loc(world, opts, device=device)
    eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
    times = []
    for mg in list(log.measures(imu_capacity=64))[:frames]:
        scan = log.frame(mg.scan_index, device)
        before = eng.state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.update_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    poses = np.stack(eng.poses)
    if not np.isfinite(poses).all():
        raise AssertionError(f"Loc {method} produced a non-finite pose")
    ate = metrics.ate(poses, log.gt_poses[:len(poses)])
    if ate_limit is not None and not ate.rmse <= ate_limit:
        raise AssertionError(f"Loc {method} ATE RMSE {ate.rmse:.4f} m > {ate_limit} m")
    if eng.health.status == eng.health.LOST:
        raise AssertionError(f"Loc {method}: tracking health LOST")
    first = 4 if len(times) > 4 else 0
    steady = np.asarray(times[first:])
    bound = "no bound" if ate_limit is None else f"bound {ate_limit:.4f}"
    print(f"{label} Loc {len(poses)} frames ({method} + ESKF, box {opts.box_size:g} m, margin "
          f"{opts.recrop_margin:g} m, crop capacity {opts.local_map_capacity}): ATE RMSE "
          f"{ate.rmse:.4f} m (max {ate.max:.4f}, {bound}), {eng.num_recrops} re-crops, health "
          f"{eng.health.status} ({eng.health.total_bad} bad); p50 "
          f"{np.percentile(steady, 50):.2f} ms/scan, p95 {np.percentile(steady, 95):.2f} "
          f"ms/scan over frames {first}-{len(poses) - 1} (host clock) [{card}]", flush=True)
    return eng, opts, before, scan, out


def phase_loc_crop_timing(card, loc_run, label):
    """The re-crop latency users see: the engine's own Loc._recrop around
    the last pose (crop of the global map, then the target build on the
    131,072-row crop), and its crop_local_map alone (median of 3 each, host
    clock). Run after the path, so it re-crops a finished engine."""
    from loc_lib_tpu_torch.pipeline import loc

    eng, opts = loc_run[0], loc_run[1]
    recrop_ms, crop_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crop = loc.crop_local_map(eng.map_xyz, eng.map_mask, eng.state.t, opts.box_size / 2.0,
                                  opts.local_map_capacity)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng._recrop()
        torch.cuda.synchronize()
        crop_ms.append((t1 - t0) * 1e3)
        recrop_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"{label} re-crop ({opts.icp.method}): Loc._recrop {np.median(recrop_ms):.2f} ms, of "
          f"which crop_local_map {np.median(crop_ms):.2f} ms ({int(crop.mask.sum())} of "
          f"{crop.capacity} rows inside) (median of 3, host clock) [{card}]", flush=True)


def phase_loc_k1_check(loc_run):
    """K1 against its plain version, in both modes, on the Loc oct path's
    own crop target, for the last scan at its final pose."""
    _, opts, before, scan, out = loc_run
    err, text = _k1_on_map("the Loc oct crop target", before.icp_target, opts.icp, scan,
                           out.R, out.t)
    print(f"phase 7b {text}", flush=True)
    return err


def phase_loc_k2_check(loc_run):
    """K2 against its plain version, in both modes, on the Loc p2plane_vox
    path's own crop target, for the last scan at its final pose."""
    _, opts, before, scan, out = loc_run
    err, text = _k2_on_map("the Loc crop target", before.icp_target, opts.icp, scan,
                           out.R, out.t)
    print(f"phase 7 {text}", flush=True)
    return err


# ---------------------------------------------------------------------------
# Phase 8: batched matching
# ---------------------------------------------------------------------------

def batch_workload(device):
    """bench_suite.py's throughput_batched workload (and the converged tail
    of tests/test_icp.py:596) from the port's generator: world (200000
    points, extent 80, seed 7), 65 poses of one trajectory (dt 0.1 s, 2 m/s),
    lane b matching the 2,048-point scan of pose b + 1 (seed 2b + 1) to the
    8,192-point scan of pose b (seed 2b), max range 70 m, noise 0.01, from
    the true relative pose with its translation off by N(0, 5 cm). Returns a
    dict: stacked target and source clouds, R0 (B, 3, 3), t0 (B, 3), the
    ground-truth translations (B, 3)."""
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import icp

    world = synthetic.make_world(num_points=200000, extent=80.0, seed=7)
    traj = synthetic.make_trajectory(num_frames=BATCH_LANES + 1, dt=0.1, speed=2.0)
    rng = np.random.default_rng(3)
    tgts, srcs, R0s, t0s, gts = [], [], [], [], []
    for b in range(BATCH_LANES):
        for clouds, k, n, seed in ((tgts, b, BATCH_TARGET_POINTS, 2 * b),
                                   (srcs, b + 1, BATCH_SOURCE_POINTS, 2 * b + 1)):
            clouds.append(synthetic.render_scan(
                world, traj.R[k], traj.t[k], max_range=70.0, max_points=n, noise=0.01,
                seed=seed, capacity=n, device=device)._replace(stamp=None))
        R0s.append(traj.R[b].T @ traj.R[b + 1])
        gts.append(traj.R[b].T @ (traj.t[b + 1] - traj.t[b]))
        t0s.append(gts[-1] + rng.normal(0.0, BATCH_INIT_SIGMA_M, 3))
    as_tensor = lambda a: torch.tensor(np.stack(a), dtype=torch.float32, device=device)
    return {"tgts": icp.stack_lanes(tgts), "srcs": icp.stack_lanes(srcs), "R0": as_tensor(R0s),
            "t0": as_tensor(t0s), "gt": np.stack(gts)}


def _loop_icp_options(method, **kw):
    """Slam3dOptions.loop_icp of the reference (p2plane_vox_oct, 30
    iterations, gate 0.5 m, 2 m leaves, 4-point planes) with `method`."""
    from loc_lib_tpu_torch.models import icp

    return icp.IcpOptions(**{**dict(method=method, max_iteration=30, max_plane_distance=0.5,
                                    grid_leaf=2.0, bucket_size=8, plane_min_pts=4), **kw})


def _lanes(tree, B):
    """The first B lanes of a stacked NamedTuple, contiguous."""
    from loc_lib_tpu_torch.models import icp

    return icp.tree_map(lambda x: x[:B].contiguous(), tree)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_batch_targets(device, card, bw):
    """The 64 stacked targets of phase 8 (octant tables included: the
    p2plane_vox tables are a subset), and ms per set_target_batch lane for
    both methods (host clock, second build)."""
    from loc_lib_tpu_torch.models import icp

    ms = {}
    for method in ("p2plane_vox", "p2plane_vox_oct"):
        o = _loop_icp_options(method)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            targets = icp.set_target_batch(bw["tgts"], o)
            torch.cuda.synchronize()
            ms[method] = (time.perf_counter() - t0) * 1e3 / BATCH_LANES
    mb = sum(x.numel() * x.element_size() for x in (
        targets.dense.table, targets.dense_oct.table, targets.oct_table, targets.packed_ext,
        targets.packed)) / BATCH_LANES / 2 ** 20
    print(f"phase 8 set_target_batch, {BATCH_LANES} targets of {BATCH_TARGET_POINTS} points, "
          f"2 m leaves, default dense_dims [{card}]: p2plane_vox {ms['p2plane_vox']:.2f} ms "
          f"per lane, p2plane_vox_oct {ms['p2plane_vox_oct']:.2f} ms per lane (lane by lane "
          f"set_target + stack, host clock); {mb:.1f} MiB of tables a lane "
          f"({int(targets.plane_valid[0].sum())} valid planes in lane 0)", flush=True)
    return targets


def phase_kernels_batch(device, card, bw, targets):
    """K2-batch and K1-batch (one launch for B matches) against their plain
    versions per lane and, bit for bit, against the scalar launch on each
    lane's inputs, at B = 1, 3 and 64 on phase 8's own targets, sources and
    poses: every lane has its own pose, tables and mask; lane 1's source is
    all masked, lane 2's lies outside the key window, lane 3's inside it but
    off its table (G = 0 there). With lanes switched off by `active`: the
    others' bits unchanged, the switched-off lanes zero, every ticket back at
    0 and a second call giving the same bits. On a second stream: its own
    scratch, the same bits. Planted errors in one lane's result are rejected.
    Then per-call times at B = 8 and 64 in turns with B scalar launches (and,
    at B = 8, the plain version lane by lane), each beside its bound (the
    bytes every lane must move over the memory rate), and B = 64 with half
    the lanes off, skipped against all lanes computed.
    Returns ({kernel name: max abs error}, the calls to profile later)."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    K1, K2 = "p2plane_fused_terms", "p2plane_pick_fused_terms"
    opts = _loop_icp_options("p2plane_vox_oct")
    gate = opts.max_plane_distance
    srcs = bw["srcs"]
    xyz, mask = srcs.xyz.clone(), srcs.mask.clone()
    mask[1] = False
    xyz[2] += 5000.0
    xyz[3] += 400.0
    srcs = srcs._replace(xyz=xyz, mask=mask)
    empty_lanes = (1, 2, 3)

    def args_of(kname, tg, sc, R, t, batched):
        index = (icp._index_batch if batched else icp._index)(
            tg, opts, tg.dense if kname == K2 else tg.dense_oct)
        tables = (tg.packed,) if kname == K2 else (tg.packed_ext, tg.oct_table)
        return (sc.xyz, sc.mask, R, t, gate, *tables, index)

    modes = {K2: (kernels.p2plane_pick_fused_terms_from_target_batch,
                  kernels.p2plane_pick_fused_terms_from_target,
                  kernels.p2plane_pick_from_target_terms_plain,
                  kernels.p2plane_pick_from_target_rows_plain,
                  kernels.p2plane_pick_from_target_terms_plain_batch, _k2_target_bytes),
             K1: (kernels.p2plane_fused_terms_from_target_batch,
                  kernels.p2plane_fused_terms_from_target,
                  kernels.p2plane_from_target_terms_plain,
                  kernels.p2plane_from_target_rows_plain,
                  kernels.p2plane_from_target_terms_plain_batch, _k1_target_bytes)}
    errs, ratio, cases, profile_later = {K1: 0.0, K2: 0.0}, 0.0, [], {}
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    for kname, short in ((K2, "K2-batch"), (K1, "K1-batch")):
        fn_b, fn_s, plain_s, rows_s, plain_b, bytes_of = modes[kname]
        for B in (1, 3, BATCH_LANES):
            tg, sc = _lanes(targets, B), _lanes(srcs, B)
            R, t = bw["R0"][:B].contiguous(), bw["t0"][:B].contiguous()
            bargs = args_of(kname, tg, sc, R, t, True)
            out = fn_b(*bargs)
            torch.cuda.synchronize()
            counts = []
            for b in range(B):
                sargs = args_of(kname, icp.take_lane(tg, b), icp.take_lane(sc, b), R[b], t[b],
                                False)
                lane = tuple(o[b] for o in out)
                A = rows_s(*sargs)
                e, r = _compare(f"{short} B={B} lane {b}", lane, plain_s(*sargs), A)
                if not _same_bits(lane, fn_s(*sargs)):
                    raise AssertionError(f"{short} B={B}: lane {b} differs from the scalar launch")
                if (b in empty_lanes) != _gram_is_zero(lane):
                    raise AssertionError(f"{short} B={B}: lane {b} is "
                                         f"{'not ' if b in empty_lanes else ''}zero")
                errs[kname], ratio = max(errs[kname], e), max(ratio, r)
                counts.append(int(lane[2]))
                if B == BATCH_LANES and b == 5:
                    _planted_errors_are_caught(f"{short} lane 5", lane, A)
            live = [c for b, c in enumerate(counts) if b not in empty_lanes]
            cases.append(f"{short} B={B} ok ({B} lanes vs plain and bit-equal to scalar; counts "
                         f"{min(live)}-{max(live)})")
        # lanes switched off (B = 64 from the loop above)
        active = torch.ones(BATCH_LANES, dtype=torch.bool, device=device)
        active[4::3] = False
        off = fn_b(*bargs, active)
        for b in range(BATCH_LANES):
            lane, full = tuple(o[b] for o in off), tuple(o[b] for o in out)
            if not (_same_bits(lane, full) if active[b] else _gram_is_zero(lane)):
                raise AssertionError(f"{short}: lane {b} wrong with lanes switched off")
        again = fn_b(*bargs)
        torch.cuda.synchronize()
        if bool(kernels._scratch[(device.index, stream)][1].any()):
            raise AssertionError(f"{short}: a ticket is not back at 0")
        if not _same_bits(out, again) or not _same_bits(off, fn_b(*bargs, active)):
            raise AssertionError(f"{short}: repeated calls differ")
        before = len(kernels._scratch)
        side = torch.cuda.Stream(device=device)
        with torch.cuda.stream(side):
            on_side = [fn_b(*bargs) for _ in range(5)][-1]
        torch.cuda.synchronize()
        if len(kernels._scratch) != before + 1 or not _same_bits(on_side, out):
            raise AssertionError(f"{short}: a second stream did not get its own scratch or "
                                 "gave other bits")
        cases.append(f"{short}: {int((~active).sum())} of {BATCH_LANES} lanes off ok (others' "
                     "bits unchanged, tickets 0, repeats bit-equal); second stream same bits; "
                     "planted errors in lane 5 rejected")

        # times, on the unmodified sources
        for B in (8, BATCH_LANES):
            tg, sc = _lanes(targets, B), _lanes(bw["srcs"], B)
            R, t = bw["R0"][:B].contiguous(), bw["t0"][:B].contiguous()
            bargs = args_of(kname, tg, sc, R, t, True)
            lanes = [args_of(kname, icp.take_lane(tg, b), icp.take_lane(sc, b), R[b], t[b], False)
                     for b in range(B)]
            fns = {f"{B} scalar launches": lambda ls=lanes, f=fn_s: [f(*a) for a in ls],
                   "one batched launch": lambda a=bargs, f=fn_b: f(*a)}
            reps = 25
            if B == 8:
                fns = {"plain, lane by lane": lambda a=bargs, f=plain_b: f(*a), **fns}
                reps = 10
            ms = _time_in_turns(fns, reps)
            host = _enqueue_us(fns["one batched launch"])
            n_bytes = sum(bytes_of(*a[:4], *a[6:]) if kname == K2 else bytes_of(*a[:4], a[6], a[7])
                          for a in lanes)
            flops = (FLOPS_K2_TARGET if kname == K2 else FLOPS_K1_TARGET) * B * sc.xyz.shape[1]
            bound_ms, bound_by = _bound(n_bytes, flops)
            print(f"phase 8 {short} B={B}, N={sc.xyz.shape[1]} a lane [{card}]: per-call "
                  f"CUDA-event medians of {2 * reps} in turns: "
                  + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f" | host time to enqueue the batched call {host:.1f} us | bound "
                  f"{bound_ms:.6f} ms by {bound_by} ({n_bytes} B over all lanes, {flops} "
                  "float32 ops)", flush=True)
            profile_later[f"{short} B={B}"] = (fns["one batched launch"], True)
            if B == BATCH_LANES:
                profile_later[f"{short} B={B} as {B} scalar launches"] = (
                    fns[f"{B} scalar launches"], False)
                half = torch.ones(B, dtype=torch.bool, device=device)
                half[::2] = False
                skip = {"all lanes computed": fns["one batched launch"],
                        "half the lanes off, skipped": lambda a=bargs, h=half, f=fn_b: f(*a, h)}
                ms = _time_in_turns(skip, 25)
                print(f"phase 8 {short} B={B} with half the lanes done [{card}]: "
                      + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                      + " per call (CUDA-event medians of 50 in turns; device times in phase 3b)",
                      flush=True)
                profile_later[f"{short} B={B}, half the lanes off, skipped"] = (
                    skip["half the lanes off, skipped"], True)
    print("phase 8 batched kernels vs plain and vs the scalar launch: " + "; ".join(cases),
          flush=True)
    print(f"phase 8 batched kernels, largest error / per-entry bound: {ratio:.4g}", flush=True)
    return errs, profile_later


def _batch_lanes_equal_scalar(label, opts, targets, srcs, R0, t0, res):
    """Every lane of a scan_match_batch result must have the bits of the
    scalar scan_match on that lane: R, t, converged, num_effective, chi2 and
    iterations."""
    from loc_lib_tpu_torch.models import icp

    for b in range(R0.shape[0]):
        one = icp.scan_match(icp.take_lane(targets, b), opts, icp.take_lane(srcs, b), R0[b],
                             t0[b])
        same = (_same_bits((one.R, one.t, one.chi2), (res.R[b], res.t[b], res.chi2[b]))
                and one.iterations == int(res.iterations[b])
                and bool(one.converged) == bool(res.converged[b])
                and int(one.num_effective) == int(res.num_effective[b]))
        if not same:
            raise AssertionError(f"{label}: lane {b} differs from its scalar scan_match")


def phase_batched_match(device, card, bw, targets):
    """The batched path at full width: 64 loop-registration matches through
    icp.scan_match_batch. p2plane_vox (batched K2) with the fixed 20
    iterations of the reference's throughput cell (eps = 0) at B = 8 and 64:
    ONE K2 launch per iteration for all lanes, every lane bit-equal to its
    scalar scan_match, scan_match_batch_chunked(chunk=8) equal to the direct
    call; then converged (eps default) at B = 64: every lane under 3 cm,
    median num_effective > 700. p2plane_vox_oct (batched K1) likewise, the
    converged run at the reference's loop_icp options. Matches per second at
    B = 1 (scalar), 8 and 64, fixed 20 iterations, host clock.

    The launches this phase reports are those of the scan_match_batch calls
    alone: every counter is set to 0 just before such a call and read just
    after it; the scalar matches the lanes are compared with, the chunked
    call and the timed calls run outside and are not counted.
    Returns ({label: callable} of the B = 64 matches to profile later, the
    summed launches of the counted calls)."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    kernel_of = {"p2plane_vox": "p2plane_pick_fused_terms", "p2plane_vox_oct": "p2plane_fused_terms"}
    srcs, R0, t0 = bw["srcs"], bw["R0"], bw["t0"]
    to_profile = {}
    batched_launches = dict.fromkeys(kernels.LAUNCHES, 0)
    for method, kname in kernel_of.items():
        fixed = _loop_icp_options(method, max_iteration=20, eps=0.0)
        converging = (icp.IcpOptions(method=method, grid_leaf=2.0, plane_min_pts=4)
                      if method == "p2plane_vox" else _loop_icp_options(method))

        def args_of(opts, B):
            return (_lanes(targets, B), opts, _lanes(srcs, B), R0[:B].contiguous(),
                    t0[:B].contiguous())

        def run(opts, B):
            """One counted scan_match_batch call; `its` iterations must be
            its of `kname` and of the pose update, and one projection."""
            args = args_of(opts, B)
            kernels.reset_launch_counts()
            res = icp.scan_match_batch(*args)
            launched = dict(kernels.LAUNCHES)
            its = int(res.iterations.max())
            if launched != {**dict.fromkeys(launched, 0), kname: its, "gn_step": its,
                            "so3_renormalize": 1}:
                raise AssertionError(f"phase 8 {method} B={B}: launches {launched} for {its} "
                                     f"iterations; expected {its} of {kname} and of gn_step, one "
                                     "of so3_renormalize")
            for k, v in launched.items():
                batched_launches[k] += v
            return args, res, launched

        notes = []
        for B in (8, BATCH_LANES):
            args, res, launched = run(fixed, B)
            if res.iterations.tolist() != [20] * B:
                raise AssertionError(f"phase 8 {method} B={B}: iterations "
                                     f"{res.iterations.tolist()}, expected 20 in every lane")
            _batch_lanes_equal_scalar(f"phase 8 {method} B={B}", fixed, args[0], args[2], args[3],
                                      args[4], res)
            notes.append(f"B={B}: {launched[kname]} {kname} launches for 20 iterations of {B} "
                         "lanes, every lane bit-equal to its scalar scan_match")
        chunked = icp.scan_match_batch_chunked(*args, chunk=8)
        if not _bits_equal(tuple(res), tuple(chunked)):
            raise AssertionError(f"phase 8 {method}: chunked(chunk=8) differs from the direct call")
        notes.append("scan_match_batch_chunked(chunk=8) at B=64 bit-equal to the direct call")

        args, res, launched = run(converging, BATCH_LANES)
        its = int(res.iterations.max())
        err = np.linalg.norm(res.t.double().cpu().numpy() - bw["gt"], axis=1)
        n_eff = float(np.median(res.num_effective.cpu().numpy()))
        if not (np.isfinite(err).all() and err.max() < BATCH_TAIL_M
                and n_eff > BATCH_MIN_MEDIAN_EFFECTIVE):
            raise AssertionError(f"phase 8 {method} converged: worst lane {err.max():.4f} m off "
                                 f"(lane {int(err.argmax())}), median num_effective {n_eff:.0f}")
        _batch_lanes_equal_scalar(f"phase 8 {method} converged", converging, args[0], args[2],
                                  args[3], args[4], res)
        notes.append(f"converged at B=64 (eps {converging.eps}, max {converging.max_iteration} "
                     f"iterations): {launched[kname]} launches = the slowest lane's iterations "
                     f"(lanes took {int(res.iterations.min())}-{its}), "
                     f"{int(res.converged.sum())}/{BATCH_LANES} converged, worst lane "
                     f"{err.max() * 100:.2f} cm, median num_effective {n_eff:.0f}, every lane "
                     "bit-equal to scalar")
        print(f"phase 8 {method} batched [{card}]: " + "; ".join(notes), flush=True)

        # matches per second, fixed 20 iterations
        lane0 = (icp.take_lane(targets, 0), fixed, icp.take_lane(srcs, 0), R0[0], t0[0])
        fns = {1: lambda a=lane0: icp.scan_match(*a)}
        for B in (8, BATCH_LANES):
            fns[B] = lambda a=args_of(fixed, B): icp.scan_match_batch(*a)
        rates = {}
        for B, fn in list(fns.items()) + list(fns.items())[::-1]:
            for _ in range(4):
                torch.cuda.synchronize()
                t_ = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                rates.setdefault(B, []).append((time.perf_counter() - t_) * 1e3)
        print(f"phase 8 {method} matches per second, fixed 20 iterations "
              f"({BATCH_TARGET_POINTS}-point targets, {BATCH_SOURCE_POINTS}-point sources; median "
              f"of 8 calls in turns, host clock) [{card}]: "
              + "; ".join(f"B={B}{' (scalar scan_match)' if B == 1 else ''} "
                          f"{B / np.median(ms) * 1e3:.1f} matches/s ({np.median(ms):.3f} ms per "
                          f"call)" for B, ms in rates.items()), flush=True)
        to_profile[f"{method} B={BATCH_LANES}, 20 iterations"] = fns[BATCH_LANES]
        to_profile[f"{method} B=1 (scalar), 20 iterations"] = fns[1]
    return to_profile, batched_launches


def phase_batched_profile(card, matches):
    """Launches and device against host time of one batched match under the
    profiler (after every host-clock timing): launches per GN iteration for
    all lanes, and the device's busy share."""
    for label, fn in matches.items():
        fn()
        n, dev_ms, host_ms, _ = _profiled(fn, 2)
        print(f"phase 6 profile batched match, {label}: {n:.0f} device launches "
              f"({n / 20:.1f} per GN iteration), device {dev_ms:.3f} ms vs host {host_ms:.3f} ms, "
              f"device busy {100 * dev_ms / host_ms:.1f}% (profiler on) [{card}]", flush=True)


def _structured_scene(rng, n=600):
    """tests/test_icp.py's scene: a floor and two walls."""
    a = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n), np.zeros(n)], 1)
    b = np.stack([rng.uniform(-10, 10, n), np.full(n, -10.0), rng.uniform(0, 5, n)], 1)
    c = np.stack([np.full(n, -10.0), rng.uniform(-10, 10, n), rng.uniform(0, 5, n)], 1)
    return np.concatenate([a, b, c]).astype(np.float32)


def phase_rest_of_icp(device, card, workload):
    """The other entry points of models/icp.py on the card: one match with a
    frozen election (freeze_election_after = 2, kernel K1 with the plane
    given) against the default p2plane_vox on the headline inputs, timed in
    turns, both within the headline's pose bounds and 1 cm of each other; and
    one match of each knn method (p2plane, p2p, p2line) on the pose-recovery
    workloads of tests/test_icp.py:37-59 within their bounds, with its
    fitness score."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels, pointcloud

    tgt_pc, src, R_gt, t_gt, R_init, t_init = workload
    runs = {"default": icp.IcpOptions(method="p2plane_vox"),
            "frozen": icp.IcpOptions(method="p2plane_vox", freeze_election_after=2)}
    target = icp.set_target(tgt_pc, runs["default"])
    res, times = {}, {k: [] for k in runs}
    for name in ("default", "frozen", "frozen", "default"):
        for _ in range(6):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            res[name] = icp.scan_match(target, runs[name], src, R_init, t_init)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t_) * 1e3)
    for name, r in res.items():
        rot_e = _rot_err(r.R.double().cpu().numpy(), R_gt)
        trans_e = float(np.linalg.norm(r.t.double().cpu().numpy() - t_gt))
        if not (rot_e < PARITY_ROT_RAD and trans_e < PARITY_TRANS_M and bool(r.converged)):
            raise AssertionError(f"{name} election match off ground truth: "
                                 f"{np.degrees(rot_e):.3f} deg / {trans_e:.4f} m")
    gap = float(torch.linalg.vector_norm(res["default"].t - res["frozen"].t))
    if not gap < 1e-2:
        raise AssertionError(f"frozen election lands {gap:.4f} m from the default match")
    before = kernels.LAUNCHES["p2plane_fused_terms"]
    frozen = icp.scan_match(target, runs["frozen"], src, R_init, t_init)
    k1 = kernels.LAUNCHES["p2plane_fused_terms"] - before
    if k1 != frozen.iterations:
        raise AssertionError(f"frozen election: {k1} K1 launches for {frozen.iterations} iterations")
    print(f"phase 9 frozen election on the headline inputs (p2plane_vox, 65,536-point target, "
          f"N={src.capacity}) [{card}]: default {np.median(times['default'][1:]):.3f} ms per "
          f"match ({res['default'].iterations} iterations), freeze_election_after=2 "
          f"{np.median(times['frozen'][1:]):.3f} ms ({frozen.iterations} iterations, {k1} K1 "
          f"plane-given launches); poses {gap * 1000:.2f} mm apart (median of 11 in turns, host "
          "clock)", flush=True)

    lines = []
    for z in range(5):
        ts = np.random.default_rng(2 + 10 * z).uniform(-10, 10, 150)
        lines.append(np.stack([ts, np.full_like(ts, z * 2.0 - 5), np.full_like(ts, z * 1.0)], 1))
        lines.append(np.stack([np.full_like(ts, z * 2.0 - 5), ts, np.full_like(ts, z * 0.7)], 1))
    cases = (("p2plane", _structured_scene(np.random.default_rng(0)), [0.02, -0.03, 0.04],
              [0.3, -0.2, 0.15], 5e-3, 5e-2),
             ("p2p", _structured_scene(np.random.default_rng(1)), [0.01, 0.02, -0.02],
              [0.15, 0.1, -0.1], 2e-2, 1e-1),
             ("p2line", np.concatenate(lines).astype(np.float32), [0.01, -0.01, 0.02],
              [0.1, 0.05, -0.05], 2e-2, 5e-2))
    out = []
    eye, zero = torch.eye(3, device=device), torch.zeros(3, device=device)
    for method, scene, w, trans, rot_bound, t_bound in cases:
        R_true, t_true = _so3_exp(np.asarray(w)), np.asarray(trans)
        opts = icp.IcpOptions(method=method)
        tgt = icp.set_target(pointcloud.from_numpy(scene, capacity=2048, device=device), opts)
        sc = pointcloud.from_numpy(((scene - t_true) @ R_true).astype(np.float32), capacity=2048,
                                   device=device)
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            r = icp.scan_match(tgt, opts, sc, eye, zero)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t_) * 1e3)
        rot_e = _rot_err(r.R.double().cpu().numpy(), R_true)
        trans_e = float(np.linalg.norm(r.t.double().cpu().numpy() - t_true))
        fit = float(icp.get_fitness_score(tgt, opts, sc, r.R, r.t))
        if not (rot_e < rot_bound and trans_e < t_bound and np.isfinite(fit)):
            raise AssertionError(f"knn method {method} off the true pose: {rot_e:.4f} rad / "
                                 f"{trans_e:.4f} m (bounds {rot_bound} / {t_bound}), fitness {fit}")
        out.append(f"{method}: {r.iterations} iterations, {rot_e:.4f} rad / {trans_e * 100:.2f} cm "
                   f"off, n_eff {int(r.num_effective)}, fitness {fit:.5f} m^2, "
                   f"{np.median(ms):.2f} ms per match")
    print(f"phase 9 knn methods on the card (2,048-row clouds, plain torch ops, no kernel) "
          f"[{card}]: " + "; ".join(out), flush=True)


def _count_syncs(fn):
    """Host synchronizations while `fn` runs (torch.cuda.set_sync_debug_mode
    warnings), and its result."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return len([w for w in caught if "synchroniz" in str(w.message)]), out


def phase_lio_syncs(device, card):
    """Host synchronizations per LIO scan (matcher icp, ESKF on): the
    warnings torch.cuda.set_sync_debug_mode("warn") raises over frames 4-11
    of a 12-frame run, per scan."""
    from loc_lib_tpu_torch.pipeline import lio

    log = demo_log(12)
    eng = lio.Lio(lio_options("icp"), device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    mgs = list(log.measures(imu_capacity=64))
    scans = [log.frame(mg.scan_index, device) for mg in mgs]
    for mg, scan in zip(mgs[:4], scans):
        eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)

    def rest():
        for mg, scan in zip(mgs[4:], scans[4:]):
            eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
    n_syncs, _ = _count_syncs(rest)
    per_scan = n_syncs / len(mgs[4:])
    print(f"phase 5 host synchronizations per LIO icp scan: {per_scan:.1f} ({n_syncs} over "
          f"frames 4-{len(mgs) - 1}, torch.cuda.set_sync_debug_mode) [{card}]", flush=True)
    return per_scan


def phase_kernel_device_times(card, calls):
    """Device time per call of every kernel, mode and plain version at the
    shapes phase 3 timed (torch.profiler, summed kernel time over 20 calls).
    Run after every host-clock timing of the paths: once the profiler
    has run in a process, every later launch costs the host more. A kernel
    call must be ONE launch. Returns {label: device ms, or None where the
    profiler recorded no device event}."""
    dev = {}
    for label, (fn, one_launch) in calls.items():
        fn()
        launches, ms, _, _ = _profiled(fn, 20)
        if launches == 0 or (not one_launch and launches != round(launches)):
            # no event, or a session that handed over part of a chain's events
            dev[label] = (None, 0)
            continue
        if one_launch:
            # a session may also hand over fewer events than were launched,
            # never more: over 1 per call is a second launch
            if launches > 1:
                raise AssertionError(f"{label}: {launches} launches per call, expected 1")
            ms, launches = ms / launches, 1
        dev[label] = (ms, launches)
    print("phase 3b device time per call (torch.profiler, kernels only; N=8192 scalar calls, "
          f"{BATCH_SOURCE_POINTS}-point lanes for the batched ones) "
          f"[{card}]: " + "; ".join(
              f"{k} not measured (the profiler recorded no device event in 3 sessions, or "
              "only part of the call's)"
              if ms is None else f"{k} {ms:.4f} ms in {n:.0f} launches"
              for k, (ms, n) in dev.items()), flush=True)
    return {k: v[0] for k, v in dev.items()}


# ---------------------------------------------------------------------------
# Phase 10: 3D SLAM
# ---------------------------------------------------------------------------

def slam3d_log(frames):
    """bench_suite.py:497's log: two laps of a circle (dt 0.2 s, 1.4 m/s, yaw
    rate 0.72 rad/s) through a 60,000-point world of extent 16 m, scans of
    2,048 points out to 14 m, IMU on."""
    from loc_lib_tpu_torch.io import logdir

    return logdir.make_demo_log(num_frames=frames, capacity=SLAM_CAPACITY, dt=0.2, speed=1.4,
                                yaw_rate=0.72, world_points=60000, extent=16.0, max_range=14.0)


def slam3d_options(loop_icp=None, sc_topk=3):
    """bench_suite.py:505-517's configuration: LIO icp / p2plane_vox + ESKF
    (3 keyframes in the local map, 0.4 m keyframe gate), ScanContext with
    an 8-keyframe exclusion and a 0.25 gate, loops gated at 60 effective
    points and 0.1 m^2, sc_topk 3, p2plane_vox loop registration (20
    iterations, 0.5 m gate, 2 m leaves); `loop_icp` replaces the latter."""
    from loc_lib_tpu_torch.graph import scan_context as sc
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.pipeline import lio, slam3d

    if loop_icp is None:
        loop_icp = icp.IcpOptions(method="p2plane_vox", max_iteration=20, max_plane_distance=0.5,
                                  grid_leaf=2.0, plane_min_pts=4)
    return slam3d.Slam3dOptions(
        lio=lio.LioOptions(matcher="icp", icp=icp.IcpOptions(method="p2plane_vox"),
                           scan_capacity=SLAM_CAPACITY, with_eskf=True, kf_distance=0.4,
                           num_kfs_in_local_map=3),
        sc=sc.ScanContextOptions(exclude_recent=8, dist_threshold=0.25),
        loop=slam3d.LoopOptions(min_keyframe_gap=8, max_candidate_dist=10.0,
                                min_effective_pts=60, max_chi2_per_pt=0.1, optimize_every=100,
                                sc_topk=sc_topk),
        loop_icp=loop_icp)


class _BatchSpy:
    """Wraps icp.scan_match_batch while a 3D SLAM run is driven: every
    batched loop registration must launch its batched kernel `kernel` (and
    gn_step) exactly once per GN iteration for all lanes. Records, per call,
    lanes, iterations and launches."""

    def __init__(self, kernel):
        from loc_lib_tpu_torch.models import icp
        from loc_lib_tpu_torch.ops import kernels

        self.icp, self.kernels, self.kernel = icp, kernels, kernel
        self.orig = icp.scan_match_batch
        self.calls = []

    def __call__(self, targets, opts, srcs, R0, t0):
        before = dict(self.kernels.LAUNCHES)
        res = self.orig(targets, opts, srcs, R0, t0)
        it = int(res.iterations.max())
        got = {k: self.kernels.LAUNCHES[k] - before[k] for k in (self.kernel, "gn_step")}
        if got[self.kernel] != it or got["gn_step"] != it:
            raise AssertionError(f"batched loop registration: {got} launches for {it} GN "
                                 f"iterations of {R0.shape[0]} lanes")
        self.calls.append((R0.shape[0], it))
        return res

    def __enter__(self):
        self.icp.scan_match_batch = self
        return self

    def __exit__(self, *exc):
        self.icp.scan_match_batch = self.orig


def drive_slam3d(device, opts, log):
    """Slam3d.add_measure over the log after a static IMU init from the first
    150 samples, then optimize() twice. Returns a dict: engine, per-scan ms,
    whether each scan ran a loop registration, ms per registration, keyframe
    ATE before / after the pose graph, first and second optimize() ms, the
    keyframe poses after the first one."""
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.pipeline import slam3d

    eng = slam3d.Slam3d(opts, device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    if not eng.imu_inited:
        raise AssertionError("static IMU init failed")
    reg_ms, register = [], eng._register_loops

    def timed_register(cands, kf_id, scan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = register(cands, kf_id, scan)
        torch.cuda.synchronize()
        reg_ms.append((time.perf_counter() - t0) * 1e3)
        return n

    eng._register_loops = timed_register
    times, event = [], []
    for mg in log.measures(imu_capacity=64):
        scan = log.frame(mg.scan_index, device)
        n_reg = len(reg_ms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        event.append(len(reg_ms) > n_reg)
        if eng.lio.health.status == eng.lio.health.LOST:
            raise AssertionError(f"3D SLAM: tracking health LOST at frame {mg.scan_index}")
    kf_gt = log.gt_poses[np.asarray(eng.kf_frame)]
    before = metrics.ate(eng.keyframe_poses(), kf_gt).rmse
    opt_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not eng.optimize():
            raise AssertionError("3D SLAM: optimize() did not run")
        opt_ms.append((time.perf_counter() - t0) * 1e3)
        if len(opt_ms) == 1:
            poses = eng.keyframe_poses()
            cg = eng.cg_iterations
    after = metrics.ate(poses, kf_gt).rmse
    return {"engine": eng, "times": np.asarray(times), "event": np.asarray(event),
            "reg_ms": reg_ms, "before": before, "after": after, "opt_ms": opt_ms,
            "poses": poses, "cg": cg}


def _loops_line(run):
    eng = run["engine"]
    return (f"{len(eng.kf_R)} keyframes, {len(eng.loops)} loops accepted, "
            f"{int(eng.loop_inliers.sum())} inliers")


def phase_slam3d(device, card):
    """10a, the slam3d_loop cell uncut: 92 frames, scan capacity 2048, LIO
    icp / p2plane_vox + ESKF, sc_topk 3, sc_capacity 4096, max_loops 512,
    p2plane_vox loop registration (K2-batch). Fails unless a loop with an
    inlier was accepted, optimize() ran, the keyframe ATE after the pose
    graph is below the ATE before it and within ATE_LIMIT_SLAM_M, health was
    never LOST, every batched registration launched K2-batch once per GN
    iteration, and a second run gives the same keyframe poses bit for bit.
    Returns (the second run's engine, the first run's launch counts)."""
    from loc_lib_tpu_torch.ops import kernels

    log = slam3d_log(SLAM_FRAMES)
    opts = slam3d_options()
    kernels.reset_launch_counts()
    with _BatchSpy("p2plane_pick_fused_terms") as spy:
        run = drive_slam3d(device, opts, log)
    counts = dict(kernels.LAUNCHES)
    eng = run["engine"]
    if not spy.calls:
        raise AssertionError("3D SLAM: no batched loop registration ran")
    if not (len(eng.loops) >= 1 and int(eng.loop_inliers.sum()) >= 1):
        raise AssertionError(f"3D SLAM: {_loops_line(run)}")
    if not (run["after"] < run["before"] and run["after"] <= ATE_LIMIT_SLAM_M):
        raise AssertionError(f"3D SLAM: keyframe ATE {run['before']:.4f} -> {run['after']:.4f} m "
                             f"(bound {ATE_LIMIT_SLAM_M:.4f})")
    with _BatchSpy("p2plane_pick_fused_terms"):
        again = drive_slam3d(device, opts, log)
    if not np.array_equal(again["poses"], run["poses"]):
        gap = np.abs(again["poses"] - run["poses"]).max()
        raise AssertionError(f"3D SLAM: two runs differ after optimize() by {gap:.3g}")
    syncs, _ = _count_syncs(again["engine"].optimize)
    t, ev = run["times"], run["event"]
    print(f"phase 10a slam3d_loop ({SLAM_FRAMES} frames, capacity {SLAM_CAPACITY}, sc_topk 3, "
          f"p2plane_vox loop registration) [{card}]: {_loops_line(run)}; keyframe ATE "
          f"{run['before']:.4f} -> {run['after']:.4f} m after the pose graph (bound "
          f"{ATE_LIMIT_SLAM_M:.4f}), health {eng.lio.health.status}; p50 per scan "
          f"{np.percentile(t[~ev], 50):.2f} ms without a loop event ({int((~ev).sum())} scans), "
          f"{np.percentile(t[ev], 50):.2f} ms with one ({int(ev.sum())}); "
          f"{np.median(run['reg_ms']):.2f} ms per loop registration (median of "
          f"{len(run['reg_ms'])}; {len(spy.calls)} batched, lanes x iterations "
          f"{sorted(set(spy.calls))}, one K2-batch and one gn_step launch per GN iteration); "
          f"optimize() first {run['opt_ms'][0]:.1f} ms, second {run['opt_ms'][1]:.1f} ms, "
          f"{run['cg']} PCG iterations in the first, {syncs} host syncs in a third; "
          f"a second run gives the same keyframe poses bit for bit (host clock)", flush=True)
    return again["engine"], counts


def phase_slam3d_default_loop_icp(device, card):
    """10b: the same log at 46 frames with Slam3dOptions()'s loop_icp
    (p2plane_vox_oct), at sc_topk 1 (scalar K1 in the pipeline) and 3
    (K1-batch, and scalar K1 where one candidate survives). Returns the K1
    launches of both runs."""
    from loc_lib_tpu_torch.ops import kernels
    from loc_lib_tpu_torch.pipeline import slam3d

    log = slam3d_log(SLAM_SHORT_FRAMES)
    total = 0
    for topk in (1, 3):
        kernels.reset_launch_counts()
        with _BatchSpy("p2plane_fused_terms") as spy:
            run = drive_slam3d(device, slam3d_options(slam3d.Slam3dOptions().loop_icp, topk), log)
        k1 = kernels.LAUNCHES["p2plane_fused_terms"]
        if k1 <= 0 or (topk == 3) != bool(spy.calls):
            raise AssertionError(f"10b sc_topk {topk}: {k1} K1 launches, {len(spy.calls)} "
                                 "batched registrations")
        total += k1
        print(f"phase 10b default loop_icp (p2plane_vox_oct), {SLAM_SHORT_FRAMES} frames, "
              f"sc_topk {topk} [{card}]: {_loops_line(run)}; keyframe ATE {run['before']:.4f} "
              f"-> {run['after']:.4f} m; {k1} K1 launches ({len(spy.calls)} batched "
              f"registrations, each one K1-batch launch per GN iteration); "
              f"{np.median(run['reg_ms']):.2f} ms per loop registration", flush=True)
    return total


def pgo_graph(device):
    """tests/test_graph.py:140's graph: 4,096 poses on four laps of a 30 m
    circle, odometry drifted by N(0, 1 cm) a step, 512 loop edges one lap
    apart (true relative poses), information 1e4."""
    from loc_lib_tpu_torch.graph import pose_graph as pg
    from loc_lib_tpu_torch.utils import lie

    rng = np.random.default_rng(11)
    m = PGO_NODES
    ang = np.linspace(0, 8 * np.pi, m)
    t_gt = np.stack([np.cos(ang) * 30, np.sin(ang) * 30, np.zeros(m)], axis=1)
    w = np.zeros((m, 3), np.float32)
    w[:, 2] = ang % (2 * np.pi)
    R_gt = lie.so3_exp(torch.from_numpy(w)).numpy()
    R_est, t_est = [R_gt[0]], [t_gt[0].astype(np.float32)]
    for i in range(1, m):
        trel = R_gt[i - 1].T @ (t_gt[i] - t_gt[i - 1]) + rng.normal(0, 0.01, 3)
        R_est.append((R_est[-1] @ (R_gt[i - 1].T @ R_gt[i])).astype(np.float32))
        t_est.append((t_est[-1] + R_est[-1] @ trel).astype(np.float32))
    R_est, t_est = np.stack(R_est), np.stack(t_est).astype(np.float32)
    li = rng.integers(0, m - 600, PGO_LOOPS).astype(np.int32)
    lj = li + 512
    loops = pg.Se3Edges(
        i=li, j=lj, R=np.einsum("eab,eac->ebc", R_gt[li], R_gt[lj]).astype(np.float32),
        t=np.einsum("eab,ea->eb", R_gt[li], t_gt[lj] - t_gt[li]).astype(np.float32),
        info=np.tile(np.eye(6, dtype=np.float32) * 1e4, (PGO_LOOPS, 1, 1)),
        is_loop=np.ones(PGO_LOOPS, bool), valid=np.ones(PGO_LOOPS, bool))
    edges = pg.edges_to(pg.concat_edges_np(pg.odometry_edges_np(R_est, t_est), loops), device)
    return (torch.from_numpy(R_est).to(device), torch.from_numpy(t_est).to(device), edges)


def phase_pgo_full_width(device, card):
    """10c: optimize() with PCG on the 4,096-node, 512-loop graph (3 GN
    iterations of at most 100 CG iterations, test_graph.py:171's options):
    chi2 must fall below 5% of its start; the two runs give the same bits.
    Returns (the graph, the options) for the profile."""
    import dataclasses

    from loc_lib_tpu_torch.graph import pose_graph as pg

    R, t, edges = pgo_graph(device)
    opts = dataclasses.replace(pg.PgoOptions(), max_iterations=3, max_cg_iterations=100)
    before = float(pg.edge_chi2(R, t, edges).sum())
    ms, results = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(pg.optimize(R, t, edges, opts))
        after = float(results[-1].chi2.sum())
        ms.append((time.perf_counter() - t0) * 1e3)
    if not (np.isfinite(after) and after < 0.05 * before):
        raise AssertionError(f"10c: chi2 {before:.1f} -> {after:.1f}, not below 5%")
    if not all(torch.equal(a, b) for a, b in zip(*results)):
        raise AssertionError("10c: two optimize() calls on one graph differ")
    syncs, _ = _count_syncs(lambda: float(pg.optimize(R, t, edges, opts).chi2.sum()))
    print(f"phase 10c pose graph at full width ({PGO_NODES} nodes, {PGO_LOOPS} loop edges, "
          f"{edges.i.shape[0]} edges, PCG) [{card}]: chi2 {before:.1f} -> {after:.3f} "
          f"({100 * after / before:.4f}%), {int(results[0].cg_iterations)} CG iterations in 3 GN "
          f"iterations; optimize() {ms[0]:.1f} ms first, {ms[1]:.1f} ms second (host clock, "
          f"same bits), {syncs} host syncs", flush=True)
    return (R, t, edges), opts


def _device_launches(fn):
    """Kernel launches and summed device ms of one fn() call, under a
    profiler that records device activity only (tens of thousands of torch
    ops would make a CPU trace take longer to read back than the call);
    repeated up to 3 times if a session hands back no device event, then
    (0, 0.0): "not recorded"."""
    from torch.profiler import ProfilerActivity, profile

    for _session in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        dev = [e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if dev:
            break
    return len(dev), sum(dev) / 1e3


def phase_slam3d_profile(card, eng, graph, opts):
    """Launches and device time of one Slam3d.optimize() (the slam3d_loop
    graph) and one optimize() of the full-width graph, with the host time
    of the same call taken before, profiler off."""
    from loc_lib_tpu_torch.graph import pose_graph as pg

    for label, fn in (("Slam3d.optimize() of the slam3d_loop graph", eng.optimize),
                      (f"pose_graph.optimize() at {PGO_NODES} nodes",
                       lambda: pg.optimize(*graph, opts).chi2.sum().item())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        n, dev_ms = _device_launches(fn)
        busy = "not measured" if n == 0 else f"{100 * dev_ms / host_ms:.1f}%"
        print(f"phase 10 profile {label}: {n} device launches, device {dev_ms:.3f} ms vs host "
              f"{host_ms:.3f} ms (profiler off), device busy {busy} [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 11: the 2D stack
# ---------------------------------------------------------------------------

def mapping2d_scans(frames):
    """bench_suite.py:593-604's workload: a circle of radius 4 m in
    make_world_2d(extent=10.0, seed=2), frame k at angle 2 pi k / frames,
    render_scan_2d(..., seed=k), 720 beams. Returns [(xy, valid, yaw, t)]."""
    from loc_lib_tpu_torch.io import synthetic

    world = synthetic.make_world_2d(extent=10.0, seed=2)
    out = []
    for k in range(frames):
        a = 2.0 * np.pi * k / frames
        t = np.array([4 * np.cos(a) - 4, 4 * np.sin(a)], np.float32)
        out.append(synthetic.render_scan_2d(world, a, t, seed=k) + (a, t))
    return out


def mapping2d_options(**kw):
    """bench_suite.py:606's Mapping2dOptions(max_keyframes_in_submap=16) at
    the default Grid2dOptions (1000 x 1000 cells at 40 px/m, 41 x 41 field
    template, 720 polar bins)."""
    from loc_lib_tpu_torch.pipeline import mapping2d

    return mapping2d.Mapping2dOptions(max_keyframes_in_submap=16, **kw)


def _keyframes(eng) -> int:
    return sum(len(s.frame_ids) for s in eng.submaps)


def drive_mapping2d(eng, scans):
    """process_scan over the scans (then flush when pipelined), each call
    timed on the host clock between two synchronizes. Returns a dict: the
    engine, poses (N, 3) [yaw, x, y], ms per call, keyframe flags (sequential
    runs), trans / yaw RMSE against the ground truth, valid loops."""
    times, kf = [], []
    for xy, valid, _, _ in scans:
        n_kf = _keyframes(eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.process_scan(xy, valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        kf.append(_keyframes(eng) > n_kf)
    if getattr(eng, "pipelined", False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.flush()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    poses = np.stack([np.r_[th, t] for th, t in eng.frame_poses]).astype(np.float64)
    yaw = np.array([a for *_, a, _ in scans])
    gt = np.stack([t for *_, t in scans])
    dyaw = (poses[:, 0] - yaw + np.pi) % (2 * np.pi) - np.pi
    return {"engine": eng, "poses": poses, "times": np.asarray(times), "kf": np.asarray(kf),
            "rmse": float(np.sqrt(np.mean(np.sum((poses[:, 1:] - gt) ** 2, axis=1)))),
            "yaw_rmse": float(np.sqrt(np.mean(dyaw ** 2))),
            "loops": sum(1 for l in eng.loops if l.valid)}


class _MultiresSpy:
    """Wraps mapping2d._match_multires while a 2D run is driven: every
    field the loop registration aligns against must be a tensor on the
    engine's device (a spilled archive goes back to the card first).
    Counts the calls, and those against a spilled archive."""

    def __init__(self, device):
        from loc_lib_tpu_torch.pipeline import mapping2d

        self.m2d, self.device = mapping2d, device
        self.match, self.submap_match = mapping2d._match_multires, mapping2d.Submap.match_multires
        self.calls = self.spilled = 0

    def __enter__(self):
        spy = self

        def match(field, *args):
            if not (isinstance(field, torch.Tensor) and field.device == spy.device):
                raise AssertionError(f"multires match on {type(field)} "
                                     f"{getattr(field, 'device', None)}, not on {spy.device}")
            spy.calls += 1
            return spy.match(field, *args)

        def submap_match(sm, *args):
            spy.spilled += isinstance(sm.field, np.ndarray)
            return spy.submap_match(sm, *args)

        self.m2d._match_multires, self.m2d.Submap.match_multires = match, submap_match
        return self

    def __exit__(self, *exc):
        self.m2d._match_multires, self.m2d.Submap.match_multires = self.match, self.submap_match


def _scans_line(label, run, frames):
    t, kf = run["times"][:frames], run["kf"]

    def p50_p95(x):
        if not len(x):
            return "none"
        return f"{np.percentile(x, 50):.2f} / {np.percentile(x, 95):.2f} ms"
    return (f"{label}: {frames / (t.sum() / 1e3):.2f} scans/s; keyframe scans p50 / p95 "
            f"{p50_p95(t[kf])} ({int(kf.sum())}), other scans {p50_p95(t[~kf])} "
            f"({int((~kf).sum())})")


def phase_mapping2d(device, card):
    """11a-11e on bench_suite.py's mapping2d workload at the default grid:
    11a Mapping2DDevice sequential, 80 frames (>= 2 submaps, >= 1 valid
    loop, trans RMSE within JAX on the CPU + 0.04 m and under 0.08 m); 11e a
    second 11a run (same poses bit for bit; host syncs counted); 11b
    pipelined + flush (11a's poses bit for bit, >= 2 replays); 11c the
    host-driven Mapping2D against Mapping2DDevice, 48 frames (within 0.02
    m, the same submaps, valid loops within 1); 11d archived_device_submaps
    = 1, 64 frames (>= 2 archives spilled, a valid loop, every multires
    match on the card, one against a spilled archive, RMSE under 0.1 m).
    Returns the 11a engine."""
    from loc_lib_tpu_torch.pipeline import mapping2d, mapping2d_device as m2dd

    scans = mapping2d_scans(MAP2D_FRAMES)
    opts = mapping2d_options()
    with _MultiresSpy(device) as spy:
        run = drive_mapping2d(m2dd.Mapping2DDevice(opts, device=device), scans)
    eng = run["engine"]
    if not (len(eng.submaps) >= 2 and run["loops"] >= 1):
        raise AssertionError(f"11a: {len(eng.submaps)} submaps, {run['loops']} valid loops")
    if not run["rmse"] <= RMSE_LIMIT_2D_M:
        raise AssertionError(f"11a: trans RMSE {run['rmse']:.4f} m over {RMSE_LIMIT_2D_M:.4f}")
    print(f"phase 11a mapping2d, Mapping2DDevice, {MAP2D_FRAMES} frames, 1000 x 1000 grid "
          f"[{card}]: {len(eng.submaps)} submaps, {run['loops']} valid loops of {len(eng.loops)}, "
          f"{spy.calls} multires matches (all on the card); trans RMSE {run['rmse']:.4f} m "
          f"(bound {RMSE_LIMIT_2D_M:.4f}), yaw RMSE {run['yaw_rmse']:.4f} rad; "
          + _scans_line("host clock", run, MAP2D_FRAMES), flush=True)

    syncs, again = _count_syncs(lambda: drive_mapping2d(m2dd.Mapping2DDevice(opts, device=device),
                                                        scans))
    if not np.array_equal(again["poses"], run["poses"]):
        gap = np.abs(again["poses"] - run["poses"]).max()
        raise AssertionError(f"11e: two sequential runs differ by {gap:.3g}")
    print(f"phase 11e mapping2d run-to-run [{card}]: a second {MAP2D_FRAMES}-frame run gives the "
          f"same poses bit for bit (the dense SE(2) solves included: {len(eng.loops)} loops); "
          f"{syncs / MAP2D_FRAMES:.1f} host syncs per scan ({syncs} over the run, "
          "torch.cuda.set_sync_debug_mode)", flush=True)

    pip = drive_mapping2d(m2dd.Mapping2DDevice(opts, device=device, pipelined=True), scans)
    if not (np.array_equal(pip["poses"], run["poses"]) and pip["engine"].replays >= 2):
        raise AssertionError(f"11b: pipelined poses differ from sequential or "
                             f"{pip['engine'].replays} replays")
    print(f"phase 11b mapping2d pipelined + flush [{card}]: poses equal 11a's bit for bit, "
          f"{pip['engine'].replays} replays; {MAP2D_FRAMES / (pip['times'].sum() / 1e3):.2f} "
          f"scans/s (11a {MAP2D_FRAMES / (run['times'].sum() / 1e3):.2f}, host clock)", flush=True)

    scans_c = mapping2d_scans(MAP2D_PARITY_FRAMES)
    host = drive_mapping2d(mapping2d.Mapping2D(opts, device=device), scans_c)
    dev = drive_mapping2d(m2dd.Mapping2DDevice(opts, device=device), scans_c)
    gap = np.linalg.norm(host["poses"][:, 1:] - dev["poses"][:, 1:], axis=1).max()
    n_sub = (len(host["engine"].submaps), len(dev["engine"].submaps))
    if not (gap < 0.02 and n_sub[0] == n_sub[1] and abs(host["loops"] - dev["loops"]) <= 1):
        raise AssertionError(f"11c: host vs device {gap:.4f} m, submaps {n_sub}, valid loops "
                             f"{host['loops']} / {dev['loops']}")
    print(f"phase 11c mapping2d host-driven Mapping2D vs Mapping2DDevice, "
          f"{MAP2D_PARITY_FRAMES} frames [{card}]: largest pose gap {gap:.5f} m (bound 0.02), "
          f"{n_sub[0]} submaps each, valid loops {host['loops']} / {dev['loops']}; trans RMSE "
          f"{host['rmse']:.4f} / {dev['rmse']:.4f} m; host-driven "
          f"{MAP2D_PARITY_FRAMES / (host['times'].sum() / 1e3):.2f} scans/s", flush=True)

    scans_d = mapping2d_scans(MAP2D_SPILL_FRAMES)
    with _MultiresSpy(device) as spy:
        sp = drive_mapping2d(m2dd.Mapping2DDevice(mapping2d_options(archived_device_submaps=1),
                                                  device=device), scans_d)
    spilled = [s.index for s in sp["engine"].submaps[:-1] if isinstance(s.field, np.ndarray)]
    if not (len(spilled) >= 2 and sp["loops"] >= 1 and spy.spilled >= 1
            and sp["rmse"] < 0.1):
        raise AssertionError(f"11d: spilled {spilled}, {sp['loops']} valid loops, "
                             f"{spy.spilled} matches against spilled archives, RMSE "
                             f"{sp['rmse']:.4f} m")
    print(f"phase 11d mapping2d archived_device_submaps=1, {MAP2D_SPILL_FRAMES} frames "
          f"[{card}]: archives {spilled} spilled to host memory, {spy.calls} multires matches "
          f"all on the card ({spy.spilled} against a spilled archive), {sp['loops']} valid "
          f"loops, trans RMSE {sp['rmse']:.4f} m (bound 0.1)", flush=True)
    return eng


def _profiled_call(fn):
    """Device launches, summed device ms and host ms (profiler on, device
    activity only) of one fn() call: _device_launches with the host clock."""
    out = {}

    def timed():
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out["host_ms"] = (time.perf_counter() - t0) * 1e3
    n, dev_ms = _device_launches(timed)
    return n, dev_ms, out["host_ms"]


def phase_mapping2d_profile(device, card, eng):
    """After every host-clock timing: device time of one field regeneration
    and one polar carve at 1000 x 1000; launches, device ms, host ms and
    device busy of keyframe scans and of scans without a keyframe (frames
    60-69 of a fresh 11a run); one optimize() of the 11a engine."""
    from loc_lib_tpu_torch.models import grid2d
    from loc_lib_tpu_torch.pipeline import mapping2d_device as m2dd

    gopts = eng.opts.grid
    st = eng.dstate
    grid = grid2d.OccupancyGrid(counts=st.counts, touched=st.touched)
    pts = torch.from_numpy(mapping2d_scans(MAP2D_FRAMES)[5][0]).to(device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    origin = torch.zeros(2, device=device)
    parts = {}
    for label, fn in (("field", lambda: grid2d.likelihood_field(grid, gopts)),
                      ("carve", lambda: grid2d.add_scan(grid, gopts, pts, valid, origin))):
        fn()
        n, ms, host = _profiled_call(fn)
        parts[label] = (n, ms, host)
    print(f"phase 11 profile at 1000 x 1000 [{card}]: likelihood_field {parts['field'][1]:.4f} "
          f"ms of device time in {parts['field'][0]} launches (host {parts['field'][2]:.3f} ms), "
          f"add_scan (polar carve) {parts['carve'][1]:.4f} ms in {parts['carve'][0]} launches "
          f"(host {parts['carve'][2]:.3f} ms)", flush=True)

    scans = mapping2d_scans(MAP2D_FRAMES)
    fresh = m2dd.Mapping2DDevice(eng.opts, device=device)
    for xy, valid_k, _, _ in scans[:60]:
        fresh.process_scan(xy, valid_k)
    rows = {True: [], False: []}
    # each of frames 60-69, then the same scan again (the robot standing
    # still: no keyframe); scans that closed a loop are left out
    for xy, valid_k, _, _ in scans[60:70]:
        for _ in range(2):
            n_kf, n_loops = _keyframes(fresh), len(fresh.loops)
            n, ms, host = _profiled_call(lambda: fresh.process_scan(xy, valid_k))
            if n and len(fresh.loops) == n_loops:
                rows[_keyframes(fresh) > n_kf].append((n, ms, host))
    for kf, label in ((True, "keyframe scan"), (False, "scan without keyframe")):
        r = np.asarray(rows[kf])
        if not len(r):
            print(f"phase 11 profile {label}: not measured (no such scan without a new loop, "
                  "or no device event recorded)", flush=True)
            continue
        print(f"phase 11 profile {label} (frames 60-69, {len(r)} scans, medians) [{card}]: "
              f"{np.median(r[:, 0]):.0f} device launches, device {np.median(r[:, 1]):.3f} ms vs "
              f"host {np.median(r[:, 2]):.3f} ms (profiler on), device busy "
              f"{100 * np.sum(r[:, 1]) / np.sum(r[:, 2]):.1f}%", flush=True)
    n, ms, host = _profiled_call(eng.optimize)
    busy = "not measured" if n == 0 else f"{100 * ms / host:.1f}%"
    print(f"phase 11 profile Mapping2DDevice.optimize() ({len(eng.submaps)} submaps, "
          f"{len(eng.loops)} loops, dense SE(2) solve) [{card}]: {n} device launches, device "
          f"{ms:.3f} ms vs host {host:.3f} ms, device busy {busy}", flush=True)


# ---------------------------------------------------------------------------
# Phase 6: where the time goes
# ---------------------------------------------------------------------------

def phase_profile(device, card, workload, target, out_dir):
    """Per-layer breakdown of the headline match, set_target and one LIO
    step of the icp, ndt_inc and ndt paths. Writes torch.profiler tables to
    out_dir and prints one line per path."""
    from loc_lib_tpu_torch.models import icp

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

    for matcher in ("icp", "ndt_inc", "ndt"):
        _profile_lio(device, card, out_dir, matcher)
    _profile_loam_loc(device, card, out_dir)


def _profile_loam_loc(device, card, out_dir):
    """One LOAM step and one Loc step of each method under the profiler,
    after 9 frames of warm-up: device launches, summed device time against
    host time."""
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import icp, loam
    from loc_lib_tpu_torch.pipeline import loc

    log = demo_log(10)
    mgs = list(log.measures(imu_capacity=64))
    opts = loam_options()

    def feats(k):
        f = loam.extract_features(synthetic.annotate_rings(log.frame(k, device), 16,
                                                           device=device), opts.loam.feature)
        return f.surf, f.edge

    def report(label, name, fn):
        out = []
        n, dev_ms, host_ms, prof = _profiled(lambda: out.append(fn()), 1)
        (out_dir / name).write_text(prof.key_averages().table(sort_by="cpu_time_total",
                                                              row_limit=40))
        it = getattr(out[0], "iterations", None)
        print(f"phase 6 profile {label} (frame {mgs[-1].scan_index}"
              + ("" if it is None else f", {it} GN iterations")
              + f"): {n:.0f} device launches, device {dev_ms:.3f} ms vs host {host_ms:.3f} ms, "
              f"device busy {100 * dev_ms / host_ms:.1f}% (profiler on) [{card}]", flush=True)

    eng = drive_lio(device, opts, log, frames=len(mgs) - 1, features=feats)[0]
    mg = mgs[-1]
    surf, edge = feats(mg.scan_index)
    report("LOAM step", "profile_loam_step.txt", lambda: eng.add_measure(
        surf, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid, edge_scan=edge))
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    for method in ("p2plane_vox", "p2plane_vox_oct"):
        e = loc.Loc(world, loc.LocOptions(icp=icp.IcpOptions(method=method)), device=device)
        e.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
        for g in mgs:
            args = (log.frame(g.scan_index, device), g.imu_gyro, g.imu_acce, g.imu_stamp,
                    g.imu_valid)
            if g is mg:
                report(f"Loc {method} step", f"profile_loc_{method}_step.txt",
                       lambda: e.update_measure(*args))
            else:
                e.update_measure(*args)


def _profile_lio(device, card, out_dir, matcher):
    """LIO: 8 frames of warm-up, then a host-clock breakdown of frames 8-12
    by stage, the keyframe update alone, and one step under the profiler."""
    from loc_lib_tpu_torch.io import logdir
    from loc_lib_tpu_torch.models import eskf
    from loc_lib_tpu_torch.pipeline import lio

    frames = 14
    log = logdir.make_demo_log(num_frames=frames, capacity=8192, yaw_rate=0.0, speed=2.0)
    lo = lio_options(matcher)
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
        clock("scan_match", lambda: lio._align(lo, st, scan, R0, t0))
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
    name = "profile_lio_step.txt" if matcher == "icp" else f"profile_lio_{matcher}_step.txt"
    (out_dir / name).write_text(
        prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    ranges = "; ".join(f"{k} {min(v):.2f}-{max(v):.2f} ms" for k, v in stage.items() if v)
    print(f"phase 6 profile LIO {matcher} frames 8-{frames - 2} (host clock): {ranges}; "
          "_push_keyframe "
          f"{np.median(kf_ms):.2f} ms; one step under the profiler: {n:.0f} device "
          f"launches, device {dev_ms:.3f} ms vs host {host_ms:.3f} ms [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 12: the distributed layer (parallel/, pipeline/*_sharded.py)
# ---------------------------------------------------------------------------

SHARDED_GAP_M = 0.02          # tests/test_map_shard.py:294: sharded vs single-device engine
SHARDED_MATCH_GAP = 2e-3      # tests/test_map_shard.py:65
SHARDED_PGO_GAP = 3e-3        # tests/test_parallel.py:120-121
SLAM_SHARDED_FRAMES = 64      # bench_suite.py:257-338's slam3d_sharded run
# the JAX package's Slam3dSharded on that run, one run on the CPU at a (1, 1)
# mesh: 32 keyframes, 68 loops, keyframe ATE 0.051965 -> 0.022767 m; plus
# 0.04 m, PERF.md section 2's rule
ATE_LIMIT_SLAM_SHARDED_M = 0.022767 + 0.04
# LioSharded at (1, 4): per-shard tables of 8,192 voxels, below the live map
# (16,182 voxels over the 40 frames, 2,916-5,040 a shard, in one CPU run)
LIO_SHARD_MAP_CAPACITY = 8192
MESHES_12B = ((2, 2), (1, 4))


class _Spy:
    """Wraps `module.name` while a path runs and records each call's
    result (or what `keep` makes of it)."""

    def __init__(self, module, name, keep=lambda r: r):
        self.module, self.name, self.keep = module, name, keep
        self.orig = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        res = self.orig(*args, **kw)
        self.calls.append(self.keep(res))
        return res

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _NcclWorld:
    """12a's world: one rank, NCCL, joined through a file store in a
    temporary directory; left (destroyed) on exit."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        import tempfile

        import torch.distributed as dist
        from loc_lib_tpu_torch.parallel import multihost

        self.tmp = tempfile.TemporaryDirectory()
        multihost.init(f"file://{self.tmp.name}/store", 1, 0, self.device)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"a one-rank world on the card must use NCCL, got "
                                 f"{dist.get_backend()}")
        return multihost.global_mesh(dp=1, mp=1)

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()
        self.tmp.cleanup()


def phase_lio_sharded(device, card, mesh, single_poses):
    """12a lio_sharded_mapping (bench_suite.py:196-254): LioSharded over
    phase 5b's log and options (ndt_inc, 1 m voxels, ESKF, 150 IMU-init
    samples, 40 frames) at a (1, 1) mesh. Fails unless ATE <= 0.10 m, never
    LOST, and the largest pose gap to phase 5b's single-device run is under
    SHARDED_GAP_M. Returns (the summed GN iterations, the poses)."""
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.pipeline import lio_sharded

    log = demo_log()
    eng = lio_sharded.LioSharded(mesh, lio_options("ndt_inc"), device=device)
    for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
        eng.init_imu(g, a, t)
    iters, times, idxs = 0, [], []
    for mg in log.measures(imu_capacity=64):
        scan = log.frame(mg.scan_index, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.add_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        iters += out.iterations
        idxs.append(mg.scan_index)
    poses = np.stack(eng.poses)
    ate = metrics.ate(poses, log.gt_poses[np.asarray(idxs)])
    gap = float(np.linalg.norm(poses[:, :3, 3] - single_poses[:, :3, 3], axis=1).max())
    if not (ate.rmse <= ATE_LIMIT_NDT_INC_M and gap < SHARDED_GAP_M):
        raise AssertionError(f"12a LioSharded: ATE {ate.rmse:.4f} m, gap to 5b {gap:.3g} m")
    if eng.health.status == eng.health.LOST:
        raise AssertionError("12a LioSharded: tracking health LOST")
    steady = np.asarray(times[LIO_WARMUP:])
    print(f"phase 12a lio_sharded_mapping (mesh (1, 1), NCCL; {LIO_FRAMES} frames, ndt_inc + "
          f"ESKF, capacity 8192): ATE RMSE {ate.rmse:.4f} m (bound {ATE_LIMIT_NDT_INC_M}), "
          f"{len(eng.kf_poses)} keyframes, live voxels {eng.live_voxels_per_shard().tolist()}, "
          f"health {eng.health.status}; largest pose gap to phase 5b's single-device ndt_inc "
          f"{gap:.3g} m (bound {SHARDED_GAP_M}), same bits: "
          f"{np.array_equal(poses, single_poses)}; p50 {np.percentile(steady, 50):.2f} ms/scan "
          f"(host clock) [{card}]", flush=True)
    return iters, poses


def slam3d_sharded_options():
    """bench_suite.py:257-338's configuration: LIO ndt_inc (1 m voxels) +
    ESKF, 0.4 m keyframe gate, ScanContext with an 8-keyframe exclusion and
    a 0.25 gate, loops gated at 60 effective points and 0.1 m^2, sc_topk 3,
    p2plane_vox loop registration (20 iterations, 0.5 m gate, 2 m leaves),
    the pose graph once at the end."""
    from loc_lib_tpu_torch.graph import scan_context as sc
    from loc_lib_tpu_torch.models import icp, ndt
    from loc_lib_tpu_torch.pipeline import lio, slam3d

    return slam3d.Slam3dOptions(
        lio=lio.LioOptions(matcher="ndt_inc", ndt=ndt.NdtOptions(method="incremental",
                                                                 voxel_size=1.0),
                           scan_capacity=SLAM_CAPACITY, with_eskf=True, kf_distance=0.4),
        sc=sc.ScanContextOptions(exclude_recent=8, dist_threshold=0.25),
        loop=slam3d.LoopOptions(min_keyframe_gap=8, max_candidate_dist=10.0,
                                min_effective_pts=60, max_chi2_per_pt=0.1, optimize_every=100,
                                sc_topk=3),
        loop_icp=icp.IcpOptions(method="p2plane_vox", max_iteration=20, max_plane_distance=0.5,
                                grid_leaf=2.0, plane_min_pts=4))


def phase_slam3d_sharded(device, card, mesh):
    """12a slam3d_sharded: Slam3dSharded over 64 frames of the 3D SLAM log
    at a (1, 1) mesh, then optimize(). Fails unless a loop was accepted, the
    keyframe ATE after the pose graph is below the ATE before it and within
    ATE_LIMIT_SLAM_SHARDED_M, the correction was written through the
    sharded map, and health was never LOST."""
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.parallel import map_shard
    from loc_lib_tpu_torch.pipeline.slam3d_sharded import Slam3dSharded

    log = slam3d_log(SLAM_SHARDED_FRAMES)
    eng = Slam3dSharded(mesh, slam3d_sharded_options(), device=device)
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
        if eng.lio.health.status == eng.lio.health.LOST:
            raise AssertionError(f"12a slam3d_sharded: LOST at frame {mg.scan_index}")
    kf_gt = log.gt_poses[np.asarray(eng.kf_frame)]
    before = metrics.ate(eng.keyframe_poses(), kf_gt).rmse
    with _Spy(map_shard, "apply_correction_sharded") as writes:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran = eng.optimize()
        torch.cuda.synchronize()
        opt_ms = (time.perf_counter() - t0) * 1e3
    after = metrics.ate(eng.keyframe_poses(), kf_gt).rmse
    if not (ran and eng.loops and after < before and after <= ATE_LIMIT_SLAM_SHARDED_M
            and writes.calls):
        raise AssertionError(f"12a slam3d_sharded: optimize ran {ran}, {len(eng.loops)} loops, "
                             f"ATE {before:.4f} -> {after:.4f} m, {len(writes.calls)} "
                             "write-throughs")
    print(f"phase 12a slam3d_sharded (mesh (1, 1), NCCL; {SLAM_SHARDED_FRAMES} frames, capacity "
          f"{SLAM_CAPACITY}, ndt_inc front end, sc_topk 3, p2plane_vox loop registration): "
          f"{len(eng.kf_R)} keyframes, {len(eng.loops)} loops accepted, "
          f"{int(eng.loop_inliers.sum())} inliers; keyframe ATE {before:.4f} -> {after:.4f} m "
          f"after the pose graph (bound {ATE_LIMIT_SLAM_SHARDED_M:.4f}); the correction "
          f"written through the sharded map ({len(writes.calls)} call); optimize() "
          f"{opt_ms:.1f} ms; live voxels {eng.live_voxels_per_shard().tolist()}; p50 "
          f"{np.percentile(times[LIO_WARMUP:], 50):.2f} ms/scan (host clock) [{card}]",
          flush=True)


def phase_loc_sharded(device, card, mesh, single_poses):
    """12a LocSharded: phase 7's loc_matching run (prior map make_world(
    120000, extent 80, seed 0), box 150 m, margin 50 m, 131,072-row crop,
    p2plane_vox, ESKF; 40 frames) at a (1, 1) mesh. Fails unless ATE <=
    ATE_LIMIT_LOC_M, no shard dropped a point, and health was never LOST.
    Returns the summed GN iterations."""
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.io import synthetic
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.parallel import map_shard
    from loc_lib_tpu_torch.pipeline import loc, loc_sharded

    log = demo_log()
    world = synthetic.make_world(num_points=120000, extent=80.0, seed=0)
    eng = loc_sharded.LocSharded(mesh, world, loc.LocOptions(icp=icp.IcpOptions(
        method="p2plane_vox")), device=device)
    eng.set_init_pose(log.gt_poses[0][:3, :3], log.gt_poses[0][:3, 3])
    times = []
    with _Spy(map_shard, "icp_scan_match_sharded", lambda r: r.iterations) as matches:
        for mg in log.measures(imu_capacity=64):
            scan = log.frame(mg.scan_index, device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.update_measure(scan, mg.imu_gyro, mg.imu_acce, mg.imu_stamp, mg.imu_valid)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    poses = np.stack(eng.poses)
    ate = metrics.ate(poses, log.gt_poses[:len(poses)])
    overflow = eng.shard_overflow()
    if not (ate.rmse <= ATE_LIMIT_LOC_M and not overflow.any()):
        raise AssertionError(f"12a LocSharded: ATE {ate.rmse:.4f} m, overflow {overflow}")
    if eng.health.status == eng.health.LOST:
        raise AssertionError("12a LocSharded: tracking health LOST")
    gap = float(np.linalg.norm(poses[:, :3, 3] - single_poses[:, :3, 3], axis=1).max())
    print(f"phase 12a LocSharded (mesh (1, 1), NCCL; loc_matching, {len(poses)} frames, "
          f"p2plane_vox + ESKF, box 150 m, crop 131,072 rows, shard capacity "
          f"{eng.shard_capacity}): ATE RMSE {ate.rmse:.4f} m (bound {ATE_LIMIT_LOC_M:.4f}), "
          f"shard overflow {overflow.tolist()}, {eng.num_recrops} re-crops, health "
          f"{eng.health.status}; largest pose gap to phase 7's Loc {gap:.3g} m, same bits: "
          f"{np.array_equal(poses, single_poses)} (the election outside the kernel, then K1 "
          f"plane given, on the shard's own key window); "
          f"p50 {np.percentile(times[4:], 50):.2f} ms/scan (host clock) [{card}]", flush=True)
    return int(sum(matches.calls))


def _tree_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, tuple):
        return sum(_tree_bytes(x) for x in tree)
    return 0


def _map_mb(target, m) -> dict:
    """MB held by an ICP target and an NDT map, and by their voxel rows
    alone (without the fixed dense_dims window of the dense index)."""
    icp_rows = _tree_bytes(target) - _tree_bytes(target.dense)
    ndt_rows = _tree_bytes(m) - _tree_bytes((m.dense_table, m.dense_lo))
    return {k: v / 2 ** 20 for k, v in (("icp", _tree_bytes(target)), ("ndt", _tree_bytes(m)),
                                         ("icp_rows", icp_rows), ("ndt_rows", ndt_rows))}


def rank_12b(case: dict) -> dict:
    """One rank of 12b (several ranks on the one card, gloo): the headline
    target sharded over "mp" and its source over "dp", the sharded ICP and
    direct-NDT matches; LioSharded (at (1, 4)); the edge-sharded two-phase
    pose graph (at (2, 2)). Launch counters are set to 0 before the paths
    and read after them; then K1 (plane given, after the election) and K3
    (from this shard's map) are held against their plain versions on this
    rank's own shard. Returns numpy results."""
    import dataclasses

    import torch.distributed as dist
    from loc_lib_tpu_torch.eval import metrics
    from loc_lib_tpu_torch.graph import pose_graph as pg
    from loc_lib_tpu_torch.models import icp, ndt
    from loc_lib_tpu_torch.ops import kernels, voxel
    from loc_lib_tpu_torch.parallel import graph as pgraph, map_shard, match, mesh as mesh_mod
    from loc_lib_tpu_torch.pipeline import lio_sharded

    device = (torch.device("cuda", torch.cuda.current_device()) if case["device"] == "cuda"
              else torch.device(case["device"]))
    dp, mp = case["mesh"]
    mesh = mesh_mod.make_mesh_2d(dp, mp)
    if dist.get_backend() != case["backend"]:
        raise AssertionError(f"the ranks use {dist.get_backend()}, not {case['backend']}")
    me = mesh_mod.axis_index(mesh, "mp")
    tgt, src, _, _, R_init, t_init = headline_workload(device)
    cap = N_TARGET * 3 // (2 * mp)
    iopts = icp.IcpOptions(method="p2plane_vox")
    nopts = ndt.NdtOptions(method="direct", voxel_size=1.0)
    out = {"rank": dist.get_rank(), "mp_index": me, "seconds": {}}
    reduces = [0]
    all_reduce = dist.all_reduce

    def counting_all_reduce(*a, **kw):
        reduces[0] += 1
        return all_reduce(*a, **kw)

    dist.all_reduce = counting_all_reduce      # this rank process's own module
    # one 44-float all-reduce of a CUDA tensor, as a GN iteration makes it,
    # after the first collective of every group the paths use (NCCL sets a
    # group's communicator up at its first collective)
    buf = torch.zeros(44, device=device)
    for axes in ("dp", "mp", ("dp", "mp")):
        mesh_mod.psum(buf, mesh, axes)
        mesh_mod.pmin(buf, mesh, axes)
    for _ in range(5):
        mesh_mod.psum(buf, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        mesh_mod.psum(buf, mesh)
    torch.cuda.synchronize()
    out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3 / 50
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    st = map_shard.set_target_sharded(mesh, tgt, iopts, cap)
    torch.cuda.synchronize()
    t1, n0 = time.perf_counter(), reduces[0]
    res = map_shard.icp_scan_match_sharded(mesh, st, iopts, src, R_init, t_init)
    torch.cuda.synchronize()
    t2, n1 = time.perf_counter(), reduces[0]
    # the same match again: the first one pays this process's first calls
    # into the CUDA libraries (the 6x6 solve's handles, kernel modules)
    again = map_shard.icp_scan_match_sharded(mesh, st, iopts, src, R_init, t_init)
    torch.cuda.synchronize()
    t2b = time.perf_counter()
    if not (torch.equal(again.R, res.R) and torch.equal(again.t, res.t)):
        raise AssertionError("two sharded ICP matches on one input differ")
    sm = map_shard.build_direct_sharded(mesh, tgt, nopts, cap)
    torch.cuda.synchronize()
    t3, n2 = time.perf_counter(), reduces[0]
    nres = map_shard.ndt_scan_match_sharded(mesh, sm, nopts, src, R_init, t_init)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    out["seconds"]["matches"] = t4 - t0
    out["match_ms"] = {"icp first": (t2 - t1) * 1e3, "icp": (t2b - t2) * 1e3,
                       "ndt": (t4 - t3) * 1e3}
    out["reduces"] = {"icp": n1 - n0, "ndt": reduces[0] - n2}
    if res.t.device != device or nres.t.device != device:
        raise AssertionError("a sharded match left the rank's device")
    out["icp"] = {"R": res.R.cpu().numpy(), "t": res.t.cpu().numpy(),
                  "iterations": res.iterations, "num_effective": int(res.num_effective)}
    out["ndt"] = {"R": nres.R.cpu().numpy(), "t": nres.t.cpu().numpy(),
                  "iterations": nres.iterations, "num_effective": int(nres.num_effective)}
    keys = st.target.grid.voxel_keys
    c = voxel.key_to_coords(keys)[st.target.plane_valid & (keys != voxel.INVALID_KEY)]
    out["owned"] = torch.stack([c[:, 0] + st.kx[me], c[:, 1], c[:, 2]], 1).cpu().numpy()
    out["overflow"] = np.concatenate([st.overflow.cpu().numpy(), sm.overflow.cpu().numpy()])
    out["shard_mb"] = _map_mb(st.target, sm.map)
    if case.get("lio"):
        log = demo_log()
        opts = lio_options("ndt_inc")
        opts = dataclasses.replace(opts, ndt=dataclasses.replace(
            opts.ndt, map_capacity=LIO_SHARD_MAP_CAPACITY))
        eng = lio_sharded.LioSharded(mesh, opts, device=device)
        for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
            eng.init_imu(g, a, t)
        idxs = []
        t0 = time.perf_counter()
        for mg in log.measures(imu_capacity=64):
            eng.add_measure(log.frame(mg.scan_index, device), mg.imu_gyro, mg.imu_acce,
                            mg.imu_stamp, mg.imu_valid)
            idxs.append(mg.scan_index)
        torch.cuda.synchronize()
        out["seconds"]["lio"] = time.perf_counter() - t0
        out["lio"] = {"poses": np.stack(eng.poses), "live": eng.live_voxels_per_shard(),
                      "ate": metrics.ate(np.stack(eng.poses),
                                         log.gt_poses[np.asarray(idxs)]).rmse,
                      "health": eng.health.status, "map_capacity": LIO_SHARD_MAP_CAPACITY}
    if case.get("pgo"):
        R, t, edges = pgo_graph(device)
        opts = dataclasses.replace(pg.PgoOptions(), max_iterations=3, max_cg_iterations=100)
        t0 = time.perf_counter()
        Rp, tp, inl = pgraph.optimize_two_phase(mesh, R, t, edges, opts)
        torch.cuda.synchronize()
        out["seconds"]["pgo"] = time.perf_counter() - t0
        out["pgo"] = {"R": Rp.cpu().numpy(), "t": tp.cpu().numpy(), "inlier": inl.cpu().numpy()}
    torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    # the kernels on this rank's own shard, at the final poses
    local = match.local_cloud(src, mesh)
    plane, w = map_shard.elect(mesh, st.target, local, res.R, res.t,
                               icp._index(st.target, iopts, st.target.dense))
    args = (local.xyz, plane, w, res.R, res.t, iopts.max_plane_distance)
    got = kernels.p2plane_fused_terms(*args)
    e1, r1 = _compare(f"rank {out['rank']} K1 plane given", got,
                      kernels.p2plane_fused_terms_plain(*args), kernels.p2plane_rows_plain(*args))
    margs = ndt._from_map_args(sm.map, nopts, local, nres.R, nres.t, False)
    got = kernels.ndt_fused_terms_from_map(*margs)
    e3, r3 = _compare(f"rank {out['rank']} K3 from map", got,
                      kernels.ndt_from_map_terms_plain(*margs),
                      kernels.ndt_from_map_rows_plain(*margs), 3 * margs[8])
    out["checks"] = {"K1": (e1, r1, int(w.sum())), "K3": (e3, r3, int(got[2]))}
    return out


def phase_sharded_ranks(device, card, workload, lio_poses, backend="gloo",
                        rank_device=None):
    """12b: several ranks on the one card (gloo), spawned by this script
    (`multihost.launch`), at meshes (2, 2) and (1, 4); with `--cards`, one
    rank a card (`rank_device` "cuda", NCCL). Fails unless, at
    each mesh, every rank's sharded ICP and NDT poses equal rank 0's bit
    for bit and lie within SHARDED_MATCH_GAP of the single-device
    scan_match, the ICP pose passes the headline's ground-truth gates,
    every voxel answers on one shard only and no shard overflowed; at
    (1, 4) LioSharded keeps ATE <= 0.10 m with a live map larger than one
    shard's table and every shard under its own; at (2, 2) the edge-sharded
    two-phase pose graph lands within SHARDED_PGO_GAP of the single-device
    one with the same loop inliers; and every rank's K1 and K3 agree with
    their plain versions on its own shard. Returns the launches summed over
    the ranks of both launches (their paths alone)."""
    import dataclasses

    from loc_lib_tpu_torch.graph import pose_graph as pg
    from loc_lib_tpu_torch.models import icp, ndt
    from loc_lib_tpu_torch.parallel import multihost

    tgt, src, R_gt, t_gt, R_init, t_init = workload
    iopts = icp.IcpOptions(method="p2plane_vox")
    nopts = ndt.NdtOptions(method="direct", voxel_size=1.0)
    one_target, one_map = icp.set_target(tgt, iopts), ndt.build_direct(tgt, nopts)
    one_mb = _map_mb(one_target, one_map)
    one_icp = icp.scan_match(one_target, iopts, src, R_init, t_init)
    one_ndt = ndt.scan_match(one_map, nopts, src, R_init, t_init)
    R, t, edges = pgo_graph(device)
    popts = dataclasses.replace(pg.PgoOptions(), max_iterations=3, max_cg_iterations=100)
    one_pgo = [x.cpu().numpy() for x in pg.optimize_two_phase(R, t, edges, popts)]
    total = {}
    for shape in MESHES_12B:
        case = {"mesh": shape, "lio": shape == (1, 4), "pgo": shape == (2, 2),
                "device": rank_device or str(device), "backend": backend}
        t0 = time.perf_counter()
        runs = multihost.launch("chip_smoke:rank_12b", shape[0] * shape[1], (case,),
                                device=case["device"], backend=backend, threads=2,
                                timeout=600)
        secs = time.perf_counter() - t0
        r0 = runs[0]
        for r in runs[1:]:
            for key in ("icp", "ndt") + (("lio",) if case["lio"] else ()) + \
                       (("pgo",) if case["pgo"] else ()):
                for f, v in r0[key].items():
                    if not np.array_equal(r[key][f], v):
                        raise AssertionError(f"12b {shape}: rank {r['rank']} {key}.{f} differs "
                                             "from rank 0's")
        gaps = {}
        for key, one in (("icp", one_icp), ("ndt", one_ndt)):
            gaps[key] = max(float(np.abs(r0[key]["t"] - one.t.cpu().numpy()).max()),
                            float(np.abs(r0[key]["R"] - one.R.cpu().numpy()).max()))
            if gaps[key] > SHARDED_MATCH_GAP:
                raise AssertionError(f"12b {shape} {key}: {gaps[key]:.3g} from the single-device "
                                     "match")
        rot = _rot_err(r0["icp"]["R"].astype(np.float64), R_gt)
        tr = float(np.linalg.norm(r0["icp"]["t"] - t_gt))
        if not (rot < PARITY_ROT_RAD and tr < PARITY_TRANS_M):
            raise AssertionError(f"12b {shape}: sharded ICP {np.degrees(rot):.3f} deg / {tr:.4f} m "
                                 "off the ground truth")
        owned = np.concatenate([next(r for r in runs if r["mp_index"] == s)["owned"]
                                for s in range(shape[1])])
        if len(np.unique(owned, axis=0)) != len(owned) or len(owned) < 1000:
            raise AssertionError(f"12b {shape}: a voxel answers on two shards ({len(owned)})")
        if any(r["overflow"].any() for r in runs):
            raise AssertionError(f"12b {shape}: a shard overflowed")
        checks = {k: max(r["checks"][k][1] for r in runs) for k in ("K1", "K3")}
        per_it = {k: r0["reduces"][k] / r0[k]["iterations"] for k in ("icp", "ndt")}
        where = "one card a rank, NCCL" if rank_device else "on one card, gloo"
        line = (f"phase 12b mesh {shape} ({shape[0] * shape[1]} ranks {where}; "
                f"spawned, {secs:.1f} s of command time): headline target sharded over mp, "
                f"shards of <= {N_TARGET * 3 // (2 * shape[1])} points, {len(owned)} answering "
                f"voxels each on one shard, no overflow; the largest rank's shard holds "
                + ", ".join(f"{k} {max(r['shard_mb'][k] for r in runs):.2f}" for k in one_mb)
                + " MB (one device's whole target and map: "
                + ", ".join(f"{k} {v:.2f}" for k, v in one_mb.items())
                + " MB; *_rows: without the fixed dense window); sharded ICP "
                f"{r0['icp']['iterations']} "
                f"GN iterations, {np.degrees(rot):.4f} deg / {100 * tr:.3f} cm off the ground "
                f"truth, {gaps['icp']:.3g} from icp.scan_match; sharded direct NDT "
                f"{gaps['ndt']:.3g} from ndt.scan_match; every rank's poses rank 0's bits; "
                f"all-reduces per GN iteration {per_it['icp']:.2f} (ICP) / {per_it['ndt']:.2f} "
                f"(NDT), a 44-float all-reduce {r0['all_reduce_ms']:.3f} ms (host clock), "
                f"match {r0['match_ms']['icp']:.1f} / {r0['match_ms']['ndt']:.1f} ms on rank 0 "
                f"(the process's first ICP match {r0['match_ms']['icp first']:.1f} ms); "
                f"K1 / K3 vs plain on every rank's shard, largest err/bound {checks['K1']:.3g} "
                f"/ {checks['K3']:.3g}")
        if case["lio"]:
            lo = r0["lio"]
            live, cap = lo["live"], lo["map_capacity"]
            gap = float(np.linalg.norm(lo["poses"][:, :3, 3] - lio_poses[:, :3, 3], axis=1).max())
            if not (lo["ate"] <= ATE_LIMIT_NDT_INC_M and live.sum() > cap and (live < cap).all()
                    and lo["health"] != "LOST"):
                raise AssertionError(f"12b {shape} LioSharded: ATE {lo['ate']:.4f}, live {live}, "
                                     f"capacity {cap}, health {lo['health']}")
            line += (f"; LioSharded {LIO_FRAMES} frames: ATE RMSE {lo['ate']:.4f} m (bound "
                     f"{ATE_LIMIT_NDT_INC_M}), live voxels {live.tolist()} (total {live.sum()} > "
                     f"{cap} a shard), health {lo['health']}, largest gap to 12a {gap:.3g} m")
        if case["pgo"]:
            po = r0["pgo"]
            e = len(one_pgo[2])
            gap = max(float(np.abs(po["t"] - one_pgo[1]).max()),
                      float(np.abs(po["R"] - one_pgo[0]).max()))
            if not (gap < SHARDED_PGO_GAP and np.array_equal(po["inlier"][:e], one_pgo[2])
                    and not po["inlier"][e:].any()):
                raise AssertionError(f"12b {shape} pose graph: gap {gap:.3g}, inliers "
                                     f"{int(po['inlier'].sum())} vs {int(one_pgo[2].sum())}")
            line += (f"; edge-sharded optimize_two_phase on 10c's graph: {gap:.3g} from the "
                     f"single-device solve, the same {int(one_pgo[2].sum())} loop inliers")
        secs_line = ", ".join(f"{k} {max(r['seconds'][k] for r in runs):.1f} s"
                              for k in r0["seconds"])
        print(f"{line}; slowest rank: {secs_line} [{card}]", flush=True)
        for r in runs:
            for k, v in r["launches"].items():
                total[k] = total.get(k, 0) + v
    return total


def phase_lio_sharded_profile(device, card, out_dir):
    """A LioSharded step at a (1, 1) mesh (a fresh one-rank NCCL world)
    under the profiler, after 8 frames of warm-up: launches, device vs
    host time; its table goes to `out_dir`."""
    from loc_lib_tpu_torch.pipeline import lio_sharded

    log = demo_log(10)
    with _NcclWorld(device) as mesh:
        eng = lio_sharded.LioSharded(mesh, lio_options("ndt_inc"), device=device)
        for t, g, a in zip(log.imu.stamps[:150], log.imu.gyro[:150], log.imu.acce[:150]):
            eng.init_imu(g, a, t)
        mgs = list(log.measures(imu_capacity=64))
        for mg in mgs[:-1]:
            eng.add_measure(log.frame(mg.scan_index, device), mg.imu_gyro, mg.imu_acce,
                            mg.imu_stamp, mg.imu_valid)
        mg = mgs[-1]
        last = log.frame(mg.scan_index, device)
        n, dev_ms, host_ms, prof = _profiled(
            lambda: eng.add_measure(last, mg.imu_gyro, mg.imu_acce, mg.imu_stamp,
                                    mg.imu_valid), 1)
    (out_dir / "profile_lio_sharded_step.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total", row_limit=40))
    print(f"phase 12 profile: one LioSharded step at (1, 1) (NCCL, no collective at one rank) "
          f"under the profiler: {n:.0f} device launches, device {dev_ms:.3f} ms vs host "
          f"{host_ms:.3f} ms, busy {100 * dev_ms / host_ms:.1f}% [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 13: the leaves (filters, bfnn, ring search, reflector)
# ---------------------------------------------------------------------------

def phase_leaves(device, card, workload):
    """13: bfnn.knn (k = 1 and 5) of the headline's 8,192 source points
    against its 65,536-point target, exact against a float64 numpy oracle on
    256 queries and never farther than voxel.knn's answer; the filters on
    the same cloud against numpy; scan_match_rings on
    tests/test_small_ops.py:44's workload; reflector.process_scan on
    tests/test_small_ops.py:91's scene."""
    from loc_lib_tpu_torch.models import reflector
    from loc_lib_tpu_torch.ops import bfnn, filters, ring_search, voxel

    tgt, src = workload[0], workload[1]
    t0 = time.perf_counter()
    T = tgt.xyz.cpu().numpy().astype(np.float64)
    tm = tgt.mask.cpu().numpy()
    Q = src.xyz.cpu().numpy().astype(np.float64)
    sub = np.random.default_rng(3).choice(np.flatnonzero(src.mask.cpu().numpy()), 256, False)
    ref = np.where(tm[None], ((Q[sub, None] - T[None]) ** 2).sum(-1), np.inf)
    grid = voxel.build_hash_grid(tgt, 1.0, bucket_size=8)
    lines = []
    for k in (1, 5):
        torch.cuda.synchronize()
        tk = time.perf_counter()
        _, idx, d2, valid = bfnn.knn(tgt, src.xyz, src.mask, k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - tk) * 1e3
        if d2.device.type != device.type:
            raise AssertionError("bfnn.knn left the card")
        idx, d2, valid = idx.cpu().numpy(), d2.cpu().numpy(), valid.cpu().numpy()
        want = np.sort(ref, axis=1)[:, :k]
        got64 = np.take_along_axis(ref, idx[sub].astype(np.int64), axis=1)
        tol = 4 * 2.0 ** -24 * ((Q[sub] ** 2).sum(1)[:, None] + (T[tm] ** 2).sum(1).max())
        if not (valid[sub].all() and np.all(np.abs(got64 - want) <= tol)
                and np.all(np.abs(d2[sub] - want) <= tol)):
            raise AssertionError(f"13 bfnn k={k}: not the float64 nearest neighbours")
        _, _, gd2, gvalid = voxel.knn(grid, src.xyz, src.mask, k)
        gd2, gvalid = gd2.cpu().numpy(), gvalid.cpu().numpy()
        slack = (4 * 2.0 ** -24 * ((Q ** 2).sum(1)[:, None] + (T[tm] ** 2).sum(1).max()))
        if not np.all(gd2[gvalid] >= (d2 - slack)[gvalid]):
            raise AssertionError(f"13 bfnn k={k}: voxel.knn found a nearer neighbour")
        lines.append(f"k={k} {ms:.1f} ms, exact on 256 queries, voxel.knn never nearer "
                     f"({int(gvalid.sum())} grid answers)")
    box = filters.box_filter(tgt, [0.0, 0.0, 0.0], [60.0, 40.0, 10.0]).mask.cpu().numpy()
    rng = filters.range_filter(tgt, 4.0, 50.0).mask.cpu().numpy()
    Tf = tgt.xyz.cpu().numpy()
    want_box = tm & np.all((Tf >= [-30, -20, -5]) & (Tf <= [30, 20, 5]), axis=1)
    r = np.linalg.norm(Tf.astype(np.float64), axis=1)
    edge = np.abs(r - 4.0) < 1e-5
    edge |= np.abs(r - 50.0) < 1e-4
    want_rng = tm & (r >= 4.0) & (r <= 50.0)
    if not (np.array_equal(box, want_box) and np.array_equal(rng[~edge], want_rng[~edge])
            and np.array_equal(filters.remove_nonfinite(tgt).mask.cpu().numpy(), tm)):
        raise AssertionError("13 filters disagree with numpy")
    lines.append(f"filters: box keeps {int(box.sum())}, range {int(rng.sum())} of "
                 f"{int(tm.sum())}, as numpy")
    # ring search: the cylindrical room of tests/test_small_ops.py:44
    def room(R_w=None, t_w=None, num_rings=8, ring_len=256):
        g = np.random.default_rng(0)
        az = (np.arange(ring_len) + 0.5) / ring_len * 2 * np.pi - np.pi
        pts, ring = [], []
        for k in range(num_rings):
            el = -0.2 + 0.05 * k
            radius = 8.0 + 0.5 * np.sin(3 * az) + g.normal(0, 0.01, ring_len)
            p = np.stack([radius * np.cos(az), radius * np.sin(az), radius * el], 1)
            if R_w is not None:
                p = (p - t_w) @ R_w
            pts.append(p)
            ring.append(np.full(ring_len, k, np.int32))
        return (torch.from_numpy(np.concatenate(pts).astype(np.float32)).to(device),
                torch.from_numpy(np.concatenate(ring)).to(device))
    R_w = _so3_exp(np.array([0.0, 0.0, 0.01])).astype(np.float32)
    t_w = np.array([0.05, 0.02, 0.0], np.float32)
    (x0, ring), (x1, _) = room(), room(R_w, t_w)
    ok = torch.ones(x0.shape[0], dtype=torch.bool, device=device)
    p0 = ring_search.organize_rings(x0, ring, ok, 8, 256)
    p1 = ring_search.organize_rings(x1, ring, ok, 8, 256)
    rres = ring_search.scan_match_rings(p0, p1, ring_search.RingOptions(
        num_rings=8, ring_len=256, eps=1e-4, max_iteration=40))
    terr = float(np.linalg.norm(rres.t.cpu().numpy() - t_w))
    if not (terr < 0.03 and int(rres.num_effective) > 500):
        raise AssertionError(f"13 scan_match_rings: {terr:.4f} m off, "
                             f"{int(rres.num_effective)} effective")
    lines.append(f"scan_match_rings {terr * 100:.2f} cm off in {rres.iterations} iterations")
    # reflector: four markers seen from (theta, tx, ty)
    theta, tx, ty = 0.3, 0.4, -0.2
    map_xy = np.array([[2.0, 0.0], [0.0, 3.0], [-2.5, -1.0], [3.0, 2.5]], np.float32)
    c, s = np.cos(theta), np.sin(theta)
    m_r = (map_xy - [tx, ty]) @ np.array([[c, -s], [s, c]])
    B = 720
    angles = ((np.arange(B) + 0.5) / B * 2 * np.pi - np.pi).astype(np.float32)
    ranges = np.full(B, 5.5, np.float32)
    inten = np.full(B, 5.0, np.float32)
    for mx, my in m_r:
        a, rr = np.arctan2(my, mx), np.hypot(mx, my)
        half = max(int(round(0.03 / rr / (2 * np.pi / B))), 1)
        i0 = int(np.round((a + np.pi) / (2 * np.pi) * B))
        for k in range(i0 - half, i0 + half + 1):
            ranges[k % B] = rr
            inten[k % B] = 200.0
    to = lambda x: torch.from_numpy(np.asarray(x)).to(device)
    fix = reflector.process_scan(to(ranges), to(angles), to(inten), to(np.ones(B, bool)),
                                 to(map_xy), to(np.ones(4, bool)))
    perr = float(np.linalg.norm(fix.t.cpu().numpy() - [tx, ty]))
    if not (bool(fix.ok) and perr < 0.05 and abs(float(fix.theta) - theta) < 0.02):
        raise AssertionError(f"13 reflector: fix {bool(fix.ok)}, {perr:.4f} m off")
    lines.append(f"reflector fix {perr * 100:.2f} cm / {abs(float(fix.theta) - theta):.2g} rad "
                 f"off, {int(fix.num_inliers)} markers")
    print(f"phase 13 leaves ({time.perf_counter() - t0:.1f} s): bfnn.knn of {N_SOURCE} queries "
          f"against {N_TARGET} target points: " + "; ".join(lines) + f" [{card}]", flush=True)


# ---------------------------------------------------------------------------
# Phase 14: the apps, through their CLIs
# ---------------------------------------------------------------------------

# The JAX package's app reports on the CPU for each --demo run (one run
# each, PERF.md section 2) plus 0.04 m, the section's rule.
JAX_ATE_APP_MAPPING_M = 0.0473      # apps.mapping --demo (30 frames, icp / p2plane)
JAX_ATE_APP_NDT_INC_M = 0.0501      # apps.mapping --demo --config (ndt_inc)
JAX_ATE_APP_MATCHING_M = 1.151475   # apps.matching --demo (20 frames, p2plane_vox, no IMU)
APP_CKPT_EVERY = 10
NDT_INC_YAML = ("# apps.mapping --config: incremental NDT (slam.yaml's enums)\n"
                "lio_mapping:\n  matching_method: 2\n  ndt_option:\n    method: 1\n")
PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


class _Engines:
    """Records every engine an app builds while a run lasts: `module.name`
    is replaced by a subclass that keeps each instance."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.engines = []

    def __enter__(self):
        engines = self.engines

        class Recorded(self.orig):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                engines.append(self)

        setattr(self.module, self.name, Recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _artifacts(out, names, label):
    """Every artifact exists; each PNG starts with the PNG signature. The
    report and the PNGs are copied under chiprun_out/apps/<label>/."""
    import shutil
    from pathlib import Path

    keep = Path(__file__).resolve().parent / "chiprun_out" / "apps" / label
    keep.mkdir(parents=True, exist_ok=True)
    for name in names:
        p = Path(out) / name
        if not p.exists():
            raise AssertionError(f"14 {label}: {name} was not written")
        if name.endswith(".png") and p.read_bytes()[:8] != PNG_MAGIC:
            raise AssertionError(f"14 {label}: {name} is not a PNG")
        if name.endswith((".png", ".json")):
            shutil.copy(p, keep / p.name)


def _stage_line(rep) -> str:
    return ", ".join(f"{k} {v:.2f} ms" for k, v in rep["stage_ms"].items())


def phase_apps(device, card, counted, one_launch_per_linearization, out_root):
    """14: the four apps through their `main` (the CLI a user runs, with no
    device argument: the card) and the entry point. 14a mapping --demo (30
    frames, capacity 8192, LioOptions(): icp / p2plane), then --config with
    a written slam.yaml selecting ndt_inc (one K3 launch per GN iteration);
    14b --ckpt-every 10, then --resume from frame 19's checkpoint: the
    resumed poses are the uninterrupted run's bits; 14c matching --demo (K2,
    one launch per GN iteration); 14d run_slam on phase 10's slam3d_loop log
    with the app's default options (a loop with an inlier, K1 / K1-batch,
    scan_context.png); 14e mapping2d --demo and --host-driven; 14g entry().
    (14f, --mp-shards 1 in the one-rank NCCL world, is `phase_apps_sharded`.)
    Fails unless native.available(), every report's ATE is within JAX + 0.04
    m and every artifact exists. Stage times are host-clock means: the apps
    pass no block_on. Returns (launch counts summed over the runs, the 14c
    Loc poses, the 14f twin's poses)."""
    import dataclasses
    import os

    from loc_lib_tpu_torch import entry
    from loc_lib_tpu_torch.apps import mapping, mapping2d, matching, slam
    from loc_lib_tpu_torch.io import logdir, native
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.pipeline import lio, loc, slam3d

    t_all = time.perf_counter()
    if not native.available():
        raise AssertionError("14: the native host runtime did not build (g++ is on this "
                             "machine)")
    total = {}

    def add(c):
        for k, v in c.items():
            total[k] = total.get(k, 0) + v

    def timed(fn):
        t0 = time.perf_counter()
        r = fn()
        return r, time.perf_counter() - t0

    map_files = ("trajectory_kitti.txt", "trajectory_tum.txt", "global_map.npz",
                 "map_topdown.png", "report.json", "key_frames/manifest.json")
    # 14a: mapping --demo, the default front end (knn p2plane: gn_step only)
    d = os.path.join(out_root, "mapping")
    with _Engines(lio, "Lio") as rec:
        (rep, secs), c = counted(("gn_step", "so3_renormalize"),
                                 lambda: timed(lambda: mapping.main(["--demo", "--out", d])))
    add(c)
    _artifacts(d, map_files, "mapping")
    plain_poses = np.stack(rec.engines[0].poses)
    if not rep["ate_rmse_m"] <= JAX_ATE_APP_MAPPING_M + 0.04:
        raise AssertionError(f"14a mapping: ATE {rep['ate_rmse_m']} m")
    print(f"phase 14a apps.mapping --demo: {rep['frames']} frames, {rep['keyframes']} "
          f"keyframes, {rep['map_points']} map points, ATE {rep['ate_rmse_m']} m (bound "
          f"{JAX_ATE_APP_MAPPING_M + 0.04:.4f}), stage means {_stage_line(rep)} (host clock), "
          f"{secs:.1f} s with the demo log; launches {c} [{card}]", flush=True)
    # 14a: --config selecting ndt_inc
    cfg = os.path.join(out_root, "ndt_inc.yaml")
    with open(cfg, "w") as f:
        f.write(NDT_INC_YAML)
    d = os.path.join(out_root, "mapping_ndt_inc")
    with _Spy(lio, "step_measure", lambda r: r[1].iterations) as steps:
        (rep, secs), c = counted(("ndt_fused_terms", "gn_step"), lambda: timed(
            lambda: mapping.main(["--demo", "--config", cfg, "--out", d])))
    add(c)
    _artifacts(d, map_files, "mapping_ndt_inc")
    one_launch_per_linearization("phase 14a mapping --config (ndt_inc)", c,
                                 ("ndt_fused_terms", "gn_step"), sum(steps.calls))
    if not rep["ate_rmse_m"] <= JAX_ATE_APP_NDT_INC_M + 0.04:
        raise AssertionError(f"14a mapping --config: ATE {rep['ate_rmse_m']} m")
    print(f"phase 14a apps.mapping --demo --config (ndt_inc): {rep['frames']} frames, "
          f"{rep['keyframes']} keyframes, ATE {rep['ate_rmse_m']} m (bound "
          f"{JAX_ATE_APP_NDT_INC_M + 0.04:.4f}), stage means {_stage_line(rep)} (host clock), "
          f"{secs:.1f} s [{card}]", flush=True)
    # 14b: checkpoints every 10 scans, then resume from frame 19's
    d = os.path.join(out_root, "mapping_ckpt")
    with _Engines(lio, "Lio") as rec:
        full, c = counted((), lambda: mapping.main(
            ["--demo", "--ckpt-every", str(APP_CKPT_EVERY), "--out", d]))
        add(c)
        kept = sorted(os.listdir(os.path.join(d, "ckpt")))
        os.unlink(os.path.join(d, "ckpt", kept[-1]))
        tail, c = counted((), lambda: mapping.main(
            ["--demo", "--ckpt-every", str(APP_CKPT_EVERY), "--resume", "--out", d]))
        add(c)
    whole, resumed = np.stack(rec.engines[0].poses), np.stack(rec.engines[1].poses)
    start = int(kept[-2][5:13]) + 1
    if not (np.array_equal(whole, plain_poses) and len(resumed) == full["frames"] - start
            and np.array_equal(resumed, whole[-len(resumed):])):
        raise AssertionError(f"14b: resumed poses differ from the uninterrupted run's "
                             f"(checkpoints {kept})")
    _artifacts(d, map_files, "mapping_resumed")
    print(f"phase 14b apps.mapping --ckpt-every {APP_CKPT_EVERY} then --resume: checkpoints "
          f"{kept}, the last removed; resumed at frame {start}: {tail['frames']} frames, the "
          f"uninterrupted run's bits (and the checkpointing run 14a's); keyframe store "
          f"{full['keyframes']} -> {tail['keyframes']} [{card}]", flush=True)
    # 14c: matching --demo: K2, one launch per GN iteration
    d = os.path.join(out_root, "matching")
    with _Engines(loc, "Loc") as rec, _Spy(icp, "scan_match", lambda r: r.iterations) as m:
        (rep, secs), c = counted(("p2plane_pick_fused_terms", "gn_step"), lambda: timed(
            lambda: matching.main(["--demo", "--out", d])))
    add(c)
    one_launch_per_linearization("phase 14c matching --demo", c,
                                 ("p2plane_pick_fused_terms", "gn_step"), sum(m.calls))
    _artifacts(d, ("trajectory_kitti.txt", "trajectory_tum.txt", "report.json"), "matching")
    loc_poses = np.stack(rec.engines[0].poses)
    if not rep["ate_rmse_m"] <= JAX_ATE_APP_MATCHING_M + 0.04:
        raise AssertionError(f"14c matching: ATE {rep['ate_rmse_m']} m")
    print(f"phase 14c apps.matching --demo: {rep['frames']} frames, ATE "
          f"{rep['ate_rmse_m']:.4f} m (bound {JAX_ATE_APP_MATCHING_M + 0.04:.4f}), "
          f"{rec.engines[0].num_recrops} re-crops, stage means {_stage_line(rep)} (host clock), "
          f"{secs:.1f} s [{card}]", flush=True)
    # 14d: run_slam on the slam3d_loop log, the app's default options
    log = slam3d_log(SLAM_FRAMES)
    d = os.path.join(out_root, "slam")
    opts = slam3d.Slam3dOptions(lio=lio.LioOptions(scan_capacity=log.scan_xyz.shape[1]))
    (rep, secs), c = counted(("p2plane_fused_terms", "gn_step"), lambda: timed(
        lambda: slam.run_slam(log, opts, d)))
    add(c)
    _artifacts(d, ("odometry_kitti.txt", "keyframes_optimized_kitti.txt", "global_map.npz",
                   "map_topdown.png", "scan_context.png", "report.json"), "slam")
    if not (rep["loops"] >= 1 and rep["loop_inliers"] >= 1):
        raise AssertionError(f"14d slam: {rep['loops']} loops, {rep['loop_inliers']} inliers")
    print(f"phase 14d apps.slam.run_slam (slam3d_loop log, {SLAM_FRAMES} frames, the app's "
          f"default options: loop_icp {opts.loop_icp.method}): {rep['frames']} frames, "
          f"{rep['keyframes']} keyframes, {rep['loops']} loops, {rep['loop_inliers']} inliers, "
          f"{rep['map_points']} map points, stage means {_stage_line(rep)} (host clock), "
          f"{secs:.1f} s; launches {c} [{card}]", flush=True)
    # 14e: mapping2d --demo, the device engine and the host-driven one
    for label, extra in (("mapping2d", []), ("mapping2d_host", ["--host-driven"])):
        d = os.path.join(out_root, label)
        (rep, secs), c = counted((), lambda: timed(
            lambda: mapping2d.main(["--demo", "--out", d] + extra)))
        add(c)
        _artifacts(d, ("trajectory_tum.txt", "submaps.npz", "occupancy_global.png",
                       "report.json"), label)
        if not rep["submaps"] >= 1 or rep["frames"] != 40:
            raise AssertionError(f"14e {label}: {rep}")
        print(f"phase 14e apps.mapping2d {' '.join(['--demo'] + extra)}: {rep['frames']} frames, "
              f"{rep['submaps']} submaps, {rep['loops']} loops, {secs:.1f} s "
              f"({rep['frames'] / secs:.1f} scans/s with the demo's render) [{card}]",
              flush=True)
    # the single-device twin of 14f's sharded mapping (what --mp-shards runs)
    twin_log = logdir.make_demo_log(num_frames=30)
    twin_opts = dataclasses.replace(lio.LioOptions(scan_capacity=twin_log.scan_xyz.shape[1]),
                                    matcher="ndt_inc")
    with _Engines(lio, "Lio") as rec:
        _, c = counted(("ndt_fused_terms",), lambda: mapping.run_mapping(
            twin_log, twin_opts, os.path.join(out_root, "mapping_twin")))
    add(c)
    twin_poses = np.stack(rec.engines[0].poses)
    # 14g: entry() once on the card
    (fn, args), c = counted(("gn_step",), lambda: _entry_twice(entry, device))
    add(c)
    print(f"phase 14g entry(): two LIO steps on {args[1].device}, finite; launches {c} "
          f"[{card}]", flush=True)
    print(f"phase 14 (14a-14e, 14g) took {time.perf_counter() - t_all:.1f} s of command time "
          f"[{card}]", flush=True)
    return total, loc_poses, twin_poses


def _entry_twice(entry, device):
    fn, args = entry.entry()
    state, out = fn(*args)
    state, out2 = fn(state, args[1], args[2])
    if not (args[1].device == device and torch.isfinite(out.t).all()
            and torch.isfinite(out2.t).all()):
        raise AssertionError("14g entry(): not on the card, or not finite")
    return fn, args


def phase_apps_sharded(device, card, counted, loc_poses, twin_poses, out_root):
    """14f: `mapping --mp-shards 1` and `matching --mp-shards 1` inside the
    caller's one-rank NCCL world (the CLI joins no second group and leaves
    the caller's as it is): LioSharded (K3 on the rank's own shard) and
    LocSharded (the election, then K1 plane given) give the poses of the
    single-device runs bit for bit, as 12a does. Returns launch counts."""
    import os

    import torch.distributed as dist
    from loc_lib_tpu_torch.apps import mapping, matching
    from loc_lib_tpu_torch.pipeline import lio_sharded, loc_sharded

    t0 = time.perf_counter()
    total = {}
    for label, app, mod, cls, names, single in (
            ("mapping", mapping, lio_sharded, "LioSharded", ("ndt_fused_terms", "gn_step"),
             twin_poses),
            ("matching", matching, loc_sharded, "LocSharded", ("p2plane_fused_terms", "gn_step"),
             loc_poses)):
        d = os.path.join(out_root, label + "_mp1")
        with _Engines(mod, cls) as rec:
            rep, c = counted(names, lambda: app.main(["--demo", "--mp-shards", "1", "--out", d]))
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
        if not dist.is_initialized():
            raise AssertionError(f"14f {label}: the app destroyed the caller's process group")
        poses = np.stack(rec.engines[0].poses)
        gap = float(np.linalg.norm(poses[:, :3, 3] - single[:, :3, 3], axis=1).max())
        if not np.array_equal(poses, single):
            raise AssertionError(f"14f {label} --mp-shards 1: poses differ from the "
                                 f"single-device run's (largest gap {gap:.3g} m)")
        _artifacts(d, ("trajectory_kitti.txt", "report.json"), label + "_mp1")
        print(f"phase 14f apps.{label} --demo --mp-shards 1 (one NCCL rank): {rep['frames']} "
              f"frames, ATE {rep['ate_rmse_m']:.4f} m, the single-device run's bits; "
              f"launches {c} [{card}]", flush=True)
    print(f"phase 14f took {time.perf_counter() - t0:.1f} s of command time [{card}]",
          flush=True)
    return total


def main_cards() -> int:
    """`python3 chip_smoke.py --cards`: phase 12b's paths with one rank a
    card over NCCL (4 cards or more), held to the single-device matches,
    pose graph and LIO run on card 0; nothing else runs."""
    n = torch.cuda.device_count()
    if n < 4:
        print(f"chip_smoke --cards: {n} card(s), 4 needed", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    card = phase_device(device)
    phase_build()
    workload = headline_workload(device)
    lio_last = phase_lio(device, card, "ndt_inc", "phase 5b", ATE_LIMIT_NDT_INC_M)
    t0 = time.perf_counter()
    c = phase_sharded_ranks(device, card, workload, lio_last[5], backend="nccl",
                            rank_device="cuda")
    print(f"phase 12b (one rank a card, NCCL) took {time.perf_counter() - t0:.1f} s of command "
          f"time; launches summed over the ranks: {c} [{card} x {n}]", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": n}}), flush=True)
    return 0


def main() -> int:
    from pathlib import Path

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--cards"]:
        return main_cards()
    from loc_lib_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    card = phase_device(device)
    phase_build()
    workload = headline_workload(device)
    given_errs, to_profile = phase_kernels(device, card, workload)
    timing, calls = phase_kernels_from_target(device, card, workload)
    to_profile.update(calls)
    _, calls = phase_kernels_k3(device, card)
    to_profile.update(calls)
    k3_modes, calls = phase_kernels_k3_from_map(device, card, workload)
    to_profile.update(calls)
    timing["ndt_fused_terms"] = k3_modes["K3 from map"]
    pose_timing, calls = phase_kernels_pose_update(device, card)
    timing.update(pose_timing)
    to_profile.update(calls)

    def counted(names, fn):
        """Run one path with every counter set to 0 just before it; each
        kernel in `names` must have launched in it. Returns (result, counts)."""
        kernels.reset_launch_counts()
        result = fn()
        counts = dict(kernels.LAUNCHES)
        for name in names:
            if counts[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched by its path")
        return result, counts

    def one_launch_per_linearization(label, counts, names, iterations):
        for name in names:
            if counts[name] != iterations:
                raise AssertionError(f"{label}: {counts[name]} launches of {name} for "
                                     f"{iterations} linearizations")
        print(f"{label} launches: {counts}: one launch of "
              f"{' and of '.join(names)} per linearization ({iterations} GN iterations)",
              flush=True)

    # the first slice's main path: the headline match and LIO (icp)
    (target, lio_last), launches = counted(
        ("p2plane_fused_terms", "p2plane_pick_fused_terms", "gn_step", "so3_renormalize"),
        lambda: (phase_headline(device, card, workload), phase_lio(device, card)))
    k2_err = phase_lio_k2_check(lio_last)
    # this slice's main path: LIO ndt_inc, the incremental-NDT cell
    ndt_last, c = counted(("ndt_fused_terms",), lambda: phase_lio(
        device, card, "ndt_inc", "phase 5b", ATE_LIMIT_NDT_INC_M))
    launches["ndt_fused_terms"] = c["ndt_fused_terms"]
    one_launch_per_linearization("phase 5b", c, ("ndt_fused_terms",), ndt_last[4])
    k3_err = phase_lio_k3_check(ndt_last, "phase 5b")
    # the other two matchers of the NDT family on the same log
    direct_last, c = counted(("ndt_fused_terms",), lambda: phase_lio(
        device, card, "ndt", "phase 5c", ATE_LIMIT_NDT_M))
    one_launch_per_linearization("phase 5c", c, ("ndt_fused_terms",), direct_last[4])
    k3_err = max(k3_err, phase_lio_k3_check(direct_last, "phase 5c"))
    _, c = counted(("p2plane_pick_fused_terms",), lambda: phase_lio(
        device, card, "icp_vox_inc", "phase 5d", ATE_LIMIT_VOX_INC_M))
    print(f"phase 5d launches: {c}", flush=True)
    # this slice: run-to-run deterministic map builds, LOAM odometry (K2 +
    # K3 at S = 1) and localization against the prior map (K2, K1)
    phase_determinism(device, card, workload)
    loam_last, c = counted(("p2plane_pick_fused_terms", "ndt_fused_terms"),
                           lambda: phase_loam(device, card))
    one_launch_per_linearization("phase 5e", c, ("p2plane_pick_fused_terms", "ndt_fused_terms"),
                                 loam_last[5])
    e3, e2 = phase_loam_checks(loam_last)
    k3_err, k2_err = max(k3_err, e3), max(k2_err, e2)
    loc_vox, c = counted(("p2plane_pick_fused_terms",), lambda: phase_loc(
        device, card, "p2plane_vox", "phase 7", ATE_LIMIT_LOC_M))
    print(f"phase 7 launches (p2plane_vox): {c}", flush=True)
    phase_loc_crop_timing(card, loc_vox, "phase 7")
    loc_oct, c = counted(("p2plane_fused_terms",), lambda: phase_loc(
        device, card, "p2plane_vox_oct", "phase 7b", ATE_LIMIT_LOC_OCT_M))
    print(f"phase 7b launches (p2plane_vox_oct): {c}", flush=True)
    phase_loc_crop_timing(card, loc_oct, "phase 7b")
    k1_err = phase_loc_k1_check(loc_oct)
    k2_err = max(k2_err, phase_loc_k2_check(loc_vox))
    # re-crops: a 110 m box re-crops once the pose is 5 m from the crop
    # centre; a 60 m box (half-size 30 m < the 50 m margin) on every frame
    rc, c = counted(("p2plane_pick_fused_terms",), lambda: phase_loc(
        device, card, "p2plane_vox", "phase 7c", ATE_LIMIT_LOC_RECROP_M, box_size=110.0)[0])
    print(f"phase 7c launches (110 m box): {c}", flush=True)
    short, c = counted(("p2plane_pick_fused_terms",), lambda: phase_loc(
        device, card, "p2plane_vox", "phase 7d", frames=8, box_size=60.0)[0])
    print(f"phase 7d launches (60 m box): {c}", flush=True)
    for label, eng in (("110 m", rc), ("60 m", short)):
        if eng.num_recrops < 1:
            raise AssertionError(f"Loc {label} box: no re-crop")
    # batched matching on the batched K2 / K1, then the frozen
    # election and the knn methods
    bw = batch_workload(device)
    batch_targets = phase_batch_targets(device, card, bw)
    batch_errs, calls = phase_kernels_batch(device, card, bw, batch_targets)
    to_profile.update(calls)
    batch_matches, c = phase_batched_match(device, card, bw, batch_targets)
    print(f"phase 8 launches (the six scan_match_batch calls alone, every counter at 0 before "
          f"each and read after it): {c}", flush=True)
    for name in ("p2plane_pick_fused_terms", "p2plane_fused_terms", "gn_step",
                 "so3_renormalize"):
        if c[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the batched path")
        launches[name] += c[name]
    phase_rest_of_icp(device, card, workload)
    phase_lio_syncs(device, card)
    # 3D SLAM: the slam3d_loop cell (K2 front end, K2-batch loop
    # registration), the default loop_icp (K1, K1-batch), the full-width
    # pose graph
    t_slam = time.perf_counter()
    slam_eng, c = phase_slam3d(device, card)
    print(f"phase 10a launches (the first 92-frame run, every counter at 0 before it): {c} "
          f"[{card}]", flush=True)
    for name in ("p2plane_pick_fused_terms", "gn_step", "so3_renormalize"):
        if c[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the 3D SLAM path")
        launches[name] += c[name]
    launches["p2plane_fused_terms"] += phase_slam3d_default_loop_icp(device, card)
    pgo_graph_, pgo_opts = phase_pgo_full_width(device, card)
    print(f"phase 10 took {time.perf_counter() - t_slam:.1f} s of command time (10a-10c; the "
          f"profiled optimize() calls come after phase 6) [{card}]", flush=True)
    # the 2D stack: torch ops only (no kernel of this repo on its path)
    t_2d = time.perf_counter()
    m2d_eng = phase_mapping2d(device, card)
    print(f"phase 11 took {time.perf_counter() - t_2d:.1f} s of command time (11a-11e; the "
          f"profile comes after phase 10's) [{card}]", flush=True)
    # the distributed layer: 12a one rank (NCCL) through the sharded
    # pipelines, 12b several ranks spawned on the one card (gloo)
    t_dist = time.perf_counter()

    def add(counts):
        for name, n in counts.items():
            launches[name] += n

    with _NcclWorld(device) as mesh:
        (iters, lio_sharded_poses), c = counted(
            ("ndt_fused_terms", "gn_step", "so3_renormalize"),
            lambda: phase_lio_sharded(device, card, mesh, ndt_last[5]))
        one_launch_per_linearization("phase 12a lio_sharded_mapping", c,
                                     ("ndt_fused_terms", "gn_step"), iters)
        add(c)
        _, c = counted(("ndt_fused_terms", "p2plane_pick_fused_terms", "gn_step",
                        "so3_renormalize"), lambda: phase_slam3d_sharded(device, card, mesh))
        print(f"phase 12a slam3d_sharded launches: {c}", flush=True)
        add(c)
        iters, c = counted(("p2plane_fused_terms", "gn_step", "so3_renormalize"),
                           lambda: phase_loc_sharded(device, card, mesh,
                                                     np.stack(loc_vox[0].poses)))
        one_launch_per_linearization("phase 12a LocSharded", c, ("p2plane_fused_terms", "gn_step"),
                                     iters)
        add(c)
    c = phase_sharded_ranks(device, card, workload, lio_sharded_poses)
    print(f"phase 12b launches (the ranks' paths, summed over the ranks of both meshes, every "
          f"counter at 0 before them): {c}", flush=True)
    for name in ("p2plane_fused_terms", "ndt_fused_terms", "gn_step", "so3_renormalize"):
        if c.get(name, 0) <= 0:
            raise AssertionError(f"kernel {name} was not launched by the ranks of phase 12b")
    add(c)
    print(f"phase 12 took {time.perf_counter() - t_dist:.1f} s of command time [{card}]",
          flush=True)
    _, c = counted(("gn_step", "so3_renormalize"), lambda: phase_leaves(device, card, workload))
    add(c)
    # the apps through their CLIs (14a-14e, 14g), then --mp-shards 1 in a
    # one-rank NCCL world (14f)
    import tempfile
    with tempfile.TemporaryDirectory() as app_out:
        c, loc_app_poses, twin_poses = phase_apps(device, card, counted,
                                                  one_launch_per_linearization, app_out)
        add(c)
        with _NcclWorld(device):
            add(phase_apps_sharded(device, card, counted, loc_app_poses, twin_poses, app_out))
    # every profiler run comes after the paths' host-clock timings
    phase_headline_timing(device, card, workload, target)
    phase_gather_before_after(device, card, workload, target)
    dev_ms = phase_kernel_device_times(card, to_profile)
    phase_batched_profile(card, batch_matches)
    for name, label in (("p2plane_fused_terms", "K1 from target"),
                        ("p2plane_pick_fused_terms", "K2 from target"),
                        ("ndt_fused_terms", "K3 from map: from map"),
                        ("gn_step", "gn_step"), ("so3_renormalize", "so3_renormalize")):
        timing[name]["device_ms"] = dev_ms[label]
    phase_profile(device, card, workload, target,
                  Path(__file__).resolve().parent / "chiprun_out")
    phase_slam3d_profile(card, slam_eng, pgo_graph_, pgo_opts)
    phase_mapping2d_profile(device, card, m2d_eng)
    phase_lio_sharded_profile(device, card, Path(__file__).resolve().parent / "chiprun_out")

    src = {"p2plane_fused_terms": ("loc_lib_tpu_torch/csrc/p2plane_fused_terms.cu",
                                   "loc_lib_tpu/ops/pallas_kernels.py:75"),
           "p2plane_pick_fused_terms": ("loc_lib_tpu_torch/csrc/p2plane_pick_fused_terms.cu",
                                        "loc_lib_tpu/ops/pallas_kernels.py:185"),
           "ndt_fused_terms": ("loc_lib_tpu_torch/csrc/ndt_fused_terms.cu",
                               "loc_lib_tpu/ops/pallas_kernels.py:314"),
           # no TPU kernel: the loop body's pose update and the final
           # projection, which XLA fuses into the reference's program
           "gn_step": ("loc_lib_tpu_torch/csrc/gn_update.cu", "loc_lib_tpu/models/icp.py:705"),
           "so3_renormalize": ("loc_lib_tpu_torch/csrc/gn_update.cu",
                               "loc_lib_tpu/models/icp.py:721")}
    errs = {k: v["err"] for k, v in timing.items()}
    errs["p2plane_fused_terms"] = max(errs["p2plane_fused_terms"], k1_err,
                                      given_errs["p2plane_fused_terms"],
                                      batch_errs["p2plane_fused_terms"])
    errs["p2plane_pick_fused_terms"] = max(errs["p2plane_pick_fused_terms"], k2_err,
                                           given_errs["p2plane_pick_fused_terms"],
                                           batch_errs["p2plane_pick_fused_terms"])
    errs["ndt_fused_terms"] = max(errs["ndt_fused_terms"], k3_err)
    print("library_ms is null for every kernel: no single PyTorch call computes one of "
          "them (K1-K3 each build their rows from a gather, an election and a gate, then reduce "
          "them; gn_step and so3_renormalize, the pose update of a GN iteration and the final "
          "projection, are chains of elementwise operations and 3x3 products, timed at one "
          "match); ms, plain_ms, device_ms and bound_ms of K1 and K2 are those of the "
          "from-target mode and, since this revision, those of K3 are those of the from-map "
          "mode (S = 7, weighted, trunc, on an update_incremental map of the headline target): "
          "the modes the paths run, at the headline inputs; launches of K1, K2, gn_step and "
          "so3_renormalize are those of the headline match and LIO plus those of phase 8's "
          "scan_match_batch calls and of phase 10's 3D SLAM runs (K1: 10b's two), and every "
          "kernel's adds phase 12's sharded paths (12a's three runs, 12b's ranks summed) and "
          "phase 13's ring match and phase 14's app runs (14a-14g); launches of K3 are "
          "those of phase 5b, phase 12 and phase 14; "
          "max_abs_err of K1 and K2 covers their batched forms",
          flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "device_ms": timing[name]["device_ms"], "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": None}
        for name in ("p2plane_fused_terms", "p2plane_pick_fused_terms",
                     "ndt_fused_terms", "gn_step", "so3_renormalize")]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
