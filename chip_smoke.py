#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (loc_lib_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from csrc/, holds each against its plain
PyTorch version on the card (K1 and K2 in both modes: plane / rows given,
and from the target with the gather inside the kernel), then drives the
port's paths through the entry points a user calls: the headline scan-to-map match (set_target +
scan_match, p2plane_vox_oct, 65,536-point target, 8,192-point source), 40
frames of LIO mapping (Lio.add_measure, p2plane_vox + ESKF, scan capacity
8192), and the NDT family on the same log: incremental NDT (ndt_inc, the
repo's ndt_inc_odometry cell), direct NDT (ndt) and the moment-table voxel
planes (icp_vox_inc). Then it checks that the map builds give the same bits
on every run, and drives LOAM odometry (annotate_rings + extract_features +
Lio.add_measure with edge_scan) and localization against a prior map
(Loc.update_measure with p2plane_vox and p2plane_vox_oct, and two runs
that re-crop). Launch counters, set to 0 before each path and read after
it, show each path went through its kernels. Then it compares a match with
the gather in torch ops against the shipped one (same bits; launches per
Gauss-Newton iteration), and only then opens the profiler: device time per
kernel call, and the time of the paths broken down per layer
(torch.profiler tables go to an output directory beside this script).

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
    print(f"phase 2 build: {info.path.name} in {secs:.1f} s "
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
    its own centroid and those of its -x, -y and -z neighbours. Returns
    (target with the octant tables, options)."""
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
    return icp.IcpTarget(grid=grid, packed=packed, dense=dense, dense_oct=dense_oct,
                         oct_table=oct_table, packed_ext=packed_ext), opts


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
        if expect_zero and (int(got[2]) != 0 or torch.any(got[0] != 0) or torch.any(got[1] != 0)
                            or float(got[3]) != 0):
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
        H, bb, cnt, chi2 = K3(pad, pad, zrows[..., 0:3], zrows[..., 3:12],
                              torch.zeros((n, S), device=device), torch.eye(3, device=device),
                              torch.zeros(3, device=device), NDT_TH, weighted)
        if int(cnt) != 0 or torch.any(H != 0) or torch.any(bb != 0) or float(chi2) != 0:
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
    the last scan, its StepResult)."""
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
    if matcher != "icp" and eng.health.status == eng.health.LOST:
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
    return opts, before, scan, out


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
    lio_opts, before, scan, out = lio_last
    err, text = _k2_on_map("the LIO local map", before.icp_target, lio_opts.icp, scan,
                           out.R, out.t)
    print(f"phase 5 {text}", flush=True)
    return err


def phase_lio_k3_check(ndt_last, label):
    """K3 against its plain version on an NDT LIO path's own inputs: the map
    the last scan was matched to (incremental for ndt_inc, weighted; direct
    for ndt), that scan, its final pose."""
    from loc_lib_tpu_torch.models import ndt
    from loc_lib_tpu_torch.ops import kernels

    lio_opts, before, scan, out = ndt_last
    m = before.ndt_map
    opts = lio_opts.ndt_inc if lio_opts.matcher == "ndt_inc" else lio_opts.ndt
    weighted = opts.method == "incremental"
    args = (*ndt._fused_inputs(m, opts, scan, out.R, out.t), out.R, out.t,
            opts.res_outlier_th, weighted)
    got = kernels.ndt_fused_terms(*args)
    S = args[4].shape[1]
    name = f"K3 on the LIO {lio_opts.matcher} map"
    err, ratio = _compare(name, got, kernels.ndt_fused_terms_plain(*args),
                          kernels.ndt_rows_plain(*args), 3 * S)
    if int(got[2]) < opts.min_effective_pts:
        raise AssertionError(f"{name} kept only {int(got[2])} residuals")
    print(f"{label} {name} vs plain ({int(m.estimated.sum())} estimated voxels, "
          f"N={scan.capacity}, S={S}, {'weighted' if weighted else 'direct'}): "
          f"cnt {int(got[2])}, err {err:.3g}, err/bound {ratio:.3g}", flush=True)
    return err


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
    against, its surf and edge clouds, its StepResult)."""
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
    return opts, before, surf, edge, out


def phase_loam_checks(loam_last):
    """K3 at S = 1, weighted (the p2line_vox shape) on the LOAM path's own
    edge map, and K2 on its own surf map: the maps the last scan was matched
    to, at that scan's final pose. Returns (K3 error, K2 error)."""
    from loc_lib_tpu_torch.models import icp
    from loc_lib_tpu_torch.ops import kernels

    opts, before, surf, edge, out = loam_last
    tgt, eo, so = before.loam_target, opts.loam.edge_icp, opts.loam.surf_icp
    qs, rows, w = icp._p2line_vox_rows(tgt.edge, eo, edge, out.R, out.t)
    args = (edge.xyz, qs, rows[..., 0:3], rows[..., 3:12], w, out.R, out.t,
            eo.max_line_distance ** 2, True)
    got = kernels.ndt_fused_terms(*args)
    k3_err, r3 = _compare("K3 S=1 on the LOAM edge map", got, kernels.ndt_fused_terms_plain(*args),
                          kernels.ndt_rows_plain(*args), 3)
    if int(got[2]) < eo.min_effective_pts:
        raise AssertionError(f"K3 on the LOAM edge map kept only {int(got[2])} residuals")
    k2_err, k2_text = _k2_on_map("the LOAM surf map", tgt.surf, so, surf, out.R, out.t)
    print(f"phase 5e K3 (S=1, weighted) vs plain on the LOAM edge map "
          f"({int(tgt.edge.line_packed[:, 12].sum())} valid lines, N={edge.capacity}, "
          f"{int(edge.mask.sum())} edge points): cnt {int(got[2])}, err {k3_err:.3g}, "
          f"err/bound {r3:.3g}; {k2_text}", flush=True)
    return k3_err, k2_err


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
        if launches == 0:
            dev[label] = (None, 0)
            continue
        if one_launch:
            # a session may also hand over fewer events than were launched,
            # never more: over 1 per call is a second launch
            if launches > 1:
                raise AssertionError(f"{label}: {launches} launches per call, expected 1")
            ms, launches = ms / launches, 1
        dev[label] = (ms, launches)
    print("phase 3b device time per call at N=8192 (torch.profiler, kernels only) "
          f"[{card}]: " + "; ".join(
              f"{k} not measured (the profiler recorded no device event in 3 sessions)"
              if ms is None else f"{k} {ms:.4f} ms in {n:.0f} launches"
              for k, (ms, n) in dev.items()), flush=True)
    return {k: v[0] for k, v in dev.items()}


# ---------------------------------------------------------------------------
# Phase 6: where the time goes
# ---------------------------------------------------------------------------

def phase_profile(device, card, workload, target, out_dir):
    """Per-layer breakdown of the headline match, set_target and one LIO
    step of the icp and ndt_inc paths. Writes torch.profiler tables to
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

    for matcher in ("icp", "ndt_inc"):
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
    given_errs, to_profile = phase_kernels(device, card, workload)
    timing, calls = phase_kernels_from_target(device, card, workload)
    to_profile.update(calls)
    timing["ndt_fused_terms"], calls = phase_kernels_k3(device, card)
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

    # the first slice's main path: the headline match and LIO (icp)
    (target, lio_last), launches = counted(
        ("p2plane_fused_terms", "p2plane_pick_fused_terms"),
        lambda: (phase_headline(device, card, workload), phase_lio(device, card)))
    k2_err = phase_lio_k2_check(lio_last)
    # this slice's main path: LIO ndt_inc, the incremental-NDT cell
    ndt_last, c = counted(("ndt_fused_terms",), lambda: phase_lio(
        device, card, "ndt_inc", "phase 5b", ATE_LIMIT_NDT_INC_M))
    launches["ndt_fused_terms"] = c["ndt_fused_terms"]
    print(f"phase 5b launches: {c}", flush=True)
    k3_err = phase_lio_k3_check(ndt_last, "phase 5b")
    # the other two matchers of the NDT family on the same log
    direct_last, c = counted(("ndt_fused_terms",), lambda: phase_lio(
        device, card, "ndt", "phase 5c", ATE_LIMIT_NDT_M))
    print(f"phase 5c launches: {c}", flush=True)
    k3_err = max(k3_err, phase_lio_k3_check(direct_last, "phase 5c"))
    _, c = counted(("p2plane_pick_fused_terms",), lambda: phase_lio(
        device, card, "icp_vox_inc", "phase 5d", ATE_LIMIT_VOX_INC_M))
    print(f"phase 5d launches: {c}", flush=True)
    # this slice: run-to-run deterministic map builds, LOAM odometry (K2 +
    # K3 at S = 1) and localization against the prior map (K2, K1)
    phase_determinism(device, card, workload)
    loam_last, c = counted(("p2plane_pick_fused_terms", "ndt_fused_terms"),
                           lambda: phase_loam(device, card))
    print(f"phase 5e launches: {c}", flush=True)
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
    # every profiler run comes after the paths' host-clock timings
    phase_headline_timing(device, card, workload, target)
    phase_gather_before_after(device, card, workload, target)
    dev_ms = phase_kernel_device_times(card, to_profile)
    for name, label in (("p2plane_fused_terms", "K1 from target"),
                        ("p2plane_pick_fused_terms", "K2 from target"),
                        ("ndt_fused_terms", "K3")):
        timing[name]["device_ms"] = dev_ms[label]
    phase_profile(device, card, workload, target,
                  Path(__file__).resolve().parent / "chiprun_out")

    src = {"p2plane_fused_terms": ("loc_lib_tpu_torch/csrc/p2plane_fused_terms.cu",
                                   "loc_lib_tpu/ops/pallas_kernels.py:75"),
           "p2plane_pick_fused_terms": ("loc_lib_tpu_torch/csrc/p2plane_pick_fused_terms.cu",
                                        "loc_lib_tpu/ops/pallas_kernels.py:185"),
           "ndt_fused_terms": ("loc_lib_tpu_torch/csrc/ndt_fused_terms.cu",
                               "loc_lib_tpu/ops/pallas_kernels.py:314")}
    errs = {k: v["err"] for k, v in timing.items()}
    errs["p2plane_fused_terms"] = max(errs["p2plane_fused_terms"], k1_err,
                                      given_errs["p2plane_fused_terms"])
    errs["p2plane_pick_fused_terms"] = max(errs["p2plane_pick_fused_terms"], k2_err,
                                           given_errs["p2plane_pick_fused_terms"])
    errs["ndt_fused_terms"] = max(errs["ndt_fused_terms"], k3_err)
    print("library_ms is null for all three kernels: no single PyTorch call computes one of "
          "them (each builds its rows from a gather, an election and a gate, then reduces "
          "them); ms, plain_ms and device_ms of K1 and K2 are those of the from-target mode "
          "the paths run, at the headline inputs", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": timing[name]["ms"], "plain_ms": timing[name]["plain_ms"],
         "device_ms": timing[name]["device_ms"], "bound_ms": timing[name]["bound_ms"],
         "bound_by": timing[name]["bound_by"], "library_ms": None}
        for name in ("p2plane_fused_terms", "p2plane_pick_fused_terms",
                     "ndt_fused_terms")]}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
