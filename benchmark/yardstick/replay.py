"""One run of one cell: set-up (world, route, one lap of raw scans held in
host memory, rendered `renders` times where the traffic mix says so, the
engine and its warm-up), the measured window (the lap replayed closed-loop,
pass p from render p mod renders: a scan is handed over only after the
previous scan's pose has reached the host), then, with the window closed,
the traced slices and the comparison with the plain reference.

The timed path of a scan: the raw scan's copy from host memory to the card,
the engine's scan filter, the engine's step with the scan's IMU packet, and
the engine's own pull of the pose to the host, and, of an engine with a
back end, its `events()`. A scan's latency runs from the start of its
hand-over to the return of those calls (the pose is on the host then, and
a re-crop the pose triggered is done, as is whatever the engine's back end
did after the scan and the records it made of it).
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import resource
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import cell as cellmod
from . import reference, stepcheck, trace, world

PROFILED_SCANS = 40        # the traced slice: scans profiled, CUDA activity only
LABELLED_SCANS = 10        # a second slice with the host's activity, to label idle gaps


class Setup:
    """Everything set-up makes from the seed."""

    def __init__(self, cell: cellmod.Cell, seed: int, device, log=lambda what: None):
        cfg, traffic = cell.config, cell.traffic
        g = world.generator(seed, device)
        log("card ready")
        pts = world.make_world(cfg["world"], g, device)
        self.route = world.make_route(traffic, cfg["sensor"])
        static, self.ramp_packets, self.lap_packets = world.make_imu(
            self.route, cfg["imu_noise"], cfg["engine_options"]["imu_capacity"], g)
        self.static = (world.stamps32(static[0]), static[1], static[2])
        # each render of the lap a fresh draw of the points and the noise, all at the same poses
        self.renders = int(traffic.get("renders", 1))
        poses = np.concatenate([world.poses_at(self.route, world.ramp_times(self.route))]
                               + [world.poses_at(self.route, world.lap_times(self.route))]
                               * self.renders)
        self.true_world = poses             # by src: ramp scans, then each render's lap frames
        raw = world.render_scans(pts, poses, cfg["sensor"], g)
        log(f"lap rendered on the card ({self.renders} render{'s' * (self.renders > 1)})")
        self.raw = raw.cpu().numpy()
        del raw
        self.mask = np.ones(self.raw.shape[:2], bool)
        self.prior_map = None
        if "prior_map" in cfg:
            m = world.voxel_filter_map(pts, float(cfg["prior_map"]["leaf_m"]))
            e = cfg["engine_options"]
            rows = world.max_crop_rows(m, poses[:self.route.ramp + self.route.lap, :3, 3],
                                       e["box_size"] / 2.0)
            if rows > e["local_map_capacity"]:
                raise RuntimeError(f"a crop on the route holds {rows} map points, more than the "
                                   f"crop's {e['local_map_capacity']} rows")
            log(f"prior map of {len(m)} points; the largest crop on the route holds {rows} of "
                f"{e['local_map_capacity']} rows")
            self.prior_map = m.cpu().numpy()
        del pts

    def stream(self):
        """(src, packet) of every scan from the engine's start: the ramp, then
        the lap replayed for ever with its stamps moved on by a lap each
        pass, pass p from render p mod renders (the lap's first frame comes
        with the ramp's last packet on the first pass)."""
        r = self.route
        for k in range(r.ramp):
            yield k, self.ramp_packets.take(k)
        yield r.ramp, self.ramp_packets.take(r.ramp)
        lap, f = 0, 1
        while True:
            if f == r.lap:
                lap, f = lap + 1, 0
            yield r.ramp + (lap % self.renders) * r.lap + f, self.lap_packets.take(
                f, lap * r.lap_seconds)
            f += 1


def _engine(cell: cellmod.Cell, setup: Setup, device):
    mod = cellmod.load_module("engines", cell.config["engine"])
    extra = {"prior_map": setup.prior_map} if setup.prior_map is not None else {}
    return mod.Engine(cell.config, device, **extra)


def _truth(engine, setup: Setup) -> np.ndarray:
    """True poses by src in the engine's frame."""
    if engine.frame == "first_scan":
        return np.linalg.inv(setup.true_world[0]) @ setup.true_world
    return setup.true_world


class Runner:
    """Hands scans to the engine and keeps what the check needs: of every
    scan its host numbers (`stepcheck.ScanLog`), of the engine's first scan
    and of the scans the `sampler` chooses while it is set (the window) the
    device state too, and the filtered scans of the ordinals in `clouds`.
    Of an engine with a back end (`events()`) every correction it applied,
    and the events the `event_sampler` chooses while it is set, whose scans
    are held as the sampled scans are."""

    def __init__(self, engine, setup: Setup, device):
        self.engine, self.setup, self.device = engine, setup, device
        self.scans = stepcheck.ScanLog()
        self.sampler: Optional[stepcheck.Sampler] = None
        self.corrections = stepcheck.Corrections()
        self.event_sampler: Optional[stepcheck.EventSampler] = None
        self.backend = hasattr(engine, "events")
        self.clouds: Optional[dict] = None
        self.prev = None                       # the filter state after the last scan
        self.src_iter = setup.stream()
        on_card = torch.device(device).type == "cuda"
        self.sync = torch.cuda.synchronize if on_card else (lambda: None)

    def scan(self, fence: bool = False, spans: Optional[list] = None, label: bool = False) -> None:
        """One scan through the timed path. `fence`: synchronise around the
        filter and the engine's step, and append (filter ms, engine ms,
        rebuilt) to `spans`. `label`: mark the stages for the profiler."""
        src, packet = next(self.src_iter)
        eng = self.engine
        mark = torch.profiler.record_function if label else (lambda _: contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with mark("bench.copy"):
                xyz = torch.from_numpy(self.setup.raw[src]).to(self.device)
                mask = torch.from_numpy(self.setup.mask[src]).to(self.device)
            if fence:
                self.sync()
                t1 = time.perf_counter()
            with mark("bench.filter"):
                cloud = eng.filter(xyz, mask)
            if fence:
                self.sync()
                t2 = time.perf_counter()
            with mark("bench.engine"):
                out, rebuilt = eng.step(cloud, packet)
            pose, failed = eng.pose(), False
            events = eng.events() if self.backend else []
        except Exception as exc:       # a scan that raises counts in `failed`; the run goes on
            print(f"scan {len(self.scans)} (raw scan {src}) raised: {exc!r}", file=sys.stderr,
                  flush=True)
            out, rebuilt, pose, failed, cloud = None, False, np.full((4, 4), np.nan), True, None
            events = []
        t3 = time.perf_counter()
        if fence and not failed:
            self.sync()
            t3 = time.perf_counter()
            spans.append(((t2 - t1) * 1e3, (t3 - t2) * 1e3, rebuilt))
        ms = (t3 - t0) * 1e3
        # the front end's GN iterations, as its step's result gives them
        i = self.scans.append(src, pose, rebuilt, ms, t0, failed, getattr(out, "iterations", None))
        for e in events:
            if e["kind"] == "correction":
                self.corrections.append(i, e["dR"], e["dt"])
        after = None if failed else eng.filter_state()
        keep, drop = i == 0, []
        if self.sampler is not None and after is not None and self.prev is not None:
            keep, drop = self.sampler.offer(i, ms)
            if self.backend:
                # the scans of the chosen events are re-done too
                held, gone = self.event_sampler.offer_events(i, ms, events)
                keep, drop = keep or held, drop + gone
        for j in drop:
            if not (self.sampler.chooses(j) or self.backend and j in self.event_sampler.scans()):
                self.scans.kept.pop(j, None)
        if keep:
            self.scans.kept[i] = stepcheck.Kept(packet, self.prev, after, out)
        if self.clouds is not None and not failed:
            self.clouds[i] = cloud
        self.prev = after


class HostProbe:
    """What the host did over a stretch of the run, for the log: the
    process's CPU seconds, its context switches, the machine's stolen CPU
    time (/proc/stat, where there is one) and the garbage collector's
    passes and seconds."""

    def __init__(self):
        self.gc_s, self.gc_runs, self._t = 0.0, [0, 0, 0], None
        gc.callbacks.append(self._gc)
        self.start = self._read()

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc_s += time.perf_counter() - self._t
            self.gc_runs[info["generation"]] += 1

    @staticmethod
    def _read():
        ru = resource.getrusage(resource.RUSAGE_SELF)
        try:
            with open("/proc/stat") as f:
                fields = f.readline().split()
            steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
        except (OSError, IndexError, ValueError):
            steal = math.nan
        return (time.perf_counter(), ru.ru_utime + ru.ru_stime, ru.ru_nvcsw, ru.ru_nivcsw, steal)

    def stop(self) -> str:
        gc.callbacks.remove(self._gc)
        d = [b - a for a, b in zip(self.start, self._read())]
        return (f"{d[0]:.3f} s: {d[1]:.3f} s of CPU, {d[2]} voluntary / {d[3]} involuntary "
                f"context switches, {d[4]:.2f} s stolen from the machine's CPUs, garbage "
                f"collection {self.gc_s * 1e3:.1f} ms in {self.gc_runs} passes (by generation)")


def window(runner: Runner, seconds: float, fence: bool, sampler: stepcheck.Sampler,
           event_sampler: stepcheck.EventSampler):
    """Scans until `seconds` have passed, `sampler` choosing the scans the
    check re-does and `event_sampler` the back-end events: (first ordinal,
    window seconds, spans when fenced)."""
    first, spans = len(runner.scans), []
    runner.sampler, runner.event_sampler = sampler, event_sampler
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        runner.scan(fence=fence, spans=spans)
    window_s = time.perf_counter() - t0
    runner.sampler = runner.event_sampler = None
    return first, window_s, spans


def run_cell(cell: cellmod.Cell, seed: int, seconds: float, traced: bool, device,
             t_process: float, on_setup: Optional[Callable] = None,
             fault: Optional[Callable] = None, after_check: Optional[Callable] = None) -> dict:
    """One run; returns the result line's fields (and 'checks').
    `on_setup` is called once set-up is over; `fault`, when given, is called
    with the engine before the window (the tests plant a fault in the timed
    path with it); `after_check` with the run's record and the reference
    module once the comparison is done (the calibration reads the control
    with it)."""
    cfg = cell.config
    on_card = torch.device(device).type == "cuda"
    log = lambda what: print(f"[{time.perf_counter() - t_process:8.3f} s] {what}", file=sys.stderr,
                             flush=True)
    setup = Setup(cell, seed, device, log)
    log(f"world, route and {len(setup.raw)} raw scans made")
    engine = _engine(cell, setup, device)
    engine.start(setup.static, setup.true_world[0])
    runner = Runner(engine, setup, device)
    min_warm = int(cell.traffic["warmup_min_scans"])
    while not (engine.ready() and len(runner.scans) >= min_warm):
        runner.scan()
        if len(runner.scans) > setup.route.ramp + setup.route.lap:
            raise RuntimeError("the warm-up did not make the engine ready within a lap")
    log(f"engine warmed up over {len(runner.scans)} scans; {len(os.listdir('/proc/self/task'))} "
        "threads in the process")
    if on_setup is not None:
        on_setup()
    if fault is not None:
        fault(engine)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # what set-up made lives to the end: keep the collector from walking it in the window
    gc.collect()
    gc.freeze()
    counters = _counters()
    sampler = stepcheck.Sampler(int(cfg["checks"]), seed)
    event_sampler = stepcheck.EventSampler(int(cfg.get("backend_checks", 0)), seed)
    setup_s = time.perf_counter() - t_process
    host = HostProbe()
    first, window_s, spans = window(runner, seconds, traced, sampler, event_sampler)
    host = host.stop()
    counters = {k: v - counters.get(k, 0) for k, v in _counters().items()}
    log_ = runner.scans
    win = range(first, len(log_))
    lat, starts = log_.ms[first:log_.n], log_.start[first:log_.n]
    between = starts[1:] - (starts[:-1] + lat[:-1] / 1e3)
    log(f"window closed: {len(win)} scans ({int(log_.rebuilt[first:log_.n].sum())} rebuilt the "
        f"target) in {window_s:.3f} s; started by second "
        f"{np.bincount((starts - starts[0]).astype(int)).tolist() if len(win) else []}; slowest "
        f"scan {lat.max(initial=0.0):.2f} ms, widest gap between scans "
        f"{1e3 * between.max(initial=0.0):.2f} ms; the host over the window {host}; program "
        f"counters { {k: v for k, v in counters.items() if v} }")
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    failed = int(np.sum(log_.failed[first:log_.n]
                        | ~np.isfinite(log_.pose[first:log_.n]).all(axis=(1, 2))))
    out = {"attempted": len(win), "failed": failed, "memory_peak_bytes": peak,
           "setup_s": setup_s, "window_s": window_s, "latencies_ms": lat.copy()}
    if traced:
        out["record"] = _traced(runner, spans, counters, on_card, window_s)
    else:
        out["end_to_end"] = {"scans_per_s": (len(win) - failed) / window_s,
                             "scan_p95_ms": float(np.percentile(lat, 95)) if len(lat) else math.nan,
                             "setup_s": setup_s}
    sample = [0] + sorted(set(sampler.chosen()) | event_sampler.scans())
    run = stepcheck.Run(cfg, setup.raw, log_, win, sample, _truth(engine, setup),
                        setup.true_world[0], setup.static, setup.prior_map, runner.corrections,
                        event_sampler.chosen())
    if runner.backend:
        log(f"back end: {len(run.corrections)} corrections since the engine started; "
            f"{len(run.events)} of the window's {event_sampler.seen} events chosen for the check")
    refmod = cellmod.load_module("references", cfg["engine"])
    del engine, runner
    clouds = out["record"].pop("clouds", None) if traced else None
    if clouds:
        out["record"]["k2"] = _k2_inputs(run, clouds, refmod, device)
    out["checks"] = stepcheck.compare(run, refmod, device)
    gap, share = stepcheck.truth_gap(run)
    log(f"compared with the reference; against the ground truth (not compared): widest gap "
        f"{gap:.4f} m, {100 * share:.3f}% of the distance travelled")
    if after_check is not None:
        after_check(run, refmod)
    return out


def _counters() -> dict:
    """The program's launch counters (per kernel)."""
    from loc_lib_tpu_torch.ops import kernels

    return dict(kernels.LAUNCHES)


def _traced(runner: Runner, spans: list, counters: dict, on_card: bool, window_s: float) -> dict:
    """The traced run's record: the window's spans, the program's counters
    over it and its seconds a scan (fenced, no profiler), then two profiled
    slices after the window (the profiler makes later launches dearer, so
    nothing is timed after it): the first with CUDA activity only, the
    second with the host's too, which labels the idle gaps."""
    rec = {"spans": spans, "counters": counters, "window_scans": len(spans),
           "s_per_scan": window_s / len(spans) if spans else None}
    if not on_card:
        return rec
    runner.clouds = {}
    rec["slice"] = trace.profile_scans(runner.scan, PROFILED_SCANS, with_cpu=False)
    rec["clouds"], runner.clouds = runner.clouds, None
    rec["labelled"] = trace.profile_scans(lambda: runner.scan(label=True), LABELLED_SCANS,
                                          with_cpu=True)
    print(f"profiled slice: {1e3 * rec['slice'].window_s / rec['slice'].scans:.3f} ms a scan "
          f"against {1e3 * rec['s_per_scan']:.3f} ms in the fenced window without the profiler"
          if spans else "profiled slice taken", file=sys.stderr, flush=True)
    print(f"device events, host ranges' device-side spans apart: slice {len(rec['slice'].events)}"
          f", {len(rec['slice'].annotations)}; labelled slice {len(rec['labelled'].events)}, "
          f"{len(rec['labelled'].annotations)}", file=sys.stderr, flush=True)
    return rec


def _k2_inputs(run: stepcheck.Run, clouds: dict, refmod, device) -> list:
    """Per profiled scan what K2's bytes need: the program's filtered scan,
    the reported pose, and the reference's target it was matched against."""
    ck = stepcheck.Checker(run, refmod, reference.Prec(), device)
    return [{"q": c.xyz, "mask": c.mask, "pose": run.scans[i].pose, "target": ck.target(i)}
            for i, c in clouds.items()]
