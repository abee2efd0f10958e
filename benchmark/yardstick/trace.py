"""Reading the device from `torch.profiler` over a bounded slice of scans:
the device's events, the union of their intervals (busy time: overlapping
kernels and copies count once), the longest idle gaps labelled by what the
host was doing, and the operations that took most time."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np
import torch

SESSIONS = 3           # a session that hands back no device event is repeated


class Slice(NamedTuple):
    scans: int
    window_s: float                  # host clock over the slice, fenced at both ends
    events: list                     # (name, start_us, end_us) of every kernel, copy and memset
    cpu: list                        # (name, start_us, end_us) of host events (labelled slices)
    # (name, start_us, end_us) of the device-side spans of the host's ranges
    # (`gpu_user_annotation`: first to last kernel of a range), which are no device work
    annotations: list = ()


def union_s(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-6


def gaps(intervals) -> list:
    """(start_us, end_us) of the idle gaps between the union's pieces."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def profile_scans(run_scan: Callable[[], None], scans: int, with_cpu: bool) -> Slice:
    """Run `run_scan` `scans` times under the profiler (CUDA activity only,
    or with the host's too for labelling gaps). A session whose buffers come
    back without a device event is repeated, up to SESSIONS times; then the
    slice has no events, and what reads it finds nothing. The device-side
    spans of the host's ranges are kept apart from the device's work."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_cpu else [])
    for _ in range(SESSIONS):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(scans):
                run_scan()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        dev, cpu, notes = split_events(prof.events())
        if dev:
            return Slice(scans, window, dev, cpu, notes)
    return Slice(scans, window, [], [])


def split_events(events) -> tuple:
    """The profiler's events as (name, start_us, end_us) rows: (the device's
    work, the host's events, the device-side spans of the host's ranges)."""
    dev, cpu, notes = [], [], []
    for e in events:
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            cpu.append(row)
        else:
            (notes if getattr(e, "is_user_annotation", False) else dev).append(row)
    return dev, cpu, notes


def device_ops(sl: Slice, top: int = 10) -> list:
    """[name, seconds] of the device operations that took most time."""
    by = defaultdict(float)
    for name, s, e in sl.events:
        by[name] += (e - s) * 1e-6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(sl: Slice, top: int = 10) -> list:
    """[label, seconds] of the idle time between kernels, copies and memsets
    (the host ranges' device-side spans are no work, and cover most of the
    gaps), summed by what the host was doing at each gap's middle: the
    harness stage ("bench.*" spans) and the innermost host operation
    running."""
    dev = [(s, e) for _, s, e in sl.events]
    stages = [c for c in sl.cpu if c[0].startswith("bench.")]
    ops = [c for c in sl.cpu if not c[0].startswith("bench.")]
    names = [n for n, _, _ in ops]
    a = np.array([s for _, s, _ in ops] or [0.0])
    b = np.array([e for _, _, e in ops] or [-1.0])
    by = defaultdict(float)
    for s, e in gaps(dev):
        mid = 0.5 * (s + e)
        stage = next((n for n, lo, hi in stages if lo <= mid <= hi), "between scans")
        inside = np.nonzero((a <= mid) & (b >= mid))[0]
        label = stage
        if inside.size:
            label += " / " + names[inside[np.argmin(b[inside] - a[inside])]]
        by[label] += (e - s) * 1e-6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]
