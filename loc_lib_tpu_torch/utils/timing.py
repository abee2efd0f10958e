"""Timing and profiling instruments (port of loc_lib_tpu/utils/timing.py).

  * `TicToc`: wall-clock stopwatch returning milliseconds (the reference's
    tic_toc.hpp).
  * `evaluate_and_call`: N-run average micro-benchmark logger (the
    reference's sys_utils.h).
  * `StageTimer`: per-stage ms accumulator for the apps' replay loops.
  * `trace`: `torch.profiler` over a block, or a named range inside an
    enclosing profile.

CUDA work is asynchronous: a stopwatch that is not fenced measures the
host's enqueue. Where a caller passes `block_on` (a tensor, or a tree of
tensors and NamedTuples), the card that holds it is synchronized before the
clock is read; without it a time is host time.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Optional

import torch

log = logging.getLogger("loc_lib_tpu_torch")


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _cuda_devices(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _cuda_devices(x, out)
    return out


def block_until_ready(tree):
    """Wait for every card that holds a tensor of `tree` (the counterpart
    of `jax.block_until_ready`); CPU tensors are ready when returned.
    Returns `tree`."""
    for dev in _cuda_devices(tree, set()):
        torch.cuda.synchronize(dev)
    return tree


class TicToc:
    """Stopwatch in milliseconds; `toc()` restarts."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, block_on=None) -> float:
        if block_on is not None:
            block_until_ready(block_on)
        ms = (time.perf_counter() - self._t0) * 1e3
        self.tic()
        return ms


def evaluate_and_call(func: Callable, name: str = "method", times: int = 10,
                      warmup: int = 1) -> float:
    """Average ms per call over `times` runs, with warm-up runs excluded and
    the device fenced on the last result. Returns the mean ms and logs it
    like the reference."""
    for _ in range(warmup):
        block_until_ready(func())
    t0 = time.perf_counter()
    out = None
    for _ in range(times):
        out = func()
    block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1e3 / max(times, 1)
    log.info("方法 %s 平均调用时间/次数: %.5f/%d 毫秒.", name, ms, times)
    return ms


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = "loc_lib_tpu_torch"):
    """Structured device tracing: `with trace('/tmp/prof'):` records a
    `torch.profiler` session (CPU and, where there is a card, CUDA
    activity) and writes its Chrome trace to `<log_dir>/<name>.json`; with
    no log_dir it is a cheap named range (`record_function`) that shows up
    inside an enclosing profile."""
    if log_dir is None:
        with torch.profiler.record_function(name):
            yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(name):
            yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


class StageTimer:
    """Per-stage ms accumulator for pipeline drivers. Usage:

        st = StageTimer()
        with st.stage("match"): ...
        st.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            ms = (time.perf_counter() - t0) * 1e3
            self.totals[name] = self.totals.get(name, 0.0) + ms
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> dict[str, float]:
        out = {k: self.mean_ms(k) for k in self.totals}
        for k, v in sorted(out.items()):
            log.info("stage %-20s %8.3f ms/call x%d", k, v, self.counts[k])
        return out
