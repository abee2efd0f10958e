"""Timing and profiling instruments (port of loc_lib_tpu/utils/timing.py).

  * `COUNTERS`: the program's one counter store: the kernels' launch counts
    (`ops.kernels.LAUNCHES` is this dict) and every span's totals.
  * `span`: a named stretch of the host's time. It adds its nanoseconds and
    one call to `COUNTERS["<name>.ns"]` and `COUNTERS["<name>.calls"]`, and
    while a profiler records, it opens a `torch.profiler.record_function`
    range of that name, stamped on the profiler's clock beside the card's
    kernels and copies.
  * `count`: one more of a named event in `COUNTERS` (the LIO map build's
    `map_build.captures` and `map_build.replays`).
  * `host_bool`, `host_numpy`: the program's blocking reads of the device,
    each inside a `sync` span, so `sync.calls` counts the host's waits on
    the card and `sync.ns` their time.
  * `TicToc`: wall-clock stopwatch returning milliseconds (the reference's
    tic_toc.hpp).
  * `evaluate_and_call`: N-run average micro-benchmark logger (the
    reference's sys_utils.h).
  * `StageTimer`: the apps' stages as spans, and the mean of every span
    since the timer was made.

CUDA work is asynchronous: a stopwatch that is not fenced measures the
host's enqueue. Where a caller passes `block_on` (a tensor, or a tree of
tensors and NamedTuples), the card that holds it is synchronized before the
clock is read; without it a time is host time. A span is host time: the
work it enqueues may run on the card after it closes, and a span that
holds a `sync` holds the wait for what came before.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable

import numpy as np
import torch
from torch.autograd import profiler as _profiler

log = logging.getLogger("loc_lib_tpu_torch")

COUNTERS: dict = {}
SYNC = "sync"

_KEYS: dict = {}       # span name -> (its ".ns" key, its ".calls" key)


class span:
    """`with span(name):` adds the block's host nanoseconds to
    `COUNTERS[name + ".ns"]` and one to `COUNTERS[name + ".calls"]`. Spans
    nest; each counts its whole block. While a profiler records, the block
    is also a `record_function(name)` range, with `args` (the engine's frame
    index on a step) as its arguments; with none recording, no range is
    entered, so a span costs two clock reads and two dict updates."""

    __slots__ = ("name", "args", "_t0", "_range")

    def __init__(self, name: str, args=None):
        self.name, self.args = name, args

    def __enter__(self):
        self._range = None
        if _profiler._is_profiler_enabled:
            args = None if self.args is None else str(self.args)
            self._range = torch.profiler.record_function(self.name, args)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        keys = _KEYS.get(self.name)
        if keys is None:
            keys = _KEYS[self.name] = (self.name + ".ns", self.name + ".calls")
        COUNTERS[keys[0]] = COUNTERS.get(keys[0], 0) + ns
        COUNTERS[keys[1]] = COUNTERS.get(keys[1], 0) + 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def count(name: str) -> None:
    """Add one to `COUNTERS[name]`."""
    COUNTERS[name] = COUNTERS.get(name, 0) + 1


def host_bool(x) -> bool:
    """`bool(x)` of a device flag: one blocking read, counted as a `sync`."""
    with span(SYNC):
        return bool(x)


def host_numpy(x: torch.Tensor) -> np.ndarray:
    """`x` copied to the host as a numpy array: one blocking read, counted
    as a `sync`."""
    with span(SYNC):
        return x.cpu().numpy()


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


class StageTimer:
    """The apps' stages as spans. Usage:

        st = StageTimer()
        with st.stage("match"): ...
        st.report()

    `report()` gives the mean ms of every span closed since the timer was
    made, the program's own (`step`, `match`, `sync`, ...) among them."""

    def __init__(self):
        self._start = dict(COUNTERS)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """A span of `name`; with `block_on` the card is synchronized
        before the span closes."""
        with span(name):
            try:
                yield
            finally:
                if block_on is not None:
                    block_until_ready(block_on)

    def _since(self, suffix: str) -> dict:
        out = {}
        for k, v in list(COUNTERS.items()):
            if k.endswith(suffix) and v != self._start.get(k, 0):
                out[k[:-len(suffix)]] = v - self._start.get(k, 0)
        return out

    @property
    def counts(self) -> dict:
        """Calls of each span since the timer was made."""
        return self._since(".calls")

    @property
    def totals(self) -> dict:
        """Milliseconds of each span since the timer was made."""
        return {k: ns * 1e-6 for k, ns in self._since(".ns").items()}

    def mean_ms(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> dict:
        totals, counts = self.totals, self.counts
        out = {k: totals.get(k, 0.0) / n for k, n in counts.items()}
        for k, v in sorted(out.items()):
            log.info("stage %-20s %8.3f ms/call x%d", k, v, counts[k])
        return out
