"""Tracing and timing helpers (counterpart of f3d_gaus_tpu/utils/
profiling.py).

The reference times iterations with paired CUDA events
(src/gaussian-splatting/train.py:44-95).  Here: `trace` captures a
torch.profiler trace of the host and the card (a Chrome trace, readable in
Perfetto or chrome://tracing), `timed` is a wall clock that waits for the
card before reading either end, and `StepTimer` the EMA iteration clock of
the JAX package's train loops.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the CPU and, where a card is
    present, the CUDA activity inside the block; writes it to
    `logdir`/trace.json (Chrome trace format).  Yields the profiler, whose
    key_averages() the caller may read after the block."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(out):
    """Wait for every CUDA device that holds a tensor of `out` (nested
    tuples, lists and dicts)."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(out)
    for d in devices:
        torch.cuda.synchronize(d)


def timed(fn, *args, iters: int = 10, warmup: int = 1, **kw):
    """Wall-clock `fn(*args, **kw)`: `warmup` calls, then the mean seconds
    of `iters` calls, waiting for the outputs' card before each clock
    read.  Returns (mean_s, out), out from the last call."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    _sync(out)
    return (time.perf_counter() - t0) / iters, out


class StepTimer:
    """EMA per-iteration timer for training loops (the iter_time scalar of
    the reference's tensorboard report, train.py:160)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._last = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else \
                (1 - self.alpha) * self.ema + self.alpha * dt
        self._last = now
        return self.ema or 0.0
