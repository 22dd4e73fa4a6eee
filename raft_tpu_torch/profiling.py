"""Profiling hooks, counterpart of `raft_tpu/profiling.py`: device traces
over `torch.profiler` (the CPU activity and, on a card, the CUDA kernels),
exported as a Chrome/Perfetto trace, and a host wall-clock round timer.

Usage:

    from raft_tpu_torch.profiling import device_trace, RoundTimer

    with device_trace("/tmp/raft-trace"):      # trace.json, for Perfetto
        sim.run(100, crashed, append)

    timer = RoundTimer()
    with timer.round():
        state = step(cfg, state, crashed, append)
        torch.cuda.synchronize()
    print(timer.summary())

The profiler drops kernel records over a long process on the card, so a
trace should bracket one short region (`bench --profile` brackets one
mode's timed loop).
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, List, Optional

import torch

TRACE_FILE = "trace.json"

_active: Optional[tuple] = None  # (profiler, log_dir) of the running trace


def start_trace(log_dir: str, host_profiler: bool = False) -> None:
    """Begin a torch.profiler trace that `stop_trace` writes into
    `log_dir`/trace.json: CPU activity always, CUDA activity when a card is
    available.  `host_profiler` also records each op's Python stack.

    The imperative twin of `device_trace` for callers whose start and stop
    points do not nest lexically.  Must be paired with `stop_trace`; traces
    do not nest."""
    global _active
    if _active is not None:
        raise RuntimeError("a trace is already running; traces do not nest")
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, with_stack=host_profiler)
    prof.__enter__()
    _active = (prof, log_dir)


def stop_trace() -> str:
    """End the trace started by `start_trace`, write it to disk and return
    the trace file's path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is running")
    prof, log_dir = _active
    _active = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def device_trace(log_dir: str, host_profiler: bool = False):
    """Trace everything inside the block into `log_dir`/trace.json; view it
    with ui.perfetto.dev or chrome://tracing."""
    start_trace(log_dir, host_profiler=host_profiler)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named region inside a trace (shows up on the host timeline)."""
    return torch.profiler.record_function(name)


class RoundTimer:
    """Lightweight wall-clock histogram for protocol rounds — the host-side
    equivalent of the reference's Criterion loops."""

    def __init__(self) -> None:
        self.samples: List[float] = []

    @contextlib.contextmanager
    def round(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples.append(time.perf_counter() - t0)

    @staticmethod
    def _percentile(xs: List[float], q: float) -> float:
        """Nearest-rank percentile (the smallest sample with at least q of
        the distribution at or below it): xs sorted, 0 < q <= 1."""
        return xs[math.ceil(q * len(xs)) - 1]

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0}
        xs = sorted(self.samples)
        n = len(xs)
        return {
            "count": n,
            "mean_ms": sum(xs) / n * 1e3,
            "p50_ms": self._percentile(xs, 0.50) * 1e3,
            "p90_ms": self._percentile(xs, 0.90) * 1e3,
            "p99_ms": self._percentile(xs, 0.99) * 1e3,
            "max_ms": xs[-1] * 1e3,
        }
