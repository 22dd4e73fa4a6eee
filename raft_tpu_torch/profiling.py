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

Inside a trace the program marks its layers with `annotate` and, in a
`phased` function, `phases` (the dispatcher's `dispatch.*`, the fused
wrappers' `fused.*`, the general round's `general.*`); with no profiler
recording, or inside `muted()`, each mark is a shared no-op.

The profiler drops kernel records over a long process on the card, so a
trace should bracket one short region (`bench --profile` brackets one
mode's timed loop).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import threading
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


class _Quiet:
    """What `annotate` and `phases` return with no profiler recording: a
    context that does nothing and a phase sequence whose marks do nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, name: str) -> None:
        pass


QUIET = _Quiet()
_muted = False  # inside `muted()`


def annotate(name: str):
    """Named region inside a trace (shows up on the host timeline): a
    `record_function` range while a profiler records, else QUIET.  It only
    marks the host's timeline, on the clock the profiler aligns the device's
    records to: it launches no device work, never synchronises, allocates no
    tensor and changes no value."""
    if torch.autograd._profiler_enabled() and not _muted:
        return torch.profiler.record_function(name)
    return QUIET


@contextlib.contextmanager
def muted():
    """No span inside, a profiler recording or not: for a profile that
    reads the host's own pace, which each span would lengthen by its cost
    under the profiler (tens of microseconds beside CUDA work)."""
    global _muted
    was, _muted = _muted, True
    try:
        yield
    finally:
        _muted = was


class _Phases:
    """Straight-line phases of one call, each a `record_function` range:
    `ph(name)` closes the open phase and opens the next."""

    def __init__(self) -> None:
        self._open = None

    def __call__(self, name: str) -> None:
        self.end()
        self._open = torch.profiler.record_function(name)
        self._open.__enter__()

    def end(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


class _Calls(threading.local):
    def __init__(self) -> None:
        self.stack: List[_Phases] = []  # the running `phased` calls' sequences


_calls = _Calls()


def phased(fn):
    """Decorator for a function whose body marks its straight-line phases
    with `ph = phases()`, then `ph(name)` at each phase's start, so that a
    phase boundary is one line.  While a profiler records, each call gets
    its own sequence, and the phase still open when the call returns or
    raises is closed then; otherwise the call runs as it is."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not torch.autograd._profiler_enabled() or _muted:
            return fn(*args, **kwargs)
        stack = _calls.stack
        stack.append(_Phases())
        try:
            return fn(*args, **kwargs)
        finally:
            stack.pop().end()

    return run


def phases():
    """The phase sequence of the innermost running `phased` call that began
    while a profiler recorded, else (and inside `muted()`) QUIET; the same
    guarantees as `annotate`."""
    stack = _calls.stack
    return stack[-1] if stack and not _muted else QUIET


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
