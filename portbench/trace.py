"""The traced run's profiler: `torch.profiler` over a bounded sub-window,
read back from its Chrome trace.

The harness marks its own spans with `record_function`: `traffic` (the
block's inputs and a fleet restart), `block` (the dispatcher's call),
`sync` (the host waiting for the block's outputs) and `bookkeeping` (the
recovery marks after a block).  Each block ends in a synchronisation, so
a device operation belongs to block i when the host call that launched it
(the CUDA runtime or driver call with the same correlation id) lies
between the start of block i's `block` span and the end of its `sync`
span: both are on the host's clock, so no skew between the host's and the
device's clocks can move an operation into a neighbouring block.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

SPANS = ("traffic", "block", "sync", "bookkeeping")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


class Op(NamedTuple):
    name: str
    start: float  # us, on the device
    dur: float  # us
    launch: float  # us, the host call that launched it (start if unknown)


class TraceView(NamedTuple):
    blocks: List[List[Op]]  # device operations of each traced block
    ops: List[Op]
    spans: List[Tuple[str, float, float]]  # (label, start us, end us)
    busy_s: float
    window_s: float
    start: float  # us, the first block's call


class Tracer:
    """`start()` opens the profiler and `stop()` closes it; outside them
    every span is a no-op.  `view(labels)` reads the trace back."""

    def __init__(self):
        self.active = False
        self._prof = None

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.active = True

    def stop(self) -> None:
        if self.active:
            self._prof.__exit__(None, None, None)
            self.active = False

    def view(self, block_labels: List[str]) -> Optional[TraceView]:
        """The trace's device operations and the harness's spans; the i-th
        `block` span is relabelled block_labels[i]."""
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return read_events(events, block_labels)


def read_events(events: List[dict], block_labels: List[str]) -> TraceView:
    raw: List[dict] = []
    launches: Dict[int, float] = {}
    spans: Dict[str, List[Tuple[float, float]]] = {s: [] for s in SPANS}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            raw.append(e)
        elif cat in HOST_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat == "user_annotation" and e.get("name") in spans:
            ts = float(e["ts"])
            spans[e["name"]].append((ts, ts + float(e.get("dur", 0.0))))
    ops = []
    for e in raw:
        ts = float(e["ts"])
        host = launches.get(e.get("args", {}).get("correlation"), ts)
        ops.append(Op(e["name"], ts, float(e.get("dur", 0.0)), host))
    ops.sort(key=lambda o: o.start)
    for v in spans.values():
        v.sort()
    blocks, syncs = spans["block"], spans["sync"]
    n = min(len(blocks), len(syncs), len(block_labels))
    per_block: List[List[Op]] = [[] for _ in range(n)]
    starts = [b[0] for b in blocks[:n]]
    for o in ops:
        i = bisect.bisect_right(starts, o.launch) - 1
        if i >= 0 and o.launch <= syncs[i][1]:
            per_block[i].append(o)
    labelled = [(block_labels[i], *blocks[i]) for i in range(n)]
    for s in ("traffic", "sync", "bookkeeping"):
        labelled += [(s, a, b) for a, b in spans[s]]
    labelled.sort(key=lambda x: x[1])
    if n:
        lo, hi = blocks[0][0], syncs[n - 1][1]
    else:
        lo = hi = 0.0
    inside = [o for o in ops if lo <= o.start <= hi]
    busy = _union(inside, lo, hi)
    return TraceView(per_block, inside, labelled, busy / 1e6, (hi - lo) / 1e6, lo)


def _union(ops: List[Op], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some operation runs."""
    total, end = 0.0, lo
    for o in ops:
        a, b = max(o.start, end), min(o.start + o.dur, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(view: TraceView) -> List[Tuple[float, float]]:
    """(start us, end us) of each interval of the traced window with no
    device operation running."""
    if not view.blocks:
        return []
    lo = view.start
    hi = lo + view.window_s * 1e6
    gaps, end = [], lo
    for o in view.ops:
        if o.start > end:
            gaps.append((end, o.start))
        end = max(end, o.start + o.dur)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time (seconds, summed by
    name) and the idle time by the harness span the host was in."""
    by_name: Dict[str, float] = {}
    for o in view.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + o.dur / 1e6
    idle: Dict[str, float] = {}
    starts = [s[1] for s in view.spans]
    for a, b in idle_gaps(view):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = view.spans[i][0] if i >= 0 and view.spans[i][2] >= mid else "host"
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": [[n[:160], s] for n, s in rank(by_name)],
            "idle_gaps": [[n, s] for n, s in rank(idle)]}
