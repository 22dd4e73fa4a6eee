"""Split a traced run's device time and idle time by the program's spans
(`raft_tpu_torch.profiling`: `dispatch.*`, `fused.*`, `general.*`).

    python3 -m raft_tpu_torch.tools.span_split TRACE.json [--out SPLIT.json]
    python3 -m raft_tpu_torch.tools.span_split --cell tikv-1m-r3.store-loss \\
        --seed 3000000021 --seconds 10 [--save-trace TRACE.json] [--out SPLIT.json]

The first form reads a Chrome trace that `torch.profiler` exported; the
second runs one cell of the port's benchmark (`portbench`, from the root of
a checkout, on a CUDA card) with its profiled window on, and reads the
trace that window recorded.  Both print one JSON object.

The window is the benchmark's: from the first `block` span's start to the
last `sync` span's end (without those spans, from the first program span's
start to the last one's end).  A `block` span is `block.fused` when a
`fused.kernel` span lies inside it, else `block.general`.  An idle interval
(no device operation running) takes the harness label of the span its
midpoint lies in, as the benchmark's breakdown labels it, and is then split
by the innermost program span open across each part, as `<label>/<span>`;
a part that no program span covers keeps the bare label, so a label's parts
sum to the label's idle.  A device operation counts for the innermost
program span open when the host launched it (the CUDA runtime call with its
correlation id).  Both sit on the host clock that the profiler aligns the
device's records to; `gap_end_skew_us` is, over the operations that end an
idle interval, device start minus host launch: a negative value is a
disagreement of the two clocks, by which the split of that interval is off.

`predicate` counts, over the traced fused blocks, the records of the
dispatcher's predicate kernel (`steady_predicate_kernel`: 1 a block where
it ran, 0 where the PyTorch composition did) and the device operations
launched under `dispatch.predicate`, with their device time a block.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from typing import Dict, List, Tuple

HARNESS = ("traffic", "block", "sync", "bookkeeping")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")

Span = Tuple[str, float, float]  # (name, start us, end us)
PREDICATE_KERNEL = "steady_predicate_kernel"


def read(events: List[dict]):
    """(device ops as (name, start, dur, launch) sorted by start, harness
    spans, program spans), every time in microseconds."""
    launches: Dict[int, float] = {}
    raw, harness, program = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            raw.append(e)
        elif cat in HOST_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
        elif cat == "user_annotation":
            ts = float(e["ts"])
            span = (e["name"], ts, ts + float(e.get("dur", 0.0)))
            (harness if e["name"] in HARNESS else program).append(span)
    ops = []
    for e in raw:
        ts = float(e["ts"])
        ops.append((e["name"], ts, float(e.get("dur", 0.0)),
                    launches.get(e.get("args", {}).get("correlation"), ts)))
    ops.sort(key=lambda o: o[1])
    harness.sort(key=lambda s: s[1])
    program.sort(key=lambda s: (s[1], -s[2]))
    return ops, harness, program


def label_blocks(harness: List[Span], program: List[Span]) -> List[Span]:
    """The harness spans, each `block` named `block.fused` or `block.general`
    by the program spans inside it."""
    kernels = sorted(s[1] for s in program if s[0] == "fused.kernel")
    rounds = sorted(s[1] for s in program if s[0] == "general.round")

    def inside(starts, a, b):
        i = bisect.bisect_left(starts, a)
        return i < len(starts) and starts[i] <= b

    out = []
    for name, a, b in harness:
        if name == "block":
            name = ("block.fused" if inside(kernels, a, b)
                    else "block.general" if inside(rounds, a, b) else "block")
        out.append((name, a, b))
    return out


class _Innermost:
    """Walks the time axis forward, keeping the stack of program spans open
    at the current time (record_function ranges of one thread nest)."""

    def __init__(self, program: List[Span]):
        ev = [(a, 1, i) for i, (_, a, _) in enumerate(program)]
        ev += [(b, 0, i) for i, (_, _, b) in enumerate(program)]
        self.events = sorted(ev)  # at one time, ends before starts
        self.program = program
        self.pos = 0
        self.stack: List[int] = []

    def _apply(self, kind: int, i: int) -> None:
        if kind:
            self.stack.append(i)
        elif self.stack and self.stack[-1] == i:
            self.stack.pop()
        elif i in self.stack:
            self.stack.remove(i)

    def top(self):
        return self.program[self.stack[-1]][0] if self.stack else None

    def advance(self, t: float) -> None:
        """Apply every boundary at or before t."""
        while self.pos < len(self.events) and self.events[self.pos][0] <= t:
            self._apply(*self.events[self.pos][1:])
            self.pos += 1

    def split(self, a: float, b: float) -> List[Tuple[str, float]]:
        """[a, b] (a at or after the last time advanced to) as parts
        (innermost span or None, us), advancing to b."""
        self.advance(a)
        parts, cur = [], a
        while self.pos < len(self.events) and self.events[self.pos][0] < b:
            t, kind, i = self.events[self.pos]
            if t > cur:
                parts.append((self.top(), t - cur))
                cur = t
            self._apply(kind, i)
            self.pos += 1
        parts.append((self.top(), b - cur))
        return parts


def split(events: List[dict]) -> dict:
    ops, harness, program = read(events)
    labelled = label_blocks(harness, program)
    blocks = [s for s in labelled if s[0].startswith("block")]
    syncs = [s for s in labelled if s[0] == "sync"]
    if blocks and syncs:
        lo, hi = blocks[0][1], syncs[-1][2]
    elif program:
        lo, hi = program[0][1], max(s[2] for s in program)
    else:
        raise ValueError("the trace holds neither the benchmark's spans nor the program's")
    inside = [o for o in ops if lo <= o[1] <= hi]

    # Idle intervals, each with the operation that ends it (None: the window's end).
    gaps, end = [], lo
    for o in inside:
        if o[1] > end:
            gaps.append((end, o[1], o))
        end = max(end, o[1] + o[2])
    if hi > end:
        gaps.append((end, hi, None))

    starts = [s[1] for s in labelled]

    def harness_label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        return labelled[i][0] if i >= 0 and labelled[i][2] >= t else "host"

    by_label: Dict[str, float] = {}
    refined: Dict[str, float] = {}
    by_span: Dict[str, Dict[str, float]] = {}

    def row(label: str, span) -> Dict[str, float]:
        key = f"{label}/{span or '-'}"
        return by_span.setdefault(key, {"device_ms": 0.0, "launches": 0, "idle_ms": 0.0})

    walk = _Innermost(program)
    skews = []
    for a, b, o in gaps:
        label = harness_label((a + b) / 2)
        by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e6
        for span, us in walk.split(a, b):
            key = f"{label}/{span}" if span else label
            refined[key] = refined.get(key, 0.0) + us / 1e6
            row(label, span)["idle_ms"] += us / 1e3
        if o is not None:
            skews.append(o[1] - o[3])

    walk = _Innermost(program)
    for name, start, dur, launch in sorted(inside, key=lambda o: o[3]):
        walk.advance(launch)
        r = row(harness_label(launch), walk.top())
        r["device_ms"] += dur / 1e3
        r["launches"] += 1

    # By host launch alone: an operation that the device clock puts a few us
    # before its block's span still belongs to the block.
    fused = [s for s in blocks if s[0] == "block.fused"]
    fused_starts = [s[1] for s in fused]
    pred = [{"kernel_records": 0, "launches": 0, "device_ms": 0.0} for _ in fused]
    walk = _Innermost(program)
    for name, start, dur, launch in sorted(ops, key=lambda o: o[3]):
        walk.advance(launch)
        i = bisect.bisect_right(fused_starts, launch) - 1
        if i < 0 or fused[i][2] < launch:
            continue
        pred[i]["kernel_records"] += PREDICATE_KERNEL in name
        if walk.top() == "dispatch.predicate":
            pred[i]["launches"] += 1
            pred[i]["device_ms"] += dur / 1e3

    diff = 0.0
    for label, total in by_label.items():
        parts = sum(v for k, v in refined.items() if k == label or k.startswith(label + "/"))
        diff = max(diff, abs(parts - total))
    rounds = sorted(s[1] for s in program if s[0] == "general.round")
    kinds: Dict[str, Dict[str, float]] = {}
    for name, a, b in blocks:
        k = kinds.setdefault(name, {"n": 0, "ms": 0.0, "rounds": 0})
        k["n"] += 1
        k["ms"] += (b - a) / 1e3
        k["rounds"] += bisect.bisect_right(rounds, b) - bisect.bisect_left(rounds, a)
    busy = sum(o[2] for o in inside)
    return {
        "window_s": (hi - lo) / 1e6,
        "device_ops": len(inside),
        "device_s_summed": busy / 1e6,
        "blocks": kinds,
        "idle_by_label_s": by_label,
        "idle_refined_s": dict(sorted(refined.items(), key=lambda kv: -kv[1])),
        "refined_sum_max_abs_diff_s": diff,
        "by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1]["idle_ms"])),
        "predicate": {
            "fused_blocks": len(pred),
            **{f"{key}_{agg.__name__}": agg(b[key] for b in pred) if pred else None
               for key in ("kernel_records", "launches") for agg in (min, max)},
            "device_ms_mean": statistics.mean(b["device_ms"] for b in pred) if pred else None,
        },
        "gap_end_skew_us": {
            "min": min(skews) if skews else None,
            "median": statistics.median(skews) if skews else None,
            "negative": sum(s < 0 for s in skews),
            "n": len(skews),
        },
    }


def run_cell(cell: str, seed: int, seconds: float, save: str) -> List[dict]:
    """The Chrome trace events of one traced run of a benchmark cell, the
    trace also written to `save` when given; the cell's result line goes
    to standard error."""
    import os
    import tempfile
    import time

    from portbench import harness, trace

    got: List[List[dict]] = []

    class Keep(trace.Tracer):
        """The benchmark's tracer, keeping the events it reads (a profile
        exports its trace once)."""

        def view(self, block_labels):
            if self._prof is None:
                return None
            path = save
            if not save:
                fd, path = tempfile.mkstemp(suffix=".json")
                os.close(fd)
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                got.append(json.load(f)["traceEvents"])
            if not save:
                os.unlink(path)
            self._prof = None
            return trace.read_events(got[0], block_labels)

    harness.Tracer = Keep
    result = harness.run_cell(cell, seed, seconds, True, t0=time.perf_counter())
    print(json.dumps(result), file=sys.stderr, flush=True)
    if not got:
        raise RuntimeError("the run recorded no trace")
    return got[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m raft_tpu_torch.tools.span_split")
    ap.add_argument("trace", nargs="?", help="a Chrome trace that torch.profiler exported")
    ap.add_argument("--cell", help="run this benchmark cell traced instead")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--save-trace", default="", help="with --cell, keep its trace here")
    ap.add_argument("--out", default="", help="also write the split here")
    args = ap.parse_args(argv)
    if bool(args.trace) == bool(args.cell):
        ap.error("give a trace file or --cell")
    if args.cell:
        events = run_cell(args.cell, args.seed, args.seconds, args.save_trace)
    else:
        with open(args.trace) as f:
            events = json.load(f)["traceEvents"]
    out = split(events)
    if args.cell:
        out = {"cell": args.cell, "seed": args.seed, **out}
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
