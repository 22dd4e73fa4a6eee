"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics and the result line.

Set-up builds or loads the fused kernel, makes the fleet's state and the
traffic from the seed on the device, settles the fleet through the
program's general round until the dispatcher's whole-batch predicate
holds, and runs one block on the settled state (discarded) to warm the
fused kernel.  The window then drives the program's dispatcher, a block of
k rounds a call, each block's outputs synchronised on the host before the
next is issued (a host acknowledging each block's commits).  The window
lasts at least `seconds` and closes at the first end of a traffic period
after that (a block without faults, a fault's or conf-change kind's period
with them), so that every run measures whole periods.  In traffic with conf
changes each block's requests go to the program's block.
"""

from __future__ import annotations

import gc
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, spec, stats
from .generator import Traffic
from .reference import confchange as C
from .trace import Tracer, breakdown

SETTLE_CHECK_EVERY = 8
SETTLE_MAX_ROUNDS = 1024
# Blocks of each branch (fused, general) whose states the check keeps.
SAMPLED_BLOCKS = 3
# Blocks the profiler traces in a traffic without faults; with faults it
# traces the first period.
TRACE_BLOCKS = 64
BANNED_MODULES = ("jax", "jaxlib", "flax", "raft_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def banned_modules() -> List[str]:
    """Top-level names in sys.modules that the benchmark must not load:
    JAX, its libraries and the JAX package (compared whole: the program
    under test, raft_tpu_torch, starts with the JAX package's name)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED_MODULES))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Sampler:
    """A uniform sample, drawn from the seed, of each branch's blocks:
    reservoirs of `size` (input state, output state, inputs)."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([seed, 2])
        self.size = size
        self.seen = {True: 0, False: 0}
        self.kept: Dict[bool, list] = {True: [], False: []}

    def offer(self, fused: bool, item: tuple) -> None:
        self.seen[fused] += 1
        kept = self.kept[fused]
        if len(kept) < self.size:
            kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen[fused]))
            if j < self.size:
                kept[j] = item


def splice(st, fresh, groups: torch.Tensor):
    """`st` with the groups marked in `groups` (bool[G]) taken from `fresh`."""
    return type(st)(*(None if a is None else torch.where(groups, b, a)
                      for a, b in zip(st, fresh)))


def _check_records(view, traced, kernel: str) -> None:
    """The profiler keeps every record of the sub-window: one fused-kernel
    record in each fused block and none in a general one, else the run
    fails rather than report."""
    counts = [sum(kernel in o.name for o in ops) for ops in view.blocks]
    bad = [b.index for b, n in zip(traced, counts) if n != int(b.fused)]
    if len(view.blocks) != len(traced) or bad:
        raise RuntimeError(
            f"the trace's {kernel} records do not match the dispatcher's fused "
            f"blocks: {len(view.blocks)} traced blocks of {len(traced)}, "
            f"blocks {bad[:8]} off, with {[counts[i] for i in bad[:8]]} records")


def _check(conf, device, traffic, start, end, settle_append, settle_rounds, kept,
           table_blocks, conf_entries):
    """The numbers that decide `correct`, each with its limit, and the
    checked blocks that failed; see check.py."""
    rc = check.ref_config(conf)
    k = conf["block_rounds"]
    with_cc = traffic.confchanges is not None
    checks = {"settle_mismatch": (
        check.settle_check(rc, start, settle_append, settle_rounds, device, conf), 0)}
    block_bad = guar_bad = failed = 0
    for pre, post, crashed, append, req in kept:
        bad, viol = check.block_check(rc, pre, post, crashed, append, k, req, with_cc)
        block_bad += bad
        guar_bad += viol
        failed += int(bad > 0 or viol > 0)
    # With conf changes, the groups that started no chain in the window
    # kept their masks since set-up: every commit was made under them.
    guar_bad += check.guarantee_violations(end, None if traffic.resets else start,
                                           (conf_entries == 0) if with_cc else None)
    checks["block_mismatch"] = (block_bad, 0)
    checks["guarantee_violations"] = (guar_bad, 0)
    checks["blocks_unchecked"] = (int(not kept), 0)
    if traffic.faults is None:
        expected = torch.zeros((conf["n_groups"],), dtype=torch.int64, device=device)
        for e, n in enumerate(table_blocks):
            if n:
                expected += k * n * traffic.tables[e].to(torch.int64)
        if with_cc:
            checks["entries_gap"] = (
                check.entries_gap_members(start, end, expected + conf_entries), 0)
        else:
            checks["entries_gap"] = (check.entries_gap(start, end, expected), 0)
    return checks, failed


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, root: Path = spec.ROOT, device=None,
             system: Optional[Callable] = None, n_groups: Optional[int] = None,
             sampled_blocks: int = SAMPLED_BLOCKS) -> dict:
    """Run the cell `workload` once; returns the result line's object.
    `system(conf, device)` builds the system under test (by default the
    configuration's, systems/<system>.py); `n_groups` shrinks the fleet,
    and a large `sampled_blocks` checks every block, for tests on the CPU."""
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    conf = spec.config(bench, cell["config"], root)
    if n_groups is not None:
        conf = dict(conf, n_groups=n_groups)
    tspec = spec.traffic(cell["traffic"], Path(root) / "portbench")
    device = torch.device("cuda" if device is None else device)
    G, P, k = conf["n_groups"], conf["n_peers"], conf["block_rounds"]
    phases: Dict[str, float] = {}

    def phase(name, t):
        phases[name] = time.perf_counter() - t
        return time.perf_counter()

    # ---- set-up
    t = time.perf_counter()
    if system is None:
        system = spec.module(Path(root) / "portbench", "systems", conf["system"]).Program
    sut = system(conf, device)
    t = phase("load", t)
    sut.prepare()
    t = phase("build", t)
    traffic = Traffic(tspec, G, P, k, seed, device, package=Path(root) / "portbench")
    st = sut.init_state()
    _sync(device)
    t = phase("state", t)
    settle_in = traffic.block(0)
    none = traffic.none
    settle_rounds = 0
    while True:
        for _ in range(SETTLE_CHECK_EVERY):
            st = sut.step(st, none, settle_in.append)
        settle_rounds += SETTLE_CHECK_EVERY
        if sut.steady(st, none):
            break
        if settle_rounds >= SETTLE_MAX_ROUNDS:
            raise RuntimeError(f"the fleet did not settle in {settle_rounds} rounds")
    _sync(device)
    t = phase("settle", t)
    warm, _ = sut.block(st, none, settle_in.append, 0)
    _sync(device)
    del warm
    phase("warm", t)
    log(f"set-up: {G} groups x {P} peers, k = {k}; settled in {settle_rounds} rounds; "
        + ", ".join(f"{n} {v:.3f} s" for n, v in phases.items()))

    # ---- the window
    tracer = Tracer()
    traced_rounds = traffic.period if traffic.faults else TRACE_BLOCKS * k
    sampler = Sampler(seed, sampled_blocks)
    blocks: List[stats.BlockRecord] = []
    incidents: List[stats.Incident] = []
    table_blocks = [0] * traffic.tables.shape[0]
    # Conf-change traffic: each block's requests go to the program, and
    # the conf entries the window's chains log are counted from them.
    with_cc = traffic.confchanges is not None
    conf_entries = torch.zeros((G,), dtype=torch.int64, device=device) if with_cc else None
    start_state = st
    fused = 0
    round_no = 0
    prev_crashed = none
    pre = st
    overlapped = 0  # incidents not yet over when the next one began
    # The collector's pauses would land in the window: collect now and leave
    # set-up's objects out of its later scans.
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    if trace:
        tracer.start()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        now = time.perf_counter()
        if now >= deadline and round_no % traffic.period == 0:
            break
        if tracer.active and round_no >= traced_rounds:
            tracer.stop()
        traced = tracer.active
        with tracer.span("traffic"):
            inp = traffic.block(round_no)
            t_issue = time.perf_counter()
            if inp.incident:
                overlapped += sum(inc.open for inc in incidents)
                lost = ((st.state == stats.ROLE_LEADER) & ~prev_crashed
                        & inp.crashed).any(0)
                if inp.reset is not None:
                    lost |= inp.reset
                incidents.append(stats.Incident(t_issue, len(blocks), lost))
            if inp.reset is not None:
                st = splice(st, sut.init_state(), inp.reset)
        pre = st
        cc_kw = {"confchanges": inp.confchanges} if with_cc else {}
        with tracer.span("block"):
            t_call = time.perf_counter()
            st, fused_after = sut.block(pre, inp.crashed, inp.append, fused, **cc_kw)
        with tracer.span("sync"):
            _sync(device)
            t_end = time.perf_counter()
        ran_fused = fused_after != fused
        fused = fused_after
        i = len(blocks)
        blocks.append(stats.BlockRecord(i, t_call, t_end, ran_fused, k, traced))
        table_blocks[inp.table] += 1
        if inp.confchanges is not None:
            conf_entries += inp.confchanges.start * C.chain_steps(inp.confchanges.voter)
        sampler.offer(ran_fused, (pre, st, inp.crashed, inp.append, inp.confchanges))
        if any(inc.open for inc in incidents):
            with tracer.span("bookkeeping"):
                for inc in incidents:
                    if inc.open:
                        inc.update(i, st, inp.crashed)
        prev_crashed = inp.crashed
        round_no += k
    _sync(device)
    t_close = time.perf_counter()
    tracer.stop()
    window_s = t_close - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    n_blocks = len(blocks)
    n_fused = sum(b.fused for b in blocks)
    log(f"window: {window_s:.6f} s, {n_blocks} blocks ({n_fused} fused, "
        f"{n_blocks - n_fused} general), {round_no} rounds, {len(incidents)} incidents "
        f"({overlapped} not over when the next began)")
    log("window: rounds a second in each tenth: "
        + " ".join(f"{r:.1f}" for r in stats.rate_by_slice(blocks, t_start, t_close, 10)))

    # ---- the check against the reference
    t = time.perf_counter()
    kept = sampler.kept[True] + sampler.kept[False]
    del sampler, pre
    checks, failed = _check(conf, device, traffic, start_state, st, settle_in.append,
                            settle_rounds, kept, table_blocks, conf_entries)
    n_checked = len(kept)
    del kept
    del start_state, st
    correct = all(v <= lim for v, lim in checks.values())
    log(f"check: the settle and {n_checked} of {n_blocks} blocks against the reference "
        f"in {time.perf_counter() - t:.3f} s")

    # ---- metrics
    group_rounds = G * round_no
    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if not trace:
        block_ms = [(b.t_end - b.t_issue) * 1e3 for b in blocks]
        values = {"ticks_per_s": group_rounds / window_s,
                  "step_ms_p95": stats.percentile(block_ms, 95),
                  "setup_s": setup_s}
        log(f"samples: ticks_per_s over {round_no} rounds of {G} groups in "
            f"{window_s:.6f} s; step_ms_p95 over {len(block_ms)} blocks")
        if incidents:
            samples = []
            for inc in incidents:
                samples += inc.samples([b.t_end for b in blocks], t_close)
            secs = [s for s, _ in samples]
            weights = [w for _, w in samples]
            if sum(weights):
                values["recover_ms_p95"] = 1e3 * stats.weighted_percentile(secs, weights, 95)
            log(f"samples: recover_ms_p95 over {sum(weights)} groups in "
                f"{len(incidents)} incidents")
        for m in spec.metrics_of(bench, workload, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        result_extra = {}
    else:
        labels = ["block.fused" if b.fused else "block.general" for b in blocks if b.traced]
        view = tracer.view(labels)
        if view is not None and device.type == "cuda":
            _check_records(view, [b for b in blocks if b.traced], sut.fused_kernel)
        ctx = SimpleNamespace(
            conf=conf, G=G, P=P, k=k, fused_kernel=sut.fused_kernel,
            blocks=blocks, traced=[b for b in blocks if b.traced], trace=view,
            group_rounds=group_rounds, fused_group_rounds=fused,
        )
        names = [m["name"] for m in spec.metrics_of(bench, workload, "per_layer")]
        for name, read in spec.readers(names, Path(root) / "portbench").items():
            v = read(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        result_extra = {"breakdown": breakdown(view)} if view else {}
        log(f"trace: {len(ctx.traced)} blocks traced, {len(view.ops) if view else 0} "
            "device operations")

    found = banned_modules()
    if found:
        raise ImportError(f"the run loaded {found}; the benchmark must not")
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": peak,
    }
    if trace and result_extra:
        dev_info["busy_s"] = view.busy_s
        dev_info["window_s"] = view.window_s
    for name, (v, lim) in checks.items():
        log(f"check {name}: {v} (limit {lim})")
    return {
        "correct": correct,
        "attempted": n_blocks,
        "failed": failed,
        "metrics": metrics,
        "device": dev_info,
        **result_extra,
        "checks": {n: {"value": v, "limit": lim} for n, (v, lim) in checks.items()},
    }
