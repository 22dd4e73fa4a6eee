"""Benchmark: Raft ticks/sec/card at 100k groups (BASELINE.json config 3
shape: 100k groups × 5 peers, steady append load), counterpart of the
repository's `bench.py` for the PyTorch/CUDA port.

    python -m raft_tpu_torch.bench [flags]

Runs the fused MultiRaft round on the CUDA card (`--device cpu` runs the
plain PyTorch versions of the kernels on the CPU instead), anchors against
the native C++ scalar engine running the identical protocol
(raft_tpu_torch/multiraft/csrc/multiraft_engine.cpp, built at -O3), and
prints ONE JSON line:

  {"metric": ..., "value": ..., "unit": "ticks/sec", "vs_baseline": ...,
   "reps": R, "min": ..., "median": ..., "max": ..., "spread_pct": ...,
   "spread_flagged": bool, "fused_rounds": N, "total_rounds": M,
   "fused_frac": N/M}

Every mode, flag, metric key and JSON field is `bench.py`'s; see its
docstring for what each mode measures.  What differs:

  * The JAX scans are host loops: `bench_device` advances one 32-round
    fused-dispatch block at a time (ROUNDS_PER_SCAN // K blocks a scan),
    the recent_active plane packed between blocks (sim.pack_ra_carry) as
    the reference's scan carry holds it.  The fused group-round count is a
    device int32, read once a rep after the card synchronises.
  * `--blackbox`'s general path is ClusterSim.run_compiled, on the card a
    CUDA graph of one round, captured in the warm call outside the timed
    region.
  * `--profile DIR` writes a torch.profiler trace (CPU and CUDA activity,
    Chrome/Perfetto format) of the default mode's timed region to
    DIR/trace.json (raft_tpu_torch.profiling).
  * `--check` keys the baseline `metric@torch-<device type>@gGROUPS`, so
    no entry of the JAX package's runs (`...@cpu@g256`, `...@tpu@...`)
    ever gates the port, nor the port's CPU runs its card runs.
  * `--mesh N` (the sharded config-5 bench) launches N ranks itself
    (multiraft.sharding.launch): one rank a card over NCCL, or with
    `--device cpu` N CPU ranks over gloo; rank 0 prints the line, its
    ticks/s over the slowest rank's time a rep.  N above the visible cards
    exits 2.  `--mesh-state FILE` also writes the whole batch's end state
    (.npz, by SimState field), so a caller can hold it to an unsharded run.
  * `--device` (default `cuda`) picks the device; there is no compile cache.

`main(argv)` returns the line it prints, so a caller driving the bench from
Python prints and gets exactly what the command line prints.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from .multiraft.platform import resolve_device
from .scalar.metrics import Registry

G = 100_000
P = 5
K = 32
ROUNDS_PER_SCAN = 64
SCANS = 6
REPS = 5
SPREAD_FLAG_PCT = 20.0
ANCHOR_GROUPS = 4096
ANCHOR_ROUNDS = 60

# Bench-process metrics registry (raft_tpu_torch.scalar.metrics): the
# measured fused-kernel coverage folds in here as
# `multiraft_fused_rounds_total` so an embedding scraping the bench
# process sees the same number the JSON line carries.
METRICS = Registry()


def fused_fields(fused_rounds: int, total_rounds: int) -> dict:
    """The measured fused-fraction fields EVERY bench JSON line carries.
    Units are GROUP-rounds — one group advancing one protocol round; a
    whole-batch fused block of k rounds at G groups counts k*G — so
    per-group dispatchers (hybrid splits) report honest partial coverage.
    Also folds the count into the module METRICS registry as the
    `multiraft_fused_rounds_total` counter."""
    METRICS.counter(
        "multiraft_fused_rounds_total",
        "fused-kernel group-rounds executed in bench timed regions",
    ).inc(int(fused_rounds))
    return {
        "fused_rounds": int(fused_rounds),
        "total_rounds": int(total_rounds),
        "fused_frac": (
            round(fused_rounds / total_rounds, 4) if total_rounds else 0.0
        ),
    }


def rep_stats(samples) -> dict:
    """min/median/max/spread_pct over per-repetition ticks/sec samples."""
    lo, hi = min(samples), max(samples)
    med = statistics.median(samples)
    spread_pct = (hi - lo) / med * 100.0 if med else float("inf")
    return {
        "reps": len(samples),
        "min": round(lo, 1),
        "median": round(med, 1),
        "max": round(hi, 1),
        "spread_pct": round(spread_pct, 1),
        "spread_flagged": spread_pct > SPREAD_FLAG_PCT,
    }


def _sync(dev: torch.device) -> None:
    """Wait for the card's queued work (the host clock is read after it)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _copy_state(st):
    """A field-wise copy of a SimState (each rep replays from the keeper)."""
    return type(st)(*(None if v is None else v.clone() for v in st))


def _load_doc(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def _fail_on_safety(what: str, report: dict) -> None:
    if any(report["safety"].values()):
        print(f"ERROR: {what} violated safety invariants: {report['safety']}",
              file=sys.stderr)
        raise SystemExit(2)


def bench_device(
    groups: int = G,
    reps: int = REPS,
    health: bool = False,
    profile_dir: str = "",
    health_out: str = "",
    lossy: float = -1.0,
    check_quorum: bool = False,
    device=None,
) -> dict:
    """The fused paths: `reps` reps of SCANS scans of ROUNDS_PER_SCAN
    rounds, each scan ROUNDS_PER_SCAN // K dispatch blocks of K rounds
    (fused_step.fast_multi_round, or the per-group hybrid_multi_round for
    --lossy --check-quorum without --health), after a settle and one
    warm-up scan outside the timed region."""
    from .multiraft import fused_step, kernels, sim
    from .multiraft.sim import SimConfig

    dev = resolve_device(device)
    chaos = lossy >= 0.0
    # Chaos and damping dispatch on the free-running timer bound, so the
    # election timeout must clear the fused horizon: election_tick=64 > K.
    cfg = SimConfig(
        n_groups=groups, n_peers=P,
        election_tick=64 if (chaos or check_quorum) else 10,
        check_quorum=check_quorum,
    )
    state = sim.init_state(cfg, device=dev)
    crashed = torch.zeros((P, groups), dtype=torch.bool, device=dev)
    append = torch.ones((groups,), dtype=torch.int32, device=dev)
    link = (torch.ones((P, P, groups), dtype=torch.bool, device=dev)
            if chaos else None)
    loss = (
        torch.full((P, P, groups), int(round(lossy * kernels.LOSS_SCALE)),
                   dtype=torch.int32, device=dev)
        if chaos
        else None
    )

    use_hybrid = chaos and check_quorum and not health
    if use_hybrid:
        kstep = fused_step.hybrid_multi_round(
            cfg, k=K, with_chaos=True, count_fused=True, device=dev,
        )
    else:
        kstep = fused_step.fast_multi_round(
            cfg, k=K, with_health=health, with_chaos=chaos, count_fused=True,
        )
    hstate = sim.init_health(cfg, dev) if health else None

    def block_step(s, h, rb, fz):
        """One K-round fused-dispatch block at absolute round rb."""
        args = (s, crashed, append)
        if chaos:
            args = args + (link, loss, rb)
        if health:
            return kstep(*args, h, fz)
        out, fz = kstep(*args, fz)
        return out, h, fz

    round_no = 0

    def advance(stp, ra, h, fused):
        """One scan over the PACKED carry: the recent_active words stay
        packed between scans (the reference's scan carry), unpacked for
        each block."""
        nonlocal round_no
        for i in range(ROUNDS_PER_SCAN // K):
            s, h, fused = block_step(
                sim.unpack_ra_carry(stp, ra), h, round_no + i * K, fused
            )
            stp, ra = sim.pack_ra_carry(s)
        round_no += ROUNDS_PER_SCAN
        return stp, ra, h, fused

    def zero():
        return torch.zeros((), dtype=torch.int32, device=dev)

    # Settle the election storm (longer for the chaos/damped configs'
    # election_tick), then one warm-up scan.
    settle = 30 if not (chaos or check_quorum) else 3 * cfg.election_tick
    for _ in range(settle):
        state = sim.step(cfg, state, crashed, append)
    round_no = settle
    stp, ra = sim.pack_ra_carry(state)
    stp, ra, hstate, _warm_fused = advance(stp, ra, hstate, zero())
    _sync(dev)
    if (chaos or check_quorum) and not use_hybrid:
        # Honesty check, outside the timed region: the timed loop must ride
        # the fused kernel, not silently time the general fallback.  (The
        # hybrid split's coverage IS the measured fused_frac.)
        state = sim.unpack_ra_carry(stp, ra)
        pred = bool(
            fused_step.steady_predicate(cfg, state, crashed, K, link, loss_rate=loss)
        )
        if not pred:
            print(
                "WARNING: steady predicate rejects the settled "
                f"{'lossy' if chaos else 'damped'} state; the bench is "
                "timing the general fallback",
                file=sys.stderr,
            )

    rounds = (ROUNDS_PER_SCAN // K) * K * SCANS
    ticks = groups * rounds
    samples = []
    fused_total = 0
    if profile_dir:
        from . import profiling

        profiling.start_trace(profile_dir)
    try:
        for _ in range(reps):
            fused = zero()  # re-zeroed: the warm-up scan doesn't count
            t0 = time.perf_counter()
            for _ in range(SCANS):
                stp, ra, hstate, fused = advance(stp, ra, hstate, fused)
            _sync(dev)
            samples.append(ticks / (time.perf_counter() - t0))
            # The per-rep read of the int32 group-round count: one rep
            # accrues groups x rounds (= 384) group-rounds, within int32 up
            # to ~5.5M groups; the card is already synced.
            got = int(fused)
            if got < 0:
                raise RuntimeError(
                    "fused group-round accumulator wrapped int32 within "
                    "one rep (groups x rounds_per_rep >= 2**31); reduce "
                    "--groups"
                )
            fused_total += got
    finally:
        if profile_dir:
            profiling.stop_trace()

    # Sanity: the protocol is actually running (leaders + commits advance).
    state = sim.unpack_ra_carry(stp, ra)
    commit_min = int(state.commit.amax(dim=0).amin())
    assert commit_min > 0, "bench sanity: no commits on device"
    if health and health_out:
        from .multiraft.health import HealthMonitor

        summary = kernels.health_summary(
            hstate.planes,
            cfg.leaderless_stall_ticks,
            cfg.commit_stall_ticks,
            cfg.churn_bumps,
            min(cfg.health_topk, groups),
        )
        with open(health_out, "w") as f:
            json.dump(
                HealthMonitor.summary_dict(*(t.tolist() for t in summary)), f
            )
    return {
        **rep_stats(samples),
        **fused_fields(fused_total, groups * rounds * reps),
    }


def bench_blackbox(groups: int = G, reps: int = REPS, device=None) -> dict:
    """The black-box instrumentation overhead: the general path
    (ClusterSim.run_compiled, a CUDA graph of one round on the card) with
    SimConfig.blackbox off and on, and the fused path (bench_device, black
    box off) against the black-box-on general path, since a black-box
    config never fuses: `blackbox_overhead_fused_pct` includes the
    defusion, the price a production fused configuration pays."""
    from .multiraft.sim import ClusterSim, SimConfig

    dev = resolve_device(device)
    crashed = torch.zeros((P, groups), dtype=torch.bool, device=dev)
    append = torch.ones((groups,), dtype=torch.int32, device=dev)

    def run_general(blackbox: bool) -> dict:
        cfg = SimConfig(n_groups=groups, n_peers=P, blackbox=blackbox)
        cs = ClusterSim(cfg, device=dev)
        # Settle the election storm, then warm the segment (the capture).
        for _ in range(30):
            cs.run_round(crashed, append)
        cs.run_compiled(ROUNDS_PER_SCAN, append_n=append)
        _sync(dev)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(SCANS):
                cs.run_compiled(ROUNDS_PER_SCAN, append_n=append)
            _sync(dev)
            samples.append(
                groups * ROUNDS_PER_SCAN * SCANS
                / (time.perf_counter() - t0)
            )
        assert int(cs.state.commit.amax(dim=0).amin()) > 0, (
            "bench sanity: no commits on device"
        )
        return rep_stats(samples)

    general_off = run_general(False)
    general_on = run_general(True)
    fused_off = bench_device(groups, reps, device=dev)

    def overhead(base: dict, instrumented: dict) -> float:
        return round(
            100.0 * (base["median"] - instrumented["median"])
            / base["median"],
            2,
        )

    return {
        "general_off": general_off,
        "general_on": general_on,
        "fused_off": fused_off,
        "blackbox_overhead_pct": overhead(general_off, general_on),
        "blackbox_overhead_fused_pct": overhead(fused_off, general_on),
    }


def bench_chaos(
    plan_path: str, groups: int, reps: int, chaos_out: str = "",
    check_quorum: bool = False, device=None,
) -> dict:
    """Run a chaos plan as one runner call per rep and report both the
    scenario summary and the chaos-path throughput."""
    from .multiraft import chaos, sim
    from .multiraft.health import HealthMonitor
    from .multiraft.sim import SimConfig

    dev = resolve_device(device)
    plan = chaos.load_plan(plan_path)
    cfg = SimConfig(
        n_groups=groups, n_peers=plan.n_peers, collect_health=True,
        check_quorum=check_quorum,
    )
    compiled = chaos.compile_plan(plan, groups, dev)
    runner = chaos.make_runner(cfg, compiled)

    def fresh():
        return sim.init_state(cfg, device=dev), sim.init_health(cfg, dev)

    st, hl = fresh()
    st, hl, stats, safety = runner(st, hl)  # first run
    _sync(dev)
    samples = []
    for _ in range(reps):
        st, hl = fresh()
        _sync(dev)
        t0 = time.perf_counter()
        st, hl, stats, safety = runner(st, hl)
        _sync(dev)
        samples.append(groups * plan.n_rounds / (time.perf_counter() - t0))
    report = HealthMonitor.chaos_report(
        stats.tolist(), safety.tolist(), plan.n_rounds
    )
    report["plan"] = plan.name
    report["groups"] = groups
    report["peers"] = plan.n_peers
    report["phases"] = len(plan.phases)
    if chaos_out:
        with open(chaos_out, "w") as f:
            json.dump(report, f)
    _fail_on_safety(f"chaos plan {plan.name}", report)
    # The chaos runner is the per-round link-gated loop — no fused blocks
    # by construction; the honest fused_frac is 0.
    return {
        "report": report,
        **rep_stats(samples),
        **fused_fields(0, groups * plan.n_rounds * reps),
    }


def _reconfig_report(cfg, plan, st, hl, stats, rstats, safety, chaos_doc) -> dict:
    """HealthMonitor.reconfig_report off a run's end state and accumulators,
    with the reconfig-stall rule applied to the final planes."""
    from .multiraft.health import HealthMonitor
    from .multiraft.kernels import HP_SINCE_COMMIT

    n_stuck, worst = HealthMonitor.reconfig_stall_groups(
        st.outgoing_mask.cpu().numpy(),
        hl.planes[HP_SINCE_COMMIT].cpu().numpy(),
        cfg.election_tick,
    )
    report = HealthMonitor.reconfig_report(
        stats.tolist(), rstats.tolist(), safety.tolist(), plan.n_rounds,
        n_stuck, worst,
    )
    report["plan"] = plan.name
    report["groups"] = cfg.n_groups
    report["peers"] = plan.n_peers
    report["phases"] = len(plan.phases)
    report["chaos_overlay"] = chaos_doc is not None
    return report


def bench_reconfig(
    plan_path: str, groups: int, reps: int, reconfig_out: str = "",
    check_quorum: bool = False, device=None,
) -> dict:
    """Run a membership-churn plan (optionally composed with a chaos plan)
    as one runner call per rep — the BASELINE config 4 shape — and report
    both the scenario summary and the reconfig-path throughput."""
    from .multiraft import chaos, reconfig, sim
    from .multiraft.sim import SimConfig

    dev = resolve_device(device)
    doc = _load_doc(plan_path)
    chaos_doc = None
    if "reconfig" in doc:
        chaos_doc = doc.get("chaos")
        doc = doc["reconfig"]
    plan = reconfig.plan_from_dict(doc)
    cfg = SimConfig(
        n_groups=groups, n_peers=plan.n_peers, collect_health=True,
        check_quorum=check_quorum,
    )
    compiled = reconfig.compile_plan(plan, groups, dev)
    chaos_compiled = (
        None
        if chaos_doc is None
        else chaos.compile_plan(chaos.plan_from_dict(chaos_doc), groups, dev)
    )
    runner = reconfig.make_runner(cfg, compiled, chaos_compiled)

    def fresh():
        st = sim.init_state(cfg, *reconfig.initial_masks(plan, groups, dev),
                            device=dev)
        return st, sim.init_health(cfg, dev), reconfig.init_reconfig_state(st)

    runner(*fresh())  # first run
    _sync(dev)
    samples = []
    for _ in range(reps):
        st, hl, rst = fresh()
        _sync(dev)
        t0 = time.perf_counter()
        st, hl, rst, stats, rstats, safety = runner(st, hl, rst)
        _sync(dev)
        samples.append(groups * plan.n_rounds / (time.perf_counter() - t0))
    report = _reconfig_report(cfg, plan, st, hl, stats, rstats, safety, chaos_doc)
    if reconfig_out:
        with open(reconfig_out, "w") as f:
            json.dump(report, f)
    _fail_on_safety(f"reconfig plan {plan.name}", report)
    # make_runner is the unsplit per-round loop (--prod-fused is the
    # split-horizon mode); the honest fused_frac here is 0.
    return {
        "report": report,
        **rep_stats(samples),
        **fused_fields(0, groups * plan.n_rounds * reps),
    }


def _settled(cfg, n_peers, groups, dev, masks=()):
    """init_state (from `masks` when given), then 3 x election_tick plain
    steps of one append a group: the leaders settle outside the timed
    region."""
    from .multiraft import sim

    st = sim.init_state(cfg, *masks, device=dev)
    crashed = torch.zeros((n_peers, groups), dtype=torch.bool, device=dev)
    append = torch.ones((groups,), dtype=torch.int32, device=dev)
    for _ in range(3 * cfg.election_tick):
        st = sim.step(cfg, st, crashed, append)
    _sync(dev)
    return st


def bench_prod_fused(
    plan_path: str,
    groups: int,
    reps: int,
    prod_out: str = "",
    k: int = 8,
    window: int = 4,
    device=None,
) -> dict:
    """The PRODUCTION configuration, measured honestly fused: health +
    counters + chaos overlay + check-quorum + pre-vote + a multi-op
    ReconfigPlan through the split-horizon runner
    (reconfig.make_split_runner), reporting ticks/sec AND the measured
    fused fraction.  Leaders settle outside the timed region; each rep
    replays the plan from a copy of the settled state."""
    from .multiraft import chaos, kernels, reconfig, sim
    from .multiraft.sim import SimConfig

    dev = resolve_device(device)
    doc = _load_doc(plan_path)
    chaos_doc = doc.get("chaos")
    plan = reconfig.plan_from_dict(doc.get("reconfig", doc))
    cfg = SimConfig(
        n_groups=groups, n_peers=plan.n_peers, election_tick=64,
        collect_health=True, collect_counters=True,
        check_quorum=True, pre_vote=True,
    )
    compiled = reconfig.compile_plan(plan, groups, dev)
    chaos_compiled = (
        None
        if chaos_doc is None
        else chaos.compile_plan(chaos.plan_from_dict(chaos_doc), groups, dev)
    )
    runner = reconfig.make_split_runner(
        cfg, compiled, chaos_compiled, k=k, window=window, with_counters=True,
    )
    st0 = _settled(cfg, plan.n_peers, groups, dev,
                   reconfig.initial_masks(plan, groups, dev))

    def fresh():
        st = _copy_state(st0)  # st0 is the keeper
        return (
            st, sim.init_health(cfg, dev), reconfig.init_reconfig_state(st),
            kernels.zero_counters(dev),
        )

    runner(*fresh())  # first run
    _sync(dev)
    samples = []
    fused_total = 0
    for _ in range(reps):
        st, hl, rst, ctrs = fresh()
        _sync(dev)
        t0 = time.perf_counter()
        st, hl, rst, stats, rstats, safety, fused, ctrs = runner(
            st, hl, rst, ctrs
        )
        _sync(dev)
        samples.append(
            groups * plan.n_rounds / (time.perf_counter() - t0)
        )
        fused_total += int(fused)
    report = _reconfig_report(cfg, plan, st, hl, stats, rstats, safety, chaos_doc)
    report["segments"] = [
        {"start": s.start, "rounds": s.rounds, "fused": s.fused}
        for s in runner.segments
    ]
    if prod_out:
        with open(prod_out, "w") as f:
            json.dump(report, f)
    _fail_on_safety(f"prod-fused plan {plan.name}", report)
    return {
        "report": report,
        **rep_stats(samples),
        **fused_fields(fused_total, groups * plan.n_rounds * reps),
    }


AUTOPILOT_DOC = {
    "name": "autopilot-bench",
    "peers": 5,
    "phases": [
        {"rounds": 192, "append": 0},
        {"rounds": 32, "crash": [2], "append": 0},
        {"rounds": 96, "heal": True, "append": 0},
    ],
}


def bench_autopilot(
    groups: int,
    reps: int,
    chaos_path: str = "",
    cadence: int = 16,
    out: str = "",
    device=None,
) -> dict:
    """The closed-loop configuration: the Zipf hot-region workload, a
    crash-window chaos overlay (AUTOPILOT_DOC, or the plan at
    `chaos_path`), and the autopilot's kick/transfer healing in one run;
    the per-cadence host policy round trips are INSIDE the timed region.
    Leaders settle outside it (3x election_tick rounds); each rep replays
    from a copy of the settled state with a fresh Autopilot that takes
    over the warm run's runner cache."""
    from .multiraft import chaos, sim
    from .multiraft.autopilot import Autopilot, AutopilotConfig
    from .multiraft.sim import ClusterSim, SimConfig

    dev = resolve_device(device)
    doc = _load_doc(chaos_path) if chaos_path else AUTOPILOT_DOC
    plan = chaos.plan_from_dict(doc)
    cfg = SimConfig(
        n_groups=groups, n_peers=plan.n_peers, election_tick=64,
        collect_health=True, transfer=True, commit_stall_ticks=8,
    )
    rng = np.random.RandomState(0)
    append = torch.from_numpy(
        np.minimum(rng.zipf(1.8, size=groups), 8).astype(np.int32)
    ).to(dev)
    st = sim.init_state(cfg, device=dev)
    crashed0 = torch.zeros((plan.n_peers, groups), dtype=torch.bool, device=dev)
    for _ in range(3 * cfg.election_tick):
        st = sim.step(cfg, st, crashed0, append)
    _sync(dev)
    st_keep = _copy_state(st)

    def fresh_sim():
        s = ClusterSim(cfg, device=dev)
        s.state = _copy_state(st_keep)
        s._health = sim.init_health(cfg, dev)
        return s

    apcfg = AutopilotConfig(cadence=cadence)
    # Warm-up run; every rep takes over its segment-runner cache, as the
    # reference's reps share its compiled runners.  (Here the cache is keyed
    # by the schedules' identity, so a rep's own schedules add runners.)
    warm = Autopilot(fresh_sim(), apcfg, fused=True)
    report = warm.run_plan(plan, append=append)
    shared_runners = warm._runners
    samples = []
    for _ in range(reps):
        s = fresh_sim()
        ap = Autopilot(s, apcfg, fused=True)
        ap._runners = shared_runners
        _sync(dev)
        t0 = time.perf_counter()
        report = ap.run_plan(plan, append=append)
        _sync(dev)
        samples.append(groups * plan.n_rounds / (time.perf_counter() - t0))
    _fail_on_safety("autopilot bench", report)
    if out:
        with open(out, "w") as f:
            json.dump(report, f)
    return {
        "report": {
            k: report[k]
            for k in (
                "rounds", "mttr_rounds", "reelections",
                "commit_stall_group_rounds", "safety",
            )
        },
        "actions": report["actions"],
        **rep_stats(samples),
        **fused_fields(
            report.get("fused_rounds", 0) * reps,
            groups * plan.n_rounds * reps,
        ),
    }


def bench_reads(
    plan_path: str,
    groups: int,
    reps: int,
    reads_out: str = "",
    k: int = 8,
    device=None,
) -> dict:
    """The serving workload: a client read/write plan through the
    production damped configuration (check_quorum + pre_vote + lease_read,
    election_tick=64) with the full per-round safety audit including the
    linearizability slots.  A bare plan runs the split-fused runner
    (workload.make_split_runner, measured fused_frac); a {"client": ...,
    "chaos": ...} document runs the general runner (fused_frac 0).  The
    report carries the read latency percentiles (reduced on the device by
    workload.latency_percentiles) and the read counters; any nonzero
    safety count exits 2.  Each rep replays from a copy of the settled
    state."""
    from .multiraft import chaos, reconfig, sim, workload
    from .multiraft.sim import SimConfig

    dev = resolve_device(device)
    doc = _load_doc(plan_path)
    chaos_doc = doc.get("chaos")
    plan = workload.plan_from_dict(doc.get("client", doc))
    cfg = SimConfig(
        n_groups=groups, n_peers=plan.n_peers, election_tick=64,
        collect_health=True, check_quorum=True, pre_vote=True,
        lease_read=True,
    )
    compiled = workload.compile_plan(plan, groups, dev)
    if chaos_doc is None:
        runner = workload.make_split_runner(cfg, compiled, k=k)
    else:
        chaos_compiled = chaos.compile_plan(
            chaos.plan_from_dict(chaos_doc), groups, dev
        )
        runner = workload.make_runner(cfg, compiled, chaos_compiled)
    st0 = _settled(cfg, plan.n_peers, groups, dev)

    def fresh():
        st = _copy_state(st0)
        return (
            st, sim.init_health(cfg, dev), reconfig.init_reconfig_state(st),
            workload.init_read_carry(groups, dev),
        )

    runner(*fresh())  # first run
    _sync(dev)
    samples = []
    fused_total = 0
    for _ in range(reps):
        args = fresh()
        _sync(dev)
        t0 = time.perf_counter()
        out = runner(*args)
        _sync(dev)
        samples.append(
            groups * plan.n_rounds / (time.perf_counter() - t0)
        )
        if chaos_doc is None:
            fused_total += int(out[9])
    _st, _hl, _rst, stats, _rstats, safety, _rcar, rdstats, lat_hist = out[:9]
    lat_p = workload.latency_percentiles(lat_hist)
    report = workload.read_report(
        rdstats.tolist(), lat_p.tolist(), safety.tolist(), stats.tolist(),
        plan.n_rounds,
    )
    report["plan"] = plan.name
    report["groups"] = groups
    report["peers"] = plan.n_peers
    report["phases"] = len(plan.phases)
    report["chaos_overlay"] = chaos_doc is not None
    if reads_out:
        with open(reads_out, "w") as f:
            json.dump(report, f)
    _fail_on_safety(
        f"read plan {plan.name} (linearizability slots included)", report
    )
    return {
        "report": report,
        "read_p50": report["read_p50"],
        "read_p90": report["read_p90"],
        "read_p99": report["read_p99"],
        **rep_stats(samples),
        **fused_fields(fused_total, groups * plan.n_rounds * reps),
    }


MESH_PEERS = 3  # BASELINE.json config 5: 1M groups x 3 peers
MESH_ROUNDS_PER_SCAN = 64
MESH_SCANS = 6


def mesh_plane_bytes(cfg, n_devices: int) -> dict:
    """Analytic per-card bytes of the sharded fleet state: the [P, P, G]
    pairwise planes broken out (the damped recent_active plane both as its
    bool[P, P, G] plane and as the 32:1 packed words run_compiled's carry
    holds), the per-peer [P, G] planes, and the resident total with
    recent_active packed.  Every figure is per card: the group axis divides
    across the mesh, the peer axes stay whole."""
    import math

    Gs = math.ceil(cfg.n_groups / n_devices)  # groups per card
    Pn = cfg.n_peers
    i32 = 4
    damped = cfg.check_quorum or cfg.pre_vote
    pairwise = {
        "matched": Pn * Pn * Gs * i32,
        "agree": Pn * Pn * Gs * i32,
    }
    if damped:
        pairwise["recent_active_unpacked"] = Pn * Pn * Gs  # bool = 1 byte
        pairwise["recent_active_packed"] = Pn * Pn * math.ceil(Gs / 32) * i32
    # Per-peer planes: 11 int32 [P, G] cursors and timers + 3 bool config
    # masks (+ the optional transferee plane).
    per_peer = 11 * Pn * Gs * i32 + 3 * Pn * Gs
    if cfg.transfer:
        per_peer += Pn * Gs * i32
    resident_pairwise = (
        pairwise["matched"] + pairwise["agree"]
        + pairwise.get("recent_active_packed", 0)
    )
    return {
        "groups_per_chip": Gs,
        "pairwise": pairwise,
        "per_peer_total": per_peer,
        "total_per_chip": resident_pairwise + per_peer,
    }


def mesh_config(groups: int, check_quorum: bool = False):
    """The config-5 SimConfig of the mesh bench."""
    from .multiraft.sim import SimConfig

    return SimConfig(
        n_groups=groups, n_peers=MESH_PEERS,
        election_tick=64 if check_quorum else 10,
        check_quorum=check_quorum, pre_vote=check_quorum,
    )


def mesh_rounds(check_quorum: bool, reps: int):
    """The run_compiled segment lengths bench_mesh runs, in order: the
    settle, the warm segment and reps x MESH_SCANS timed scans."""
    settle = 3 * 64 if check_quorum else 30
    return [settle, MESH_ROUNDS_PER_SCAN] + [MESH_ROUNDS_PER_SCAN] * (MESH_SCANS * reps)


def _mesh_rank(mesh, groups: int, reps: int, check_quorum: bool, state_out: str) -> dict:
    """One rank of bench_mesh: its block of the fleet bootstrapped in place
    from the election storm, settled, warmed (the CUDA graph is captured),
    then MESH_SCANS run_compiled scans a rep; a rep's time is the slowest
    rank's, and the status is reduced over every rank."""
    from .multiraft import sharding, sim

    cfg = mesh_config(groups, check_quorum)
    cs = sim.ClusterSim(cfg, mesh=mesh)
    append = torch.ones((groups,), dtype=torch.int32, device=mesh.device)
    segs = mesh_rounds(check_quorum, reps)
    for rounds in segs[:2]:
        cs.run_compiled(rounds, append_n=append)
    _sync(mesh.device)
    ticks = groups * MESH_ROUNDS_PER_SCAN * MESH_SCANS
    samples = []
    for _ in range(reps):
        sharding.reduce_i32(mesh, 0)  # every rank starts the rep together
        t0 = time.perf_counter()
        for _ in range(MESH_SCANS):
            cs.run_compiled(MESH_ROUNDS_PER_SCAN, append_n=append)
        _sync(mesh.device)
        us = int((time.perf_counter() - t0) * 1e6)
        slowest = int(sharding.reduce_i32(mesh, us, "max").item())
        samples.append(ticks / (slowest / 1e6))
    status = sharding.global_status(cs.cfg, mesh)(cs.state)
    assert status["n_leaders"] > 0, "mesh bench sanity: no leaders"
    assert status["total_commit"] > 0, "mesh bench sanity: no commits"
    if state_out:
        whole = sharding.gather_state(mesh, cs.state, groups)
        if mesh.rank == 0:
            np.savez(state_out, **sim.state_to_numpy(whole))
    stats = rep_stats(samples)
    per_chip = {k: round(stats[k] / mesh.size, 1) for k in ("min", "median", "max")}
    return {
        **stats,
        "n_devices": mesh.size,
        "per_chip_ticks_per_sec": per_chip,
        "per_chip_plane_bytes": mesh_plane_bytes(cfg, mesh.size),
        "n_leaders": status["n_leaders"],
        "total_commit": status["total_commit"],
    }


def bench_mesh(groups: int, n_devices: int, reps: int = REPS,
               check_quorum: bool = False, device=None, state_out: str = "") -> dict:
    """BASELINE config 5 on the mesh: groups x 3 peers from the
    leader-election storm (init_state's randomized election clocks), split
    over n_devices ranks that this call launches (one a card over NCCL;
    with a CPU `device`, CPU ranks over gloo), each advancing its block as
    ClusterSim(mesh=).run_compiled, a CUDA graph of one round on a card.
    No rank builds a global [P, P, G] plane (sharding.sharded_init_state).
    Reports total and per-card ticks/s, the analytic per-card plane bytes
    and the status reduced over the ranks (n_leaders, total_commit).  More
    ranks than visible cards exits 2; a rank's failure raises."""
    from .multiraft import _build, sharding

    dev = torch.device("cuda" if device is None else device)
    devices = None
    if dev.type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n_devices:
            print(f"ERROR: --mesh {n_devices} needs {n_devices} CUDA devices but "
                  f"{visible} are visible; --device cpu runs CPU ranks",
                  file=sys.stderr)
            raise SystemExit(2)
        # run_compiled's graph helper, built once here, not once a rank.
        _build.load_graph_cuda()
    else:
        devices = [dev] * n_devices
    return sharding.launch(n_devices, _mesh_rank, groups, reps, check_quorum,
                           state_out, devices=devices)


def bench_scalar_anchor(reps: int = REPS) -> dict:
    """The native-CPU anchor: the C++ engine (built at -O3) at
    ANCHOR_GROUPS x P, ANCHOR_ROUNDS rounds a rep after 25 settle rounds."""
    from .multiraft.native import NativeMultiRaft

    engine = NativeMultiRaft(ANCHOR_GROUPS, P)
    append = np.ones((ANCHOR_GROUPS,), dtype=np.int32)
    # Let elections settle before timing (same steady state as the device).
    engine.run(25, None, append)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.run(ANCHOR_ROUNDS, None, append)
        samples.append(
            ANCHOR_GROUPS * ANCHOR_ROUNDS / (time.perf_counter() - t0)
        )
    return rep_stats(samples)


def check_key(metric: str, groups: int, device: str = "cuda") -> str:
    """Baseline key: one entry per (metric, backend, batch size).  The
    backend is `torch-<device type>`, so the port's CPU and card medians
    never gate each other, and no JAX-package entry (`@cpu@`, `@tpu@`)
    ever gates the port."""
    return f"{metric}@torch-{torch.device(device).type}@g{groups}"


def check_against_baseline(
    line: dict, baseline: dict, threshold_pct=None, device: str = "cuda",
) -> tuple:
    """The perf-regression gate: (ok, verdict-dict).

    Fails (ok=False) iff the run's median is more than threshold_pct below
    the committed baseline median.  A spread-flagged run cannot assert a
    regression (or a pass): the gate downgrades to `spread-flagged` and
    passes."""
    key = check_key(line["metric"], line.get("groups", G), device)
    verdict = {"key": key, "median": line["median"]}
    entry = baseline.get(key)
    if entry is None:
        verdict["status"] = "no-baseline"
        return True, verdict
    if entry.get("retired"):
        # A retired entry is a historical anchor, not a live gate.
        verdict["status"] = "retired-baseline"
        if entry.get("note"):
            verdict["note"] = entry["note"]
        return True, verdict
    thr = (
        threshold_pct
        if threshold_pct is not None
        else float(entry.get("threshold_pct", 25.0))
    )
    floor = float(entry["median"]) * (1.0 - thr / 100.0)
    verdict.update(
        baseline_median=entry["median"], threshold_pct=thr,
        floor=round(floor, 1),
    )
    if line.get("spread_flagged"):
        verdict["status"] = "spread-flagged"
        return True, verdict
    if line["median"] < floor:
        verdict["status"] = "regressed"
        return False, verdict
    verdict["status"] = "ok"
    return True, verdict


def run_check(args, line) -> None:
    """--check / --update-baseline handling; exits 1 on a regression."""
    device = args.device
    baseline = {}
    if os.path.exists(args.check):
        with open(args.check, "r", encoding="utf-8") as f:
            baseline = json.load(f)
    key = check_key(line["metric"], line.get("groups", G), device)
    if args.update_baseline:
        if baseline.get(key, {}).get("retired"):
            print(
                f"ERROR: baseline entry {key} is marked retired (a "
                "historical anchor); refusing to overwrite it — remove "
                "the \"retired\" flag by hand if the series is being "
                "deliberately revived",
                file=sys.stderr,
            )
            raise SystemExit(1)
        if line.get("spread_flagged"):
            # A spread-flagged run can assert no baseline either.
            print(
                "ERROR: refusing to record a baseline from a "
                f"spread-flagged run (spread {line['spread_pct']}% > "
                f"{SPREAD_FLAG_PCT}%); re-run on a quieter host",
                file=sys.stderr,
            )
            raise SystemExit(1)
        baseline[key] = {
            "median": line["median"],
            "threshold_pct": (
                args.check_threshold
                if args.check_threshold is not None
                else baseline.get(key, {}).get("threshold_pct", 25.0)
            ),
            "reps": line["reps"],
            "spread_pct": line["spread_pct"],
        }
        with open(args.check, "w", encoding="utf-8") as f:
            json.dump(baseline, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"baseline updated: {key}", file=sys.stderr)
        return
    ok, verdict = check_against_baseline(
        line, baseline, args.check_threshold, device
    )
    if args.check_out:
        with open(args.check_out, "w", encoding="utf-8") as f:
            json.dump(verdict, f)
    print(f"perf gate: {json.dumps(verdict)}", file=sys.stderr)
    if not ok:
        print(
            f"ERROR: median {line['median']} ticks/sec is below the "
            f"regression floor {verdict['floor']} "
            f"(baseline {verdict['baseline_median']} - "
            f"{verdict['threshold_pct']}%)",
            file=sys.stderr,
        )
        raise SystemExit(1)


def warn_spread(name: str, stats: dict) -> None:
    if stats["spread_flagged"]:
        print(
            f"WARNING: {name} ticks/sec spread {stats['spread_pct']}% "
            f"exceeds {SPREAD_FLAG_PCT}% across {stats['reps']} reps "
            f"(min {stats['min']}, max {stats['max']}); medians from this "
            "run are not comparable across builds — re-run on a quieter "
            "host.",
            file=sys.stderr,
        )


def parse_args(argv=None):
    """bench.py's flags and their checks, plus --device."""
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--profile", default="", metavar="DIR")
    ap.add_argument("--health", action="store_true")
    ap.add_argument("--health-out", default="", metavar="FILE")
    ap.add_argument("--lossy", type=float, default=-1.0, metavar="RATE")
    ap.add_argument("--check-quorum", action="store_true")
    ap.add_argument("--groups", type=int, default=G)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--skip-anchor", action="store_true")
    ap.add_argument("--chaos", default="", metavar="PLAN_JSON")
    ap.add_argument("--chaos-out", default="", metavar="FILE")
    ap.add_argument("--reconfig", default="", metavar="PLAN_JSON")
    ap.add_argument("--reconfig-out", default="", metavar="FILE")
    ap.add_argument("--prod-fused", default="", metavar="PLAN_JSON")
    ap.add_argument("--prod-out", default="", metavar="FILE")
    ap.add_argument("--autopilot", action="store_true")
    ap.add_argument("--autopilot-plan", default="", metavar="PLAN_JSON")
    ap.add_argument("--autopilot-out", default="", metavar="FILE")
    ap.add_argument("--reads", default="", metavar="PLAN_JSON")
    ap.add_argument("--reads-out", default="", metavar="FILE")
    ap.add_argument("--blackbox", action="store_true")
    ap.add_argument("--mesh", type=int, default=0, metavar="N_DEVICES")
    ap.add_argument("--mesh-state", default="", metavar="FILE",
                    help="with --mesh, write the whole batch's end state "
                         "(.npz by SimState field)")
    ap.add_argument("--cadence", type=int, default=16)
    ap.add_argument("--split-k", type=int, default=8)
    ap.add_argument("--split-window", type=int, default=4)
    ap.add_argument("--fused-floor", type=float, default=None)
    ap.add_argument("--check", default="", metavar="BASELINE_JSON")
    ap.add_argument("--check-out", default="", metavar="FILE")
    ap.add_argument("--check-threshold", type=float, default=None)
    ap.add_argument("--update-baseline", action="store_true")
    args = ap.parse_args(argv)
    if args.health_out and not args.health:
        ap.error("--health-out requires --health")
    if args.chaos_out and not args.chaos:
        ap.error("--chaos-out requires --chaos")
    if args.reconfig_out and not args.reconfig:
        ap.error("--reconfig-out requires --reconfig")
    if args.reconfig and args.chaos:
        ap.error("--reconfig and --chaos are separate modes; overlay "
                 "chaos via the reconfig plan file's \"chaos\" key")
    if (args.check_out or args.update_baseline) and not args.check:
        ap.error("--check-out/--update-baseline require --check")
    if args.lossy > 1.0 or (args.lossy < 0.0 and args.lossy != -1.0):
        # -1.0 is the chaos-off sentinel; any OTHER negative is a typo
        # that would silently bench the plain path under the steady key.
        ap.error("--lossy rate must be in [0, 1]")
    if args.prod_fused and (args.chaos or args.reconfig):
        ap.error("--prod-fused is its own mode (overlay chaos via the "
                 "plan file's \"chaos\" key)")
    if args.prod_out and not args.prod_fused:
        ap.error("--prod-out requires --prod-fused")
    if args.autopilot and (args.chaos or args.reconfig or args.prod_fused):
        ap.error("--autopilot is its own mode (chaos via --autopilot-plan)")
    if (args.autopilot_plan or args.autopilot_out) and not args.autopilot:
        ap.error("--autopilot-plan/--autopilot-out require --autopilot")
    if args.reads and (
        args.chaos or args.reconfig or args.prod_fused or args.autopilot
    ):
        ap.error("--reads is its own mode (overlay chaos via the plan "
                 "file's \"chaos\" key)")
    if args.reads_out and not args.reads:
        ap.error("--reads-out requires --reads")
    if args.mesh and (
        args.chaos or args.reconfig or args.prod_fused or args.autopilot
        or args.reads or args.health or args.lossy >= 0.0
    ):
        ap.error("--mesh is its own mode (the sharded config-5 bench; "
                 "--check-quorum composes for the damped/packed-carry "
                 "variant)")
    if args.mesh < 0:
        ap.error("--mesh needs a positive device count")
    if args.mesh_state and not args.mesh:
        ap.error("--mesh-state requires --mesh")
    if args.blackbox and (
        args.chaos or args.reconfig or args.prod_fused or args.autopilot
        or args.reads or args.mesh or args.health or args.lossy >= 0.0
        or args.check_quorum
    ):
        ap.error("--blackbox is its own mode (the instrumented-vs-off "
                 "overhead measurement)")
    return args


def _scenario_line(metric: str, groups: int, stats: dict, **flags) -> dict:
    return {
        "metric": metric,
        "value": stats["median"],
        "unit": "ticks/sec",
        "groups": groups,
        **flags,
        **stats,
    }


def build_line(args) -> dict:
    """Run the mode `args` selects and return its JSON line (not printed)."""
    if args.mesh:
        mesh_stats = bench_mesh(
            args.groups, args.mesh, args.reps, check_quorum=args.check_quorum,
            device=args.device, state_out=args.mesh_state,
        )
        warn_spread("mesh device", mesh_stats)
        line = {
            "metric": "raft_ticks_per_sec_1m_groups_3_peers"
            + ("_cq" if args.check_quorum else "") + "_sharded",
            "value": mesh_stats["median"],
            "unit": "ticks/sec",
            "groups": args.groups,
            **mesh_stats,
        }
        if args.check_quorum:
            line["check_quorum"] = True
        return line
    dev = resolve_device(args.device)
    if args.blackbox:
        bb_stats = bench_blackbox(args.groups, args.reps, device=dev)
        for tag in ("general_off", "general_on", "fused_off"):
            warn_spread(f"blackbox {tag}", bb_stats[tag])
        # No --check gate: the overhead is documented, not a first-class
        # baseline configuration.
        return {
            "metric": "raft_blackbox_overhead",
            "value": bb_stats["blackbox_overhead_pct"],
            "unit": "pct",
            "groups": args.groups,
            "blackbox": True,
            **bb_stats,
        }


    if args.reads:
        stats = bench_reads(
            args.reads, args.groups, args.reps, args.reads_out,
            k=args.split_k, device=dev,
        )
        warn_spread("reads device", stats)
        return _scenario_line(
            "raft_read_ticks_per_sec", args.groups, stats,
            check_quorum=True, pre_vote=True, lease_read=True,
        )

    if args.autopilot:
        stats = bench_autopilot(
            args.groups, args.reps, args.autopilot_plan,
            cadence=args.cadence, out=args.autopilot_out, device=dev,
        )
        warn_spread("autopilot device", stats)
        return _scenario_line(
            "raft_autopilot_ticks_per_sec", args.groups, stats, autopilot=True,
        )

    if args.prod_fused:
        stats = bench_prod_fused(
            args.prod_fused, args.groups, args.reps, args.prod_out,
            k=args.split_k, window=args.split_window, device=dev,
        )
        warn_spread("prod-fused device", stats)
        return _scenario_line(
            "raft_prod_fused_ticks_per_sec", args.groups, stats,
            check_quorum=True, pre_vote=True,
        )

    cq = "_cq" if args.check_quorum else ""
    for mode, fn, out in (("reconfig", bench_reconfig, args.reconfig_out),
                          ("chaos", bench_chaos, args.chaos_out)):
        plan = getattr(args, mode)
        if not plan:
            continue
        stats = fn(plan, args.groups, args.reps, out,
                   check_quorum=args.check_quorum, device=dev)
        warn_spread(f"{mode} device", stats)
        line = _scenario_line(f"raft_{mode}_ticks_per_sec{cq}", args.groups, stats)
        if args.check_quorum:
            line["check_quorum"] = True
        return line

    device = bench_device(
        groups=args.groups,
        reps=args.reps,
        health=args.health,
        profile_dir=args.profile,
        health_out=args.health_out,
        lossy=args.lossy,
        check_quorum=args.check_quorum,
        device=dev,
    )
    anchor = None if args.skip_anchor else bench_scalar_anchor(args.reps)
    # A flagged spread on EITHER side poisons vs_baseline (a ratio of the
    # two medians), so both are checked.
    warn_spread("device", device)
    if anchor is not None:
        warn_spread("native-CPU anchor", anchor)
    # Per-configuration metric key: steady, health-on, chaos-on and
    # check-quorum runs never share one baseline series.
    metric = "raft_ticks_per_sec_100k_groups_5_peers"
    if args.health:
        metric += "_health"
    if args.lossy >= 0.0:
        metric += "_chaos"
    if args.check_quorum:
        metric += "_cq_fused"
    line = {
        "metric": metric,
        "value": device["median"],
        "unit": "ticks/sec",
        "vs_baseline": (
            None
            if anchor is None
            else round(device["median"] / anchor["median"], 2)
        ),
        **device,
        "spread_flagged": device["spread_flagged"]
        or (anchor is not None and anchor["spread_flagged"]),
        "anchor": anchor,
    }
    if args.groups != G:
        line["groups"] = args.groups
    if args.health:
        line["health"] = True
    if args.lossy >= 0.0:
        line["lossy"] = args.lossy
    if args.check_quorum:
        line["check_quorum"] = True
    return line


def enforce_fused_floor(args, line) -> None:
    if args.fused_floor is None:
        return
    if line.get("fused_frac", 0.0) < args.fused_floor:
        print(
            f"ERROR: fused_frac {line.get('fused_frac')} is below "
            f"the --fused-floor {args.fused_floor}: the production "
            "configuration fell off the fused kernel",
            file=sys.stderr,
        )
        raise SystemExit(1)


def main(argv=None) -> dict:
    """Parse `argv` (default sys.argv[1:]), run the mode, print its JSON
    line, apply --fused-floor and --check, and return the line."""
    args = parse_args(argv)
    if not args.mesh:
        # No card and no --device cpu: raise first (--mesh exits 2 then).
        resolve_device(args.device)
    line = build_line(args)
    print(json.dumps(line), flush=True)
    if args.blackbox:
        return line
    if args.mesh:
        if args.check:
            run_check(args, line)
        return line
    if not (args.chaos or args.reconfig):
        enforce_fused_floor(args, line)
    if args.check:
        run_check(args, line)
    return line


if __name__ == "__main__":
    main()
