"""Micro-benchmark suites on the port, counterpart of `benches/suites.py`
(reference: benches/suites/{raft,raw_node,progress}.rs), plus the
BASELINE.json multi-group configs.

    python -m raft_tpu_torch.benches.suites [--quick] [--device cpu]

The scalar suites run on the port's scalar core (raft_tpu_torch/scalar/);
the multi-group configs run on the CUDA card unless --device says
otherwise, each JAX scan of the reference a host loop of rounds.  Prints a
table of results; `python -m raft_tpu_torch.bench` remains the single-line
headline bench.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..multiraft.platform import resolve_device
from ..scalar import Config, Entry, MemStorage, RawNode
from ..scalar.raft import CAMPAIGN_ELECTION, CAMPAIGN_PRE_ELECTION, CAMPAIGN_TRANSFER
from ..scalar.raft_log import NO_LIMIT
from ..scalar.tracker import Progress

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROUNDS = 50  # rounds a timed call of a multi-group config

# (name, groups, peers, append workload) of the BASELINE configs the table
# runs; --quick keeps the first.
BASELINE_CONFIGS = (
    ("config2: 1k x 3 uniform", 1_000, 3, "uniform"),
    ("config3: 100k x 5 zipf", 100_000, 5, "zipf"),
    ("config5: 1M x 3 storm", 1_000_000, 3, "none"),
)


def timeit(fn, iters):
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    return dt / iters


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def quick_raw_node(voters, learners):
    ids = list(range(1, voters + 1))
    learner_ids = list(range(voters + 1, voters + learners + 1))
    storage = MemStorage()
    storage.initialize_with_conf_state((ids or [1], learner_ids))
    cfg = Config(
        id=1,
        election_tick=10,
        heartbeat_tick=1,
        max_size_per_msg=NO_LIMIT,
        max_inflight_msgs=256,
    )
    return RawNode(cfg, storage)


def bench_raft_new(results, iters):
    """reference: benches/suites/raft.rs:30-38"""
    for voters, learners in [(0, 0), (3, 1), (5, 2), (7, 3)]:
        if voters == 0:
            continue
        t = timeit(lambda: quick_raw_node(voters, learners).raft, iters)
        results.append((f"Raft::new ({voters}, {learners})", t * 1e6, "us/op"))


def bench_campaign(results, iters):
    """reference: benches/suites/raft.rs:40-66"""
    for voters, learners in [(3, 1), (5, 2), (7, 3)]:
        for ct, name in [
            (CAMPAIGN_PRE_ELECTION, "PreElection"),
            (CAMPAIGN_ELECTION, "Election"),
            (CAMPAIGN_TRANSFER, "Transfer"),
        ]:
            def run():
                node = quick_raw_node(voters, learners)
                node.raft.campaign(ct)

            t = timeit(run, iters)
            results.append(
                (f"campaign ({voters},{learners}) {name}", t * 1e6, "us/op")
            )


def bench_leader_propose(results, iters):
    """reference: benches/suites/raw_node.rs:35-79"""
    for size in [0, 32, 128, 512, 1024, 4096, 16384, 131072, 524288, 1048576]:
        node = quick_raw_node(1, 0)
        node.campaign()
        while node.has_ready():
            rd = node.ready()
            with node.store.wl() as core:
                core.append(rd.entries)
                if rd.hs is not None:
                    core.set_hardstate(rd.hs.clone())
            node.advance(rd)
            node.advance_apply()
        data = b"x" * size
        n = max(1, min(iters, 2_000_000 // max(size, 1)))

        def run():
            node.propose(b"", data)

        t = timeit(run, n)
        mbps = size / t / 1e6 if t > 0 and size else 0
        results.append((f"leader_propose {size}B", t * 1e6, f"us/op ({mbps:.0f} MB/s)"))


def bench_new_ready(results, iters):
    """Loaded-node ready (reference: benches/suites/raw_node.rs:81-141
    fixture: 100 appended + 100 committed 32KiB entries + messages)."""
    def setup():
        node = quick_raw_node(3, 0)
        node.raft.become_candidate()
        node.raft.become_leader()
        ents = [Entry(data=b"x" * 32 * 1024) for _ in range(100)]
        assert node.raft.append_entry(ents)
        return node

    node = setup()

    def run():
        if node.has_ready():
            rd = node.ready()
            with node.store.wl() as core:
                core.append(rd.entries)
            node.advance(rd)

    t = timeit(run, max(1, iters // 10))
    results.append(("RawNode::ready loaded", t * 1e6, "us/op"))


def bench_progress_new(results, iters):
    """reference: benches/suites/progress.rs:10-17"""
    t = timeit(lambda: Progress(9, 10), iters * 10)
    results.append(("Progress::new", t * 1e9, "ns/op"))


def zipf_append(groups: int, dev: torch.device) -> torch.Tensor:
    """Zipf-skewed per-group append rates (TiKV-style hot regions): a few
    groups take most of the write load; min(Zipf(1.8), 8) from
    RandomState(0)."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(
        np.minimum(rng.zipf(1.8, size=groups), 8).astype(np.int32)
    ).to(dev)


def baseline_config(name: str, G: int, P: int, workload: str, device=None,
                    rounds: int = ROUNDS):
    """One BASELINE multi-group config: the plain step from init_state under
    `workload` (uniform: one append a group a round, zipf: zipf_append,
    none: no appends, the leader-election storm), `rounds` rounds untimed,
    then `rounds` timed.  Returns (name, M ticks/s, unit)."""
    from ..multiraft import sim
    from ..multiraft.sim import SimConfig

    dev = resolve_device(device)
    cfg = SimConfig(n_groups=G, n_peers=P)
    st = sim.init_state(cfg, device=dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    if workload == "zipf":
        append = zipf_append(G, dev)
    else:
        append = torch.full((G,), 1 if workload == "uniform" else 0,
                            dtype=torch.int32, device=dev)

    def multi(st):
        for _ in range(rounds):
            st = sim.step(cfg, st, crashed, append)
        return st

    st = multi(st)
    _sync(dev)
    t0 = time.perf_counter()
    st = multi(st)
    _sync(dev)
    dt = time.perf_counter() - t0
    return (name, G * rounds / dt / 1e6, "M ticks/s")


def bench_baseline_configs(results, quick, device=None):
    """The BASELINE.json multi-group configs on the chosen device (the
    card unless `device` says otherwise); the whole list, then the device
    suites below, unless `quick`."""
    configs = BASELINE_CONFIGS[:1] if quick else BASELINE_CONFIGS
    for name, G, P, workload in configs:
        results.append(baseline_config(name, G, P, workload, device))

    if not quick:
        results.append(bench_config4_reconfig_compiled(device=device))
        results.append(bench_config4_joint_churn(device=device))
        results.append(bench_read_barrier(device=device))
        results.append(bench_reads_workload(device=device))
        results.append(bench_fused_instrumented(device=device))
        results.append(bench_fused_damped(device=device))
        results.append(bench_prod_fused_split(device=device))


def bench_fused_instrumented(G=100_000, P=5, device=None):
    """The instrumented fused path: health planes + an all-up link plane
    with per-link loss threaded through fast_multi_round(with_health,
    with_chaos).  election_tick=64 so the conservative lossy steady bound
    clears the k=32 fused horizon."""
    from ..multiraft import fused_step, kernels, sim
    from ..multiraft.sim import SimConfig

    dev = resolve_device(device)
    cfg = SimConfig(
        n_groups=G, n_peers=P, election_tick=64, collect_health=True
    )
    k = 32
    kstep = fused_step.fast_multi_round(cfg, k=k, with_health=True, with_chaos=True)
    st = sim.init_state(cfg, device=dev)
    h = sim.init_health(cfg, dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones((G,), dtype=torch.int32, device=dev)
    link = torch.ones((P, P, G), dtype=torch.bool, device=dev)
    loss = torch.full((P, P, G), kernels.LOSS_SCALE // 100, dtype=torch.int32,
                      device=dev)  # 1% per-link loss
    settle = 3 * cfg.election_tick
    for _ in range(settle):
        st = sim.step(cfg, st, crashed, append)
    if not bool(fused_step.steady_predicate(cfg, st, crashed, k, link)):
        # Same honesty check as the bench's --lossy: never report a
        # general-fallback number under the fused-instrumented label.
        print(
            "WARNING: steady predicate rejects the settled state; "
            "config3i is timing the general fallback",
            file=sys.stderr,
        )

    blocks = 4

    def multi(st, h, rb):
        for i in range(blocks):
            st, h = kstep(st, crashed, append, link, loss, rb + i * k, h)
        return st, h

    st, h = multi(st, h, settle)
    _sync(dev)
    t0 = time.perf_counter()
    st, h = multi(st, h, settle + blocks * k)
    _sync(dev)
    dt = time.perf_counter() - t0
    return (
        f"config3i: {G // 1000}k x {P} fused health+chaos",
        G * blocks * k / dt / 1e6,
        "M ticks/s",
    )


def bench_fused_damped(G=100_000, P=5, device=None):
    """config3cq: health + counters + check-quorum + pre-vote riding the
    fused damped kernel (with_health + with_counters).  election_tick=64
    so the conservative free-running damped bound clears the k=32 fused
    horizon; the recent_active plane rides packed between blocks."""
    from ..multiraft import fused_step, kernels, sim
    from ..multiraft.sim import SimConfig

    dev = resolve_device(device)
    cfg = SimConfig(
        n_groups=G, n_peers=P, election_tick=64, collect_health=True,
        collect_counters=True, check_quorum=True, pre_vote=True,
    )
    k = 32
    kstep = fused_step.fast_multi_round(cfg, k=k, with_health=True,
                                        with_counters=True)
    st = sim.init_state(cfg, device=dev)
    h = sim.init_health(cfg, dev)
    ctrs = kernels.zero_counters(dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones((G,), dtype=torch.int32, device=dev)
    settle = 3 * cfg.election_tick
    for _ in range(settle):
        st = sim.step(cfg, st, crashed, append)
    if not bool(fused_step.steady_predicate(cfg, st, crashed, k)):
        # Same honesty check as the bench's --check-quorum.
        print(
            "WARNING: steady predicate rejects the settled damped state; "
            "config3cq is timing the general fallback",
            file=sys.stderr,
        )

    blocks = 4

    def multi(st, ra, ctrs, h):
        for _ in range(blocks):
            s, ctrs, h = kstep(sim.unpack_ra_carry(st, ra), crashed, append,
                               ctrs, h)
            st, ra = sim.pack_ra_carry(s)
        return st, ra, ctrs, h

    st, ra = sim.pack_ra_carry(st)
    st, ra, ctrs, h = multi(st, ra, ctrs, h)
    _sync(dev)
    t0 = time.perf_counter()
    st, ra, ctrs, h = multi(st, ra, ctrs, h)
    _sync(dev)
    dt = time.perf_counter() - t0
    return (
        f"config3cq: {G // 1000}k x {P} fused health+ctrs+cq+pv",
        G * blocks * k / dt / 1e6,
        "M ticks/s",
    )


def bench_prod_fused_split(G=100_000, device=None):
    """config4f: the full production configuration under membership churn
    through the split-horizon runner.  Delegates to the bench's
    bench_prod_fused so the regime is defined once; the row label carries
    the measured fused fraction."""
    from .. import bench

    path = os.path.join(REPO, "examples", "reconfig", "prod_fused.json")
    stats = bench.bench_prod_fused(path, groups=G, reps=2, device=device)
    return (
        f"config4f: {G // 1000}k x {stats['report']['peers']} split-fused "
        f"prod churn (fused_frac {stats['fused_frac']:.2f})",
        stats["median"] / 1e6,
        "M ticks/s",
    )


def bench_read_barrier(G=100_000, P=5, device=None):
    """The batched linearizable ReadIndex barrier (sim.read_index): reads/s
    the batch can answer on a settled fleet, 50 barriers a timed call."""
    from ..multiraft import sim
    from ..multiraft.sim import SimConfig

    dev = resolve_device(device)
    cfg = SimConfig(n_groups=G, n_peers=P)
    st = sim.init_state(cfg, device=dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones((G,), dtype=torch.int32, device=dev)
    for _ in range(60):  # settle past the split-vote tail: all groups elect
        st = sim.step(cfg, st, crashed, append)
    reads = 50

    def many(st, crashed):
        acc = torch.zeros((G,), dtype=torch.int32, device=dev)
        for _ in range(reads):
            acc = acc + sim.read_index(cfg, st, crashed)
        return acc

    out = sim.read_index(cfg, st, crashed)
    assert int(out.min()) >= 0, "read barrier returned -1 on settled batch"
    many(st, crashed)
    _sync(dev)
    t0 = time.perf_counter()
    many(st, crashed)
    _sync(dev)
    dt = time.perf_counter() - t0
    return (f"read_index: {G // 1000}k x {P} barrier", G * reads / dt / 1e6,
            "M reads/s")


def bench_reads_workload(G=100_000, device=None):
    """config3r: the serving workload (the zipf_mixed client plan) through
    the production damped configuration with the split-fused runner.
    Delegates to the bench's bench_reads; the row label carries the
    measured fused fraction and the read p99."""
    from .. import bench

    path = os.path.join(REPO, "examples", "reads", "zipf_mixed.json")
    stats = bench.bench_reads(path, groups=G, reps=2, device=device)
    return (
        f"config3r: {G // 1000}k x {stats['report']['peers']} zipf "
        f"read/write mix (fused_frac {stats['fused_frac']:.2f}, "
        f"read_p99 {stats['read_p99']}r)",
        stats["median"] / 1e6,
        "M ticks/s",
    )


def bench_config4_reconfig_compiled(G=100_000, device=None):
    """BASELINE config 4, the real protocol: G groups under joint-consensus
    reconfig churn through reconfig.make_runner (the conf entry proposes
    at each group's leader, its mask swap gates on the dual-majority
    commit, and the joint-window safety invariants fold every round)."""
    from ..multiraft import reconfig, sim
    from ..multiraft.sim import SimConfig

    dev = resolve_device(device)
    P = 5
    plan = reconfig.ReconfigPlan(
        name="config4",
        n_peers=P,
        voters=[1, 2, 3],
        phases=[
            reconfig.ReconfigPhase(rounds=12, append=1),
            reconfig.ReconfigPhase(
                rounds=16, append=1,
                op={"enter_joint": [{"add": 4}, {"add": 5}, {"remove": 1}]},
            ),
            reconfig.ReconfigPhase(
                rounds=16, append=1, op={"leave_joint": True}
            ),
            reconfig.ReconfigPhase(
                rounds=16, append=1, op={"add_voter": 1}
            ),
        ],
    )
    cfg = SimConfig(n_groups=G, n_peers=P, collect_health=True)
    compiled = reconfig.compile_plan(plan, G, dev)
    runner = reconfig.make_runner(cfg, compiled)

    def fresh():
        st = sim.init_state(cfg, *reconfig.initial_masks(plan, G, dev), device=dev)
        return st, sim.init_health(cfg, dev), reconfig.init_reconfig_state(st)

    runner(*fresh())  # settle-free first run
    _sync(dev)
    args = fresh()
    _sync(dev)
    t0 = time.perf_counter()
    st, hl, rst, stats, rstats, safety = runner(*args)
    _sync(dev)
    dt = time.perf_counter() - t0
    assert not int(safety.sum()), "config4 run flagged safety violations"
    return (
        f"config4: {G // 1000}k x {P} compiled reconfig churn",
        G * plan.n_rounds / dt / 1e6,
        "M ticks/s",
    )


def bench_config4_joint_churn(G=100_000, device=None):
    """BASELINE config 4, the retired host-barrier methodology (kept as the
    before/after anchor for bench_config4_reconfig_compiled): every k
    rounds a host-side membership barrier swaps the outgoing mask plane
    (enter-joint / leave-joint) between runs of k plain rounds, with no
    conf-entry protocol and no joint-window safety audit."""
    from ..multiraft import sim
    from ..multiraft.sim import SimConfig

    dev = resolve_device(device)
    P = 5
    cfg = SimConfig(n_groups=G, n_peers=P)
    # joint: incoming {1,2,3} && outgoing {3,4,5}; simple: {1,2,3}
    vm = np.zeros((P, G), bool)
    vm[:3] = True
    om_joint = np.zeros((P, G), bool)
    om_joint[2:] = True
    om_none = np.zeros((P, G), bool)
    st = sim.init_state(cfg, torch.from_numpy(vm).to(dev),
                        torch.from_numpy(om_joint).to(dev), device=dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones((G,), dtype=torch.int32, device=dev)

    k = 10

    def multi(st):
        for _ in range(k):
            st = sim.step(cfg, st, crashed, append)
        return st

    st = multi(st)
    _sync(dev)
    t0 = time.perf_counter()
    swaps = 10
    for i in range(swaps):
        # The membership barrier: the host re-uploads the mask plane.
        om = om_none if i % 2 else om_joint
        st = st._replace(outgoing_mask=torch.from_numpy(om).to(dev))
        st = multi(st)
    _sync(dev)
    dt = time.perf_counter() - t0
    return (
        f"config4: {G // 1000}k x {P} joint churn",
        G * k * swaps / dt / 1e6,
        "M ticks/s",
    )


def print_table(results) -> None:
    width = max(len(n) for n, _, _ in results)
    print(f"{'benchmark':<{width}}  value")
    print("-" * (width + 24))
    for name, value, unit in results:
        print(f"{name:<{width}}  {value:>12.2f} {unit}")


def main(argv=None):
    """Run the suites and print the table; returns the (name, value, unit)
    rows."""
    ap = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.benches.suites",
        description=__doc__.split("\n\n")[0],
    )
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    iters = 50 if args.quick else 300

    results = []
    bench_raft_new(results, iters)
    bench_campaign(results, max(10, iters // 10))
    bench_leader_propose(results, iters)
    bench_new_ready(results, iters)
    bench_progress_new(results, iters)
    bench_baseline_configs(results, args.quick, dev)
    print_table(results)
    return results


if __name__ == "__main__":
    main()
