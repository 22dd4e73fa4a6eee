#!/usr/bin/env python3
"""Drive raft_tpu_torch's ported paths on one CUDA card and check them.

    python3 chip_smoke.py [--out results.json]

Five paths, all at 100,000 groups × 5 peers.  Three with one append per
group per round (bench.py's bench_device), each bare and instrumented
(bench.py --health: the counter plane and the health planes ride every
round, and the fused blocks run each kernel's with_health variant):

  steady  election_tick 10: ClusterSim settles 30 general rounds, then
          fast_multi_round(k=32) advances one 32-round block at a time on
          the hand-written CUDA kernel csrc/steady_round.cu whenever the
          steady predicate holds;
  lossy   bench.py --lossy 0.01: election_tick 64, a 192-round settle,
          then fast_multi_round(k=32, with_chaos=True) with an all-up link
          plane and 1% loss on every directed link; a block whose
          predicate holds runs csrc/chaos_round.cu, any other block 32
          link-gated general steps;
  damped  bench.py --check-quorum: election_tick 64 with check_quorum, a
          192-round settle on the damped step, then fast_multi_round(k=32)
          on csrc/damped_round.cu whenever the predicate (with its
          check-quorum boundary proof) holds, any other block 32 damped
          general steps.

and two more:

  chaos     bench.py --chaos examples/chaos/partition_heal.json [--check-
            quorum]: ClusterSim(chaos=plan).run_plan(), the repo's P=5 plan
            (120 rounds: settle, partition, directed link overrides with 50%
            loss on two links, a crash on even groups, heal) on the general
            step with the health planes, the safety invariants folded every
            round;
  composed  bench.py --lossy 0.01 --check-quorum: the check-quorum fleet
            under 1% loss on every directed link through
            hybrid_multi_round(k=32, with_chaos=True): per block, the fused
            damped kernel's with_loss instance when no group storms, the
            storm groups gathered into a general sub-batch beside it when at
            most 4,096 do, and 32 general damped steps otherwise.

Phases, in order, each with its wall seconds; any failure raises and the
script exits nonzero.  The CPU runs of phases 13 and 16 go to a worker
process at phase 13's start and run while the card works.  Every parity phase holds both variants of its
kernel, with_health=False and with_health=True (the latter with a random
ticks_since_commit row), against the plain version on the same cases.
Every path phase runs its path on the card bare and instrumented
(ClusterSim(collect_counters=True, collect_health=True) for the settle,
fast_multi_round(k=32, with_health=True, with_counters=True) for the
blocks), each with the launch counts of both variants zeroed just before it
and read just after, then once on the CPU, instrumented: the reference for
both, since the extras never change the state.  Every SimState field, the
four health planes, window_pos, the counters, the health summary and the
fused and general block counts must be equal; the end-of-run summary is
printed as bench.py --health-out writes it.

  1. device        require CUDA; print the card's name and power limit
  2. build         build the three kernels from csrc/ with nvcc, in parallel;
                   print the times and ptxas registers and spills per P and
                   template flag
  3. parity        the steady kernel against its plain PyTorch version on
                   the same card tensors, exact: settled states at
                   G=100,000 and a ragged G=100,003 (P=5), at P=3, and
                   random planes
  4. main          the steady path: 30 settle rounds, 4 blocks
  5. timing        the steady path on the bench's schedule (64-round
                   scans, 6 scans a rep, median of 5 reps): ticks/s,
                   fused_frac, the kernel's device time (one call captured
                   in a CUDA graph and replayed between CUDA events: cold
                   with L2 flushed before each launch, and hot), the plain
                   version's time, the block and its parts (CUDA events),
                   the device's busy share and time by kernel
                   (torch.profiler); and the steady kernel's time by each
                   timing method (graph replay, torch.profiler, CUDA
                   events around a launch queued behind a sleep kernel)
                   with the event methods' floor
  6. chaos parity  the chaos kernel against its plain version, exact:
                   lossy-settled states at G=100,000, G=100,003 (P=5) and
                   P=3, each with and without crashed followers, under 1%
                   and the heavy-loss layout, with the round base small
                   and near 2**31 - 32; random planes at P=3, 5 and 7
  7. lossy         the lossy path at G=8,192 from init_state (192 settle
                   rounds, 4 blocks), bare, on the card and the CPU; then
                   the main path at G=100,000 from phase 6's settled state
                   (2 blocks on the healed plane, 1 with a link down in 1%
                   of groups, which forces the general branch)
  8. lossy timing  as phase 5, for the lossy path and the chaos kernel
  9. damped parity the damped kernel against its plain version, exact:
                   damped-settled states at G=100,000, G=100,003 (P=5) and
                   P=3, each with and without crashed followers, without
                   loss and under 1% and the heavy-loss layout (round base
                   small and near 2**31 - 32); with_cq off on a
                   pre-vote-settled state; random planes at P=3, 5 and 7
 10. damped        the check-quorum path: at G=8,192 from init_state (one
                   instrumented 192-round settle each on the card and the
                   CPU, then 4 blocks), then the main path at G=100,000
                   from phase 9's settled state (2 fused blocks, then 3
                   with the acting leader crashed in 1% of groups: general
                   blocks with check-quorum step-downs and elections);
                   recent_active included
 11. damped timing as phase 5, for the damped path and kernel; fused_frac
                   must be 1.0
 12. health timing as phase 5 for the steady and the check-quorum path with
                   the health planes threaded as bench.py --health does
                   (fused_frac must be 1.0), and the lossy with_health
                   kernel's device time cold and hot
 13. chaos scenario the plan with check_quorum off and on on the card, at
                   G=8,192 and at G=100,000 (no fused launch, zero safety
                   counts), timed as bench_chaos does (G x rounds / wall
                   from a fresh state, median of 3 reps, fused_frac 0) with
                   the busy share of its first 4 rounds; then held to the
                   CPU run at G=8,192: equal reports, every field and the
                   health planes, and the 100k run's first 8,192 groups
 14. composed timing as phase 5 for the composed path from phase 9's settled
                   state as it is (3 reps of one scan; fused_frac as
                   measured; the busy share of 4 of the general rounds its
                   blocks run), with the damped kernel's with_loss instance
                   against its bound
 15. steady hybrid one hybrid_multi_round(k=32) block on the steady path from
                   phase 4's state with the acting leader crashed in 1% of
                   groups (split), card == CPU
 16. composed      from phase 9's settled state with the leaders' boundary
                   phases aligned, three blocks on the card: no boundary in
                   the horizon (pure), every boundary in it (slow), the
                   acting leader crashed in 1% of groups (split); held to
                   the CPU run on every field and the fused count; then the
                   damped kernel against its plain version on the split
                   block's operands, storm groups included
 17. report        one JSON line of the seven kernel rows (the six variants
                   and the damped kernel's with_loss instance), then the
                   device line last

With --quick it runs phases 1 to 3, 6 and 9 only (the builds and every
kernel against its plain version) and prints no result.  Exits 2 without a
result when no CUDA device is available.
"""

import argparse
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import torch

from raft_tpu_torch.multiraft import _build, chaos, fused_step, kernels as pk, sim
from raft_tpu_torch.multiraft.health import HealthMonitor
from raft_tpu_torch.multiraft.chaos_kernel import (
    OUTPUT_NAMES as CHAOS_OUTPUTS,
    chaos_rounds,
    chaos_rounds_reference,
    chaos_work,
)
from raft_tpu_torch.multiraft.damped_kernel import (
    OUTPUT_NAMES as DAMPED_OUTPUTS,
    damped_rounds,
    damped_rounds_reference,
    damped_work,
)
from raft_tpu_torch.multiraft.kernels import LOSS_SCALE, ROLE_LEADER, link_loss_draw
from raft_tpu_torch.multiraft.steady_kernel import (
    steady_rounds,
    steady_rounds_reference,
    steady_work,
)

G, P, K = 100_000, 5, 32
SETTLE = 30
MAIN_BLOCKS = 4
LOSSY_TICK = 64  # the lossy predicate's free-running bound must clear k=32
LOSSY_SETTLE = 3 * LOSSY_TICK
LOSS = LOSS_SCALE // 100  # 1% per directed link
LOSSY_SMALL_G, LOSSY_SMALL_BLOCKS = 8192, 4
CQ_TICK = 64  # bench.py --check-quorum: the damped bound is free-running too
CQ_SETTLE = 3 * CQ_TICK
CQ_SMALL_G, CQ_SMALL_BLOCKS = 8192, 4
CQ_FUSED_BLOCKS, CQ_CRASH_BLOCKS = 2, 3
CHAOS_PLAN_NAME = "examples/chaos/partition_heal.json"
CHAOS_PLAN = os.path.join(os.path.dirname(os.path.abspath(__file__)), CHAOS_PLAN_NAME)
CHAOS_SMALL_G, CHAOS_REPS, CHAOS_PROFILE_ROUNDS = 8192, 3, 4
STORM_EVERY = 100  # the acting leader crashed in 1% of groups
# The composed path's parity blocks from the aligned state: no boundary in
# the first horizon, every boundary in the second, then 1% of leaders down.
COMPOSED_BRANCHES, COMPOSED_CRASH_BLOCK, COMPOSED_REPS = ("pure", "slow", "split"), 2, 3
ROUNDS_PER_SCAN, SCANS, REPS = 64, 6, 5
SLEEP_CYCLES = 4_000_000  # about 2 ms at the H100's 1.98 GHz boost clock
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# H100 SXM INT32 rate: the published 67 TFLOP/s float32 counts an FMA as two
# operations on 128 FP32 lanes an SM; an SM has 64 INT32 lanes (NVIDIA H100
# Tensor Core GPU Architecture whitepaper; CUDA C++ Programming Guide,
# arithmetic instruction throughput for compute capability 9.0: 64 results a
# clock an SM for 32-bit integer add, compare, min/max, logic and shift), so
# one operation a lane a clock is a quarter of that figure.  Both kernels'
# work is 32-bit integer operations.
OPS_PER_S = 67e12 / 4
STEADY_SOURCE = "raft_tpu_torch/multiraft/csrc/steady_round.cu"
STEADY_REPLACES = "raft_tpu/multiraft/pallas_step.py:116"
CHAOS_SOURCE = "raft_tpu_torch/multiraft/csrc/chaos_round.cu"
CHAOS_REPLACES = "raft_tpu/multiraft/pallas_step.py:297"
DAMPED_SOURCE = "raft_tpu_torch/multiraft/csrc/damped_round.cu"
DAMPED_REPLACES = "raft_tpu/multiraft/pallas_step.py:889"
KERNELS = (steady_rounds, chaos_rounds, damped_rounds)
# ptxas registers and spills by library and template instance, for --out.
PTXAS = {}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase(name):
    """Decorator printing a phase's wall seconds after it returns."""
    def wrap(fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]", flush=True)
            return out
        return run
    return wrap


@phase("build")
def phase_build():
    """The three kernels built at once, one nvcc per source."""
    loaders = {"steady_round": _build.load_steady_cuda,
               "chaos_round": _build.load_chaos_cuda,
               "damped_round": _build.load_damped_cuda}
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()  # raises a failed build's error
    for name in loaders:
        log, secs = _build.build_log.get(name, ("(cached build)", 0.0))
        PTXAS[name] = {"seconds": secs, "instances": {}}
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # The template arguments: P, then the flags (the damped
                # kernel's cq and loss), with_health last.
                args = line.split("ILi")[1].split("EE")[0].split("ELb") if "ILi" in line else ["?"]
                flags = ("cq", "loss", "health")[-(len(args) - 1):] if len(args) > 1 else ()
                entry = " ".join([f"P={args[0]}"] + [
                    f"{f}={v}" for f, v in zip(flags, args[1:])])
            elif "Used" in line and "registers" in line:
                regs = int(line.split("Used")[1].split("registers")[0])
                PTXAS[name]["instances"].setdefault(entry, {})["registers"] = regs
            elif "spill stores" in line:
                spill = int(line.split("bytes spill stores")[0].split(",")[-1])
                PTXAS[name]["instances"].setdefault(entry, {})["spill_stores"] = spill
        inst = PTXAS[name]["instances"]
        print(f"build: {name}.cu in {secs:.2f}s, {len(inst)} instances; ptxas "
              "registers (spill-store bytes where nonzero):")
        for entry in sorted(inst):
            r = inst[entry]
            spill = f" ({r['spill_stores']} B spilled)" if r.get("spill_stores") else ""
            print(f"  {entry}: {r.get('registers')}{spill}")


# --- the steady path -------------------------------------------------------


def settle_on(device, n_groups, n_peers):
    cfg = sim.SimConfig(n_groups=n_groups, n_peers=n_peers)
    s = sim.ClusterSim(cfg, device=device)
    s.run(SETTLE, None, torch.ones(n_groups, dtype=torch.int32, device=s.device))
    return s.state


def random_inputs(n_peers, n_groups, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def ints(hi, shape=(n_peers, n_groups)):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(device)

    def bools(p):
        return (torch.rand((n_peers, n_groups), generator=gen) < p).to(device)

    return (ints(3), ints(5), ints(12), ints(3), ints(40), ints(5), ints(40),
            ints(40), bools(0.8), bools(0.9), bools(0.2), ints(40, (n_groups,)),
            ints(3, (n_groups,)))


def compare(kernel, reference, names, args, kw, note, tsc=None):
    """Kernel vs plain version on the same card tensors, exact; with `tsc`
    (a ticks_since_commit row) the with_health variant.  Returns the max
    |difference| (0)."""
    if tsc is not None:
        args, names = args + (tsc,), names + ("tsc",)
    got = kernel(*args, **kw)
    want = reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{note}: {name} is {g.dtype} {tuple(g.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{note} with_health={tsc is not None}: kernel and "
                                 f"plain version differ in {name}")
    return err


def random_tsc(n_groups, seed, device):
    """A random ticks_since_commit row: int32 [G] in [0, 100)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, 100, (n_groups,), generator=gen,
                         dtype=torch.int32).to(device)


def compare_variants(kernel, reference, names, args, kw, note):
    """compare() for both variants of a kernel on the same operands:
    (max |difference| of with_health=False, of with_health=True)."""
    n_groups, dev = args[0].shape[1], args[0].device
    tsc = random_tsc(n_groups, n_groups + len(note), dev)
    errs = (compare(kernel, reference, names, args, kw, note),
            compare(kernel, reference, names, args, kw, note, tsc))
    print(f"parity {note}: exact, both variants ({len(names)} outputs, and tsc; "
          f"{n_groups} groups)")
    return errs


def worst(a, b):
    """Elementwise max of two (plain, with_health) error pairs."""
    return tuple(max(x, y) for x, y in zip(a, b))


def compare_kernel(args, rounds, note):
    kw = dict(rounds=rounds, election_tick=10, heartbeat_tick=1)
    return compare_variants(steady_rounds, steady_rounds_reference,
                            ("ee", "hb", "li", "lt", "matched", "commit"), args,
                            kw, note)


def crash_followers(st, n_peers, n_groups, dev):
    """bool[P, G]: the peer after each group's leader is down in every
    third group."""
    crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
    lead = st.state.eq(ROLE_LEADER).to(torch.int64).argmax(0)
    idx = torch.arange(n_groups, device=dev)
    crashed[(lead + 1) % n_peers, idx] = idx % 3 == 0
    return crashed


@phase("parity")
def phase_parity(dev):
    """Returns (plain, with_health) max |difference|."""
    err = (0, 0)
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3)):
        st = settle_on(dev, n_groups, n_peers)
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
        err = worst(err, compare_kernel(
            fused_step.steady_operands(st, crashed, append), K,
            f"settled G={n_groups} P={n_peers}"))
        crashed = crash_followers(st, n_peers, n_groups, dev)
        err = worst(err, compare_kernel(
            fused_step.steady_operands(st, crashed, append), K,
            f"settled+crashed followers G={n_groups} P={n_peers}"))
    for n_peers in (3, 5, 7):
        err = worst(err, compare_kernel(
            random_inputs(n_peers, G + 3, n_peers, dev), K,
            f"random planes G={G + 3} P={n_peers}"))
    return err


def run_main_path(device):
    """init_state + SETTLE general rounds + MAIN_BLOCKS k=32 blocks."""
    cfg = sim.SimConfig(n_groups=G, n_peers=P)
    s = sim.ClusterSim(cfg, device=device)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=s.device)
    append = torch.ones(G, dtype=torch.int32, device=s.device)
    s.run(SETTLE, crashed, append)
    block = fused_step.fast_multi_round(cfg, k=K, count_fused=True)
    st, fused = s.state, 0
    for _ in range(MAIN_BLOCKS):
        st, fused = block(st, crashed, append, fused)
    return cfg, st, fused


def check_state(st, n_groups=G):
    """Shapes, dtypes and the protocol's own invariants after a path."""
    for f, v in st._asdict().items():
        if v is None:
            continue
        want = torch.bool if f.endswith("_mask") or f == "recent_active" else torch.int32
        pairs = ("matched", "agree", "recent_active")
        shape = (P, P, n_groups) if f in pairs else (P, n_groups)
        if v.dtype != want or tuple(v.shape) != shape:
            raise AssertionError(f"{f}: {v.dtype} {tuple(v.shape)}")
    # The bench's sanity rule: every group committed something.
    if int(st.commit.amax(0).min()) <= 0:
        raise AssertionError("some group never committed")


def assert_same(st_gpu, st_cpu, note):
    for f in st_gpu._fields:
        a, b = getattr(st_gpu, f), getattr(st_cpu, f)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            raise AssertionError(f"{note}: card and CPU differ in {f}")


@phase("main")
def phase_main(dev):
    """The steady path on the card, bare and instrumented, then once on the
    CPU (instrumented), the reference for both.  Returns (cfg, the bare
    final state, its steady kernel launches, the instrumented card run, its
    with_health launches)."""
    zero_launches()
    t0 = time.perf_counter()
    cfg, st_gpu, fused = run_main_path(dev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = bare_launches(steady_rounds, "the steady main path")
    check_state(st_gpu)
    run, ref, h_launches = instrumented_pair(
        dev, "steady", steady_rounds, (MAIN_BLOCKS, 0), cfg=cfg, blocks=MAIN_BLOCKS,
        settle=SETTLE)
    same_as_reference((st_gpu, fused, 0), ref, "steady main path")
    print(f"main path {G}x{P}: {SETTLE} settle rounds + {MAIN_BLOCKS} blocks of "
          f"{K}: card == CPU on all {len(st_gpu._fields)} fields (commit max "
          f"{int(st_gpu.commit.max())}); steady kernel launches {launches}; "
          f"fused {fused}/{MAIN_BLOCKS * K * G}; card {t_gpu:.2f}s")
    return cfg, st_gpu, launches, run, h_launches


# --- timing helpers ----------------------------------------------------------


def cuda_ms(fn, reps, flush=None):
    """Median milliseconds of a fn() call by CUDA events, one pair per call
    (host time spent inside the call while the card waits included); with
    `flush`, it runs before each pair, outside it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def kernel_device_ms(fn, reps, flush=None):
    """Device milliseconds per launch of the one kernel that fn() launches.
    The call is captured once into a CUDA graph and the graph replayed, so
    no host work sits between the events around a launch.  With `flush`
    (run before each replay, outside the timed pair: the kernel finds its
    operands cold) the median of `reps` single replays; without it, `reps`
    replays back to back between one pair of events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if flush is None:
        e0.record()
        for _ in range(reps):
            graph.replay()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
    times = []
    for _ in range(reps):
        flush()
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def queued_ms(fn, reps, flush=None):
    """Milliseconds of fn()'s device work by CUDA events around a plain
    launch that the host queued behind a sleep kernel (about 2 ms), so the
    card never waits for the host between the events.  With `flush` (before
    the sleep) the median of `reps` single calls; without it, `reps` calls
    back to back between one pair of events."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if flush is None:
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps
    times = []
    for _ in range(reps):
        flush()
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def profiler_ms(fn, name, reps, flush=None):
    """(ms, launches seen): torch.profiler's device time a launch of the
    kernel whose name contains `name` over `reps` calls of fn() (`flush`
    before each), the mean over the launches it recorded; ms is None when
    it recorded none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in rows)
    us = sum(e.self_device_time_total for e in rows)
    return (us / count / 1e3 if count else None), count


def timing_methods(dev, launch, kernel_name, flush, reps=30):
    """One kernel's device time cold and hot by three methods on the same
    operands in one run, and what the two event methods measure around a
    one-element add (their floor: the part of a reading that is the method's
    own, not the kernel's).  `graph` is kernel_device_ms, `profiler`
    profiler_ms, `events` queued_ms."""
    tiny = torch.zeros(1, dtype=torch.int32, device=dev)

    def add():
        tiny.add_(1)

    graph = (kernel_device_ms(launch, reps, flush), kernel_device_ms(launch, reps))
    (p_cold, n_cold), (p_hot, n_hot) = (profiler_ms(launch, kernel_name, reps, flush),
                                        profiler_ms(launch, kernel_name, reps))
    events = (queued_ms(launch, reps, flush), queued_ms(launch, reps))
    graph_floor = (kernel_device_ms(add, reps, flush), kernel_device_ms(add, reps))
    events_floor = (queued_ms(add, reps, flush), queued_ms(add, reps))

    def show(pair):
        return " / ".join("not recorded" if x is None else f"{x:.4f}" for x in pair)

    print(f"timing methods, {kernel_name} ms cold / hot: graph replay {show(graph)}; "
          f"profiler {show((p_cold, p_hot))} ({n_cold} and {n_hot} of {reps} launches "
          f"recorded); events behind a sleep {show(events)}; a one-element add: graph "
          f"replay {show(graph_floor)}, events behind a sleep {show(events_floor)}")
    return dict(graph=graph, profiler=(p_cold, p_hot), profiler_seen=(n_cold, n_hot),
                events=events, graph_floor=graph_floor, events_floor=events_floor)


def device_profile(run):
    """torch.profiler over run(): the device's busy share of the wall time
    and the device time by kernel name, largest first.  The profiler's own
    host cost lengthens the wall time, so the idle share it implies is an
    upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(
        ((e.key, e.self_device_time_total, e.count)
         for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in kernels)
    return dict(wall_us=wall_us, busy_us=busy_us,
                busy_share=busy_us / wall_us if wall_us else 0.0,
                kernels=[dict(name=k[:120], us=us, count=n) for k, us, n in kernels])


def time_path(dev, label, st, rb, block, operands, kernel, reference, kernel_name,
              fused_round, predicate, work, compare_methods=False, reps=REPS,
              scans=SCANS, part_reps=10, profile=None):
    """The bench's timed loop over `block(st, rb, fused) -> (st, fused)`
    (rb the absolute round of the block's first round; `st` is the loop's
    carry: a SimState, or (SimState, HealthState) on a health path), `reps`
    reps of `scans` scans, then the parts of one block from the loop's final
    state: the kernel (`kernel(*args, **kw)` with `operands(st, rb) ->
    (args, kw)`), its plain version, the fused round, the predicate and the
    block (`part_reps` calls each), and a profile of one rep, or with
    `profile` = (what, fn) of fn(st, rb).  With `compare_methods`, the
    kernel's time by each timing method as well."""
    blocks_per_scan = ROUNDS_PER_SCAN // K
    for _ in range(blocks_per_scan):  # warm-up scan, as the bench does
        st, _ = block(st, rb, 0)
        rb += K
    torch.cuda.synchronize()
    samples, fused_total = [], 0
    ticks = G * ROUNDS_PER_SCAN * scans
    for _ in range(reps):
        fused = 0
        t0 = time.perf_counter()
        for _ in range(scans * blocks_per_scan):
            st, fused = block(st, rb, fused)
            rb += K
        torch.cuda.synchronize()
        samples.append(ticks / (time.perf_counter() - t0))
        fused_total += fused
    fused_frac = fused_total / (ticks * reps)

    args, kw = operands(st, rb)
    t = kernel_times(dev, kernel, reference, args, kw, work, parts=dict(
        fused_round_ms=lambda: fused_round(st, rb),
        predicate_ms=lambda: bool(predicate(st)),
        block_ms=lambda: block(st, rb, 0)),
        methods_of=kernel_name if compare_methods else None, part_reps=part_reps)

    def one_rep():
        s, r = st, rb
        for _ in range(scans * blocks_per_scan):
            s, _ = block(s, r, 0)
            r += K

    what, run = profile or (f"one {label} rep ({scans * blocks_per_scan} blocks)", None)
    prof = device_profile(one_rep if run is None else lambda: run(st, rb))
    loop_block_ms = statistics.median(ticks / x for x in samples) * 1e3 / (
        scans * blocks_per_scan)

    med = statistics.median(samples)
    t.update(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=fused_frac,
             loop_block_ms=loop_block_ms, profile=prof,
             wrapper_ms=t["fused_round_ms"] - t["call_ms"])
    print(f"timing {label} {G}x{P} k={K} [{t['card']}]: ticks/s median {med:.1f} "
          f"(min {min(samples):.1f}, max {max(samples):.1f}, {reps} reps of {scans} "
          f"scans), "
          f"fused_frac {fused_frac:.4f}; {kernel_name} {t['ms']:.4f} ms cold "
          f"({t['hot_ms']:.4f} ms hot; a wrapper call {t['call_ms']:.4f} ms), "
          f"plain version {t['plain_ms']:.3f} ms; "
          f"block {loop_block_ms:.3f} ms in the loop, {t['block_ms']:.3f} ms alone = "
          f"predicate {t['predicate_ms']:.3f} + fused round {t['fused_round_ms']:.3f} "
          f"(wrapper {t['wrapper_ms']:.3f} + the kernel call); bound "
          f"{t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f})")
    print(f"profile of {what}: device "
          f"busy {prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%)")
    for row in prof["kernels"][:8]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return t


def kernel_times(dev, kernel, reference, args, kw, work, parts=None,
                 methods_of=None, part_reps=10):
    """`kernel(*args, **kw)`'s device time cold (L2 flushed before each
    launch) and hot, a wrapper call and its plain version on the same
    operands, each of `parts` ({name: fn}, `part_reps` calls, L2 flushed
    before each) by CUDA events, and the bound of `work` (bytes,
    operations).
    With `methods_of` (the kernel's name), also timing_methods on the same
    operands."""
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.fill_(1)  # 256 MB written: the 50 MB L2 holds none of the operands

    def launch():
        kernel(*args, **kw)

    t = dict(ms=kernel_device_ms(launch, 30, flush), hot_ms=kernel_device_ms(launch, 30),
             call_ms=cuda_ms(launch, 30, flush),
             plain_ms=cuda_ms(lambda: reference(*args, **kw), 5, flush))
    for name, fn in (parts or {}).items():
        t[name] = cuda_ms(fn, part_reps, flush)
    if methods_of is not None:
        t["methods"] = timing_methods(dev, launch, methods_of, flush)
    del scratch
    nbytes, ops = work
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    t.update(bound_ms=max(bytes_ms, ops_ms), bytes_bound_ms=bytes_ms,
             ops_bound_ms=ops_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=nbytes, operations=ops, card=card_line())
    return t


@phase("timing")
def phase_timing(dev, cfg, st):
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    fast = fused_step.fast_multi_round(cfg, k=K, count_fused=True)
    round_fn = fused_step.steady_round(cfg, rounds=K)
    kw = dict(rounds=K, election_tick=cfg.election_tick,
              heartbeat_tick=cfg.heartbeat_tick)
    return time_path(
        dev, "steady", st, 0,
        block=lambda s, rb, f: fast(s, crashed, append, f),
        operands=lambda s, rb: (fused_step.steady_operands(s, crashed, append), kw),
        kernel=steady_rounds, reference=steady_rounds_reference,
        kernel_name="steady_round_kernel",
        fused_round=lambda s, rb: round_fn(s, crashed, append),
        predicate=lambda s: fused_step.steady_predicate(cfg, s, crashed, K),
        work=steady_work(P, G, K), compare_methods=True,
    )


# --- the lossy path ----------------------------------------------------------


def lossy_cfg(n_groups, n_peers=P):
    return sim.SimConfig(n_groups=n_groups, n_peers=n_peers, election_tick=LOSSY_TICK)


def lossy_settle(device, n_groups, n_peers=P):
    """init_state and LOSSY_SETTLE plain rounds of one append per group."""
    s = sim.ClusterSim(lossy_cfg(n_groups, n_peers), device=device)
    s.run(LOSSY_SETTLE, None,
          torch.ones(n_groups, dtype=torch.int32, device=s.device))
    return s.state


def uniform_loss(n_groups, n_peers, dev):
    return torch.full((n_peers, n_peers, n_groups), LOSS, dtype=torch.int32, device=dev)


def heavy_loss(n_groups, n_peers, dev):
    """tests/test_pallas_step.py:_loss_plane's layout: heavy loss on a few
    directed links, none elsewhere."""
    loss = torch.zeros((n_peers, n_peers, n_groups), dtype=torch.int32, device=dev)
    loss[0, 1, :] = 3000
    loss[1, 0, ::2] = 5000
    loss[(n_peers - 1) % n_peers, n_peers // 2, 1::3] = 7000
    return loss


def random_chaos_inputs(n_peers, n_groups, seed, device):
    """Random operand planes: any roles, several or no leaders, crashes,
    masks and loss rates; small enough that no int32 sum wraps."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def ints(hi, shape=(n_peers, n_groups)):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(device)

    def bools(p):
        return (torch.rand((n_peers, n_groups), generator=gen) < p).to(device)

    pp = (n_peers, n_peers, n_groups)
    return (ints(3), ints(n_peers + 1), ints(3), ints(12), ints(40), ints(5),
            ints(40), ints(40), bools(0.8), bools(0.9), bools(0.2), ints(40, pp),
            ints(LOSS_SCALE + 1, pp), ints(40, (n_groups,)), ints(5, (n_groups,)),
            ints(3, (n_groups,)))


def compare_chaos(args, round_base, note, election_tick=LOSSY_TICK):
    kw = dict(round_base=round_base, rounds=K, election_tick=election_tick,
              heartbeat_tick=1)
    return compare_variants(chaos_rounds, chaos_rounds_reference, CHAOS_OUTPUTS,
                            args, kw, f"{note} round_base={round_base}")


@phase("chaos parity")
def phase_chaos_parity(dev):
    """Returns ((plain, with_health) max |difference|, the settled 100k × 5
    lossy state)."""
    err, settled = (0, 0), None
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3)):
        st0 = lossy_settle(dev, n_groups, n_peers)
        if (n_groups, n_peers) == (G, P):
            settled = st0
        cfg = lossy_cfg(n_groups, n_peers)
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        link = torch.ones((n_peers, n_peers, n_groups), dtype=torch.bool, device=dev)
        for loss_name, make_loss in (("1%", uniform_loss), ("heavy", heavy_loss)):
            loss = make_loss(n_groups, n_peers, dev)
            # Four lossy general rounds: lagging and resumed followers.
            st = st0
            for r in range(4):
                eff = link & ~link_loss_draw(LOSSY_SETTLE + r, loss)
                st = sim.step(cfg, st, torch.zeros_like(st.voter_mask), append, link=eff)
            for crashed_name in ("no crashes", "crashed followers"):
                crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
                if crashed_name != "no crashes":
                    crashed = crash_followers(st, n_peers, n_groups, dev)
                args = fused_step.chaos_operands(st, crashed, append, loss)
                for rb in (LOSSY_SETTLE + 4, 2**31 - K):
                    err = worst(err, compare_chaos(
                        args, rb, f"lossy-settled G={n_groups} P={n_peers} "
                        f"{loss_name} loss, {crashed_name}"))
    for n_peers in (3, 5, 7):
        args = random_chaos_inputs(n_peers, G + 3, 10 + n_peers, dev)
        for rb in (7, 2**31 - K):
            err = worst(err, compare_chaos(
                args, rb, f"random planes G={G + 3} P={n_peers}", election_tick=6))
    return err, settled


def run_lossy_path(device, n_groups, blocks, start=None, cut_last=False):
    """The lossy path: from `start` (else init_state and the settle), `blocks`
    k=32 blocks of fast_multi_round(with_chaos=True) on an all-up link
    plane with 1% loss; with `cut_last`, the last block's plane has the
    0 -> 1 link down in 1% of groups.  Returns (state, fused group-rounds,
    blocks that ran the general branch)."""
    cfg = lossy_cfg(n_groups)
    st = lossy_settle(device, n_groups) if start is None else start
    dev = st.term.device
    crashed = torch.zeros((P, n_groups), dtype=torch.bool, device=dev)
    append = torch.ones(n_groups, dtype=torch.int32, device=dev)
    link = torch.ones((P, P, n_groups), dtype=torch.bool, device=dev)
    loss = uniform_loss(n_groups, P, dev)
    block = fused_step.fast_multi_round(cfg, k=K, with_chaos=True, count_fused=True)
    fused, general, rb = 0, 0, LOSSY_SETTLE
    for b in range(blocks):
        ln = link
        if cut_last and b == blocks - 1:
            ln = link.clone()
            ln[0, 1, ::100] = False
        prev = fused
        st, fused = block(st, crashed, append, ln, loss, rb, fused)
        general += fused == prev
        rb += K
    return st, fused, general


@phase("lossy")
def phase_lossy(dev, settled):
    """The lossy path: at G=8,192 from init_state on the card and the CPU;
    at G=100,000 from the settled state on the card, bare and
    instrumented, then once on the CPU (instrumented), the reference for
    both.  Returns (the bare 100k state, its chaos kernel launches, the
    instrumented card run, its with_health launches)."""
    t0 = time.perf_counter()
    zero_launches()
    small = run_lossy_path(dev, LOSSY_SMALL_G, LOSSY_SMALL_BLOCKS)
    small_launches = bare_launches(chaos_rounds, f"the lossy path at G={LOSSY_SMALL_G}")
    # The main path at full size, its launches counted alone.
    zero_launches()
    full = run_lossy_path(dev, G, 3, start=settled, cut_last=True)
    launches = bare_launches(chaos_rounds, f"the lossy path at G={G}")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if full[2] <= 0:
        raise AssertionError(f"the lossy path at G={G} never ran the general branch")
    check_state(small[0], LOSSY_SMALL_G)
    check_state(full[0])
    t0 = time.perf_counter()
    small_cpu = run_lossy_path("cpu", LOSSY_SMALL_G, LOSSY_SMALL_BLOCKS)
    t_cpu = time.perf_counter() - t0
    assert_same(small[0], small_cpu[0], f"lossy G={LOSSY_SMALL_G}")
    if small[1:] != small_cpu[1:]:
        raise AssertionError(f"lossy G={LOSSY_SMALL_G}: fused/general counts differ "
                             f"{small[1:]} {small_cpu[1:]}")
    cfg = lossy_cfg(G)
    run, ref, h_launches = instrumented_pair(
        dev, "lossy", chaos_rounds, (2, 1),
        cpu_start=fresh_start(on_cpu(settled), cfg), cfg=cfg, blocks=3,
        start=fresh_start(settled, cfg), chaos=True, round_base=LOSSY_SETTLE,
        cut_last=True)
    same_as_reference(full, ref, f"lossy G={G}")
    print(f"lossy path {LOSSY_SMALL_G}x{P} (init, {LOSSY_SETTLE} settle rounds, "
          f"{LOSSY_SMALL_BLOCKS} blocks; fused {small[1]}, general blocks {small[2]}) "
          f"and {G}x{P} (settled, 3 blocks, the last with a link down in 1% of "
          f"groups; fused {full[1]}, general blocks {full[2]}): card == CPU on all "
          f"{len(settled._fields)} fields; chaos kernel launches {small_launches} "
          f"at G={LOSSY_SMALL_G} and {launches} at G={G} (the main path's count); "
          f"card {t_gpu:.2f}s, CPU (G={LOSSY_SMALL_G}) {t_cpu:.2f}s")
    return full[0], launches, run, h_launches


@phase("lossy timing")
def phase_lossy_timing(dev, st):
    cfg = lossy_cfg(G)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    link = torch.ones((P, P, G), dtype=torch.bool, device=dev)
    loss = uniform_loss(G, P, dev)
    fast = fused_step.fast_multi_round(cfg, k=K, with_chaos=True, count_fused=True)
    round_fn = fused_step.chaos_round(cfg, rounds=K)

    def operands(s, rb):
        return fused_step.chaos_operands(s, crashed, append, loss), dict(
            round_base=rb, rounds=K, election_tick=cfg.election_tick,
            heartbeat_tick=cfg.heartbeat_tick)

    return time_path(
        dev, "lossy", st, LOSSY_SETTLE + 3 * K,
        block=lambda s, rb, f: fast(s, crashed, append, link, loss, rb, f),
        operands=operands, kernel=chaos_rounds, reference=chaos_rounds_reference,
        kernel_name="chaos_round_kernel",
        fused_round=lambda s, rb: round_fn(s, crashed, append, loss, rb),
        predicate=lambda s: fused_step.steady_predicate(
            cfg, s, crashed, K, link, loss_rate=loss),
        work=chaos_work(P, G, K),
    )


# --- the damped (check-quorum) path -------------------------------------------


def damped_cfg(n_groups, n_peers=P, pre_vote=False):
    """bench.py --check-quorum's config; with `pre_vote`, pre-vote alone."""
    return sim.SimConfig(n_groups=n_groups, n_peers=n_peers, election_tick=CQ_TICK,
                         check_quorum=not pre_vote, pre_vote=pre_vote)


def damped_settle(device, n_groups, n_peers=P, pre_vote=False):
    """init_state and CQ_SETTLE damped rounds of one append per group."""
    s = sim.ClusterSim(damped_cfg(n_groups, n_peers, pre_vote), device=device)
    s.run(CQ_SETTLE, None, torch.ones(n_groups, dtype=torch.int32, device=s.device))
    return s.state


def random_damped_inputs(n_peers, n_groups, seed, device, loss):
    """Random damped-kernel operands: any roles, several or no leaders,
    crashes, masks, recent_active rows and (with `loss`) loss rates."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def ints(hi, shape=(n_peers, n_groups)):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(device)

    def bools(p):
        return (torch.rand((n_peers, n_groups), generator=gen) < p).to(device)

    pp = (n_peers, n_peers, n_groups)
    return (ints(3), ints(n_peers + 1), ints(3), ints(12), ints(40), ints(5),
            ints(40), ints(40), bools(0.5), bools(0.8), bools(0.9), bools(0.2),
            ints(40, pp), ints(LOSS_SCALE + 1, pp) if loss else None,
            ints(40, (n_groups,)), ints(5, (n_groups,)), ints(3, (n_groups,)))


def compare_damped(args, note, with_cq=True, round_base=CQ_SETTLE,
                   election_tick=CQ_TICK):
    kw = dict(round_base=round_base, rounds=K, election_tick=election_tick,
              heartbeat_tick=1, with_cq=with_cq)
    return compare_variants(damped_rounds, damped_rounds_reference, DAMPED_OUTPUTS,
                            args, kw, f"{note} cq={with_cq} round_base={round_base}")


@phase("damped parity")
def phase_damped_parity(dev):
    """Returns ((plain, with_health) max |difference| over every case, the
    same over the with_loss cases alone, the settled 100k × 5 damped
    state)."""
    err, loss_err, settled = (0, 0), (0, 0), None
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3)):
        st = damped_settle(dev, n_groups, n_peers)
        if (n_groups, n_peers) == (G, P):
            settled = st
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        for crashed_name in ("no crashes", "crashed followers"):
            crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
            if crashed_name != "no crashes":
                crashed = crash_followers(st, n_peers, n_groups, dev)
            note = f"damped-settled G={n_groups} P={n_peers} {crashed_name}"
            err = worst(err, compare_damped(
                fused_step.damped_operands(st, crashed, append), note))
            for loss_name, make_loss in (("1%", uniform_loss), ("heavy", heavy_loss)):
                args = fused_step.damped_operands(
                    st, crashed, append, make_loss(n_groups, n_peers, dev))
                for rb in (CQ_SETTLE, 2**31 - K):
                    loss_err = worst(loss_err, compare_damped(
                        args, f"{note} {loss_name} loss", round_base=rb))
    st = damped_settle(dev, G, P, pre_vote=True)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    for loss in (None, uniform_loss(G, P, dev)):
        e = compare_damped(
            fused_step.damped_operands(st, crashed, append, loss),
            f"pre-vote-settled G={G} P={P} loss={loss is not None}", with_cq=False)
        if loss is None:
            err = worst(err, e)
        else:
            loss_err = worst(loss_err, e)
    for n_peers in (3, 5, 7):
        for with_cq in (False, True):
            for loss in (False, True):
                args = random_damped_inputs(n_peers, G + 3, 20 + n_peers, dev, loss)
                e = compare_damped(
                    args, f"random planes G={G + 3} P={n_peers} loss={loss}",
                    with_cq=with_cq, round_base=2**31 - K, election_tick=6)
                if loss:
                    loss_err = worst(loss_err, e)
                else:
                    err = worst(err, e)
    return worst(err, loss_err), loss_err, settled


def run_damped_path(device, n_groups, blocks, start=None, crash_blocks=0):
    """The check-quorum path: from `start` (else init_state and the
    settle), `blocks` k=32 blocks of fast_multi_round, then `crash_blocks`
    with the acting leader crashed in every hundredth group.  Returns
    (state, fused group-rounds, general blocks, the state before the crash
    blocks)."""
    cfg = damped_cfg(n_groups)
    st = damped_settle(device, n_groups) if start is None else start
    dev = st.term.device
    crashed = torch.zeros((P, n_groups), dtype=torch.bool, device=dev)
    append = torch.ones(n_groups, dtype=torch.int32, device=dev)
    block = fused_step.fast_multi_round(cfg, k=K, count_fused=True)
    fused = general = 0
    for b in range(blocks + crash_blocks):
        if b == blocks:
            mid = st
            lead = st.state.eq(ROLE_LEADER).to(torch.int64).argmax(0)
            idx = torch.arange(n_groups, device=dev)[::100]
            crashed = crashed.clone()
            crashed[lead[::100], idx] = True
        prev = fused
        st, fused = block(st, crashed, append, fused)
        general += fused == prev
    return st, fused, general, (st if crash_blocks == 0 else mid)


@phase("damped")
def phase_damped(dev, settled):
    """The check-quorum path on the card, bare and instrumented: at G=8,192
    from one instrumented settle, and at G=100,000 from the settled state
    (fused blocks, then crash blocks); then each once on the CPU
    (instrumented), the reference for both.  Returns (the bare 100k state
    before the crash blocks, its damped kernel launches, the instrumented
    card run, its with_health launches)."""
    t0 = time.perf_counter()
    small_cfg = damped_cfg(CQ_SMALL_G)
    small_start = instrumented_settle(dev, small_cfg, CQ_SETTLE)
    zero_launches()
    small = run_damped_path(dev, CQ_SMALL_G, CQ_SMALL_BLOCKS, start=small_start[0])
    small_launches = bare_launches(damped_rounds, f"the check-quorum path at G={CQ_SMALL_G}")
    # The main path at full size, its launches counted alone.
    zero_launches()
    full = run_damped_path(dev, G, CQ_FUSED_BLOCKS, start=settled,
                           crash_blocks=CQ_CRASH_BLOCKS)
    launches = bare_launches(damped_rounds, f"the check-quorum path at G={G}")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if full[2] != CQ_CRASH_BLOCKS or small[2] or full[1] != CQ_FUSED_BLOCKS * K * G:
        raise AssertionError(f"unexpected branches: G={CQ_SMALL_G} general "
                             f"{small[2]}, G={G} fused {full[1]} general {full[2]}")
    check_state(small[0], CQ_SMALL_G)
    check_state(full[0])
    crashed_groups = slice(None, None, 100)
    elected = int((full[0].term.amax(0)[crashed_groups]
                   > full[3].term.amax(0)[crashed_groups]).sum())
    if elected <= 0:
        raise AssertionError("no election in the groups whose leader crashed")
    _, small_ref, _ = instrumented_pair(
        dev, f"check-quorum G={CQ_SMALL_G}", damped_rounds, (CQ_SMALL_BLOCKS, 0),
        cpu_start=instrumented_settle("cpu", small_cfg, CQ_SETTLE), cfg=small_cfg,
        blocks=CQ_SMALL_BLOCKS, start=small_start)
    same_as_reference(small, small_ref, f"check-quorum G={CQ_SMALL_G}")
    cfg = damped_cfg(G)
    run, ref, h_launches = instrumented_pair(
        dev, "check-quorum", damped_rounds, (CQ_FUSED_BLOCKS, CQ_CRASH_BLOCKS),
        cpu_start=fresh_start(on_cpu(settled), cfg), cfg=cfg, blocks=CQ_FUSED_BLOCKS,
        crash_blocks=CQ_CRASH_BLOCKS, start=fresh_start(settled, cfg))
    same_as_reference(full, ref, f"check-quorum G={G}")
    print(f"check-quorum path {CQ_SMALL_G}x{P} (init, {CQ_SETTLE} instrumented settle "
          f"rounds, {CQ_SMALL_BLOCKS} blocks; fused {small[1]}, general blocks {small[2]}) "
          f"and {G}x{P} (settled, {CQ_FUSED_BLOCKS} blocks, then {CQ_CRASH_BLOCKS} "
          f"with the acting leader crashed in 1% of groups, {elected} of "
          f"{len(range(0, G, 100))} of which elected a new leader; fused "
          f"{full[1]}, general blocks {full[2]}): card == CPU "
          f"on all {len(settled._fields)} fields, recent_active included; damped "
          f"kernel launches {small_launches} at G={CQ_SMALL_G} and {launches} at "
          f"G={G} (the main path's count); card {t_gpu:.2f}s")
    return full[3], launches, run, h_launches


@phase("damped timing")
def phase_damped_timing(dev, st):
    cfg = damped_cfg(G)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    fast = fused_step.fast_multi_round(cfg, k=K, count_fused=True)
    round_fn = fused_step.damped_round(cfg, rounds=K)
    kw = dict(round_base=0, rounds=K, election_tick=cfg.election_tick,
              heartbeat_tick=cfg.heartbeat_tick, with_cq=True)
    t = time_path(
        dev, "damped", st, 0,
        block=lambda s, rb, f: fast(s, crashed, append, f),
        operands=lambda s, rb: (fused_step.damped_operands(s, crashed, append), kw),
        kernel=damped_rounds, reference=damped_rounds_reference,
        kernel_name="damped_round_kernel",
        fused_round=lambda s, rb: round_fn(s, crashed, append),
        predicate=lambda s: fused_step.steady_predicate(cfg, s, crashed, K),
        work=damped_work(P, G, K),
    )
    if t["fused_frac"] < 1.0:
        raise AssertionError(f"damped timed loop left the fused path: "
                             f"fused_frac {t['fused_frac']}")
    return t

# --- the instrumented paths (bench.py --health) -----------------------------


def zero_launches():
    for fn in KERNELS:
        fn.launches = fn.health_launches = 0


def launch_counts():
    """{kernel: (with_health=False launches, with_health=True launches)}."""
    return {fn.__name__: (fn.launches, fn.health_launches) for fn in KERNELS}


def instrumented(cfg):
    return cfg._replace(collect_counters=True, collect_health=True)


def summary_of(cfg, planes):
    """kernels.health_summary at the config's thresholds, as the
    HealthMonitor's dict (what bench.py --health-out writes)."""
    out = pk.health_summary(planes, cfg.leaderless_stall_ticks, cfg.commit_stall_ticks,
                            cfg.churn_bumps, min(cfg.health_topk, cfg.n_groups))
    return HealthMonitor.summary_dict(*(t.tolist() for t in out))


def instrumented_settle(device, cfg, rounds):
    """init_state and `rounds` rounds of one append a group through
    ClusterSim(collect_counters=True, collect_health=True): (state, counter
    totals, health)."""
    s = sim.ClusterSim(instrumented(cfg), device=device)
    s.run(rounds, None, torch.ones(cfg.n_groups, dtype=torch.int32, device=s.device))
    return s.state, s.counters(), s._health


def fresh_start(st, cfg):
    """A settled state with zero counters and fresh health planes."""
    return st, dict.fromkeys(pk.COUNTER_NAMES, 0), sim.init_health(cfg, st.term.device)


def run_health_path(device, cfg, blocks, settle=0, start=None, chaos=False,
                    round_base=0, crash_blocks=0, cut_last=False):
    """An instrumented path: from `start` (state, counter totals, health)
    or else instrumented_settle(device, cfg, settle), `blocks` k=32
    blocks of fast_multi_round(with_health=True, with_counters=True), then
    `crash_blocks` with the acting leader crashed in every hundredth group;
    with `chaos`, an all-up link plane and 1% loss, and with `cut_last` the
    last block's 0 -> 1 link down in 1% of groups.  Returns a dict of the
    final state, health, counter totals, summary, fused and general block
    counts, and the state and health before the crash blocks."""
    cfg = instrumented(cfg)
    n_groups = cfg.n_groups
    st, totals, health = instrumented_settle(device, cfg, settle) if start is None else start
    dev = st.term.device
    counters = pk.zero_counters(dev)
    crashed = torch.zeros((P, n_groups), dtype=torch.bool, device=dev)
    append = torch.ones(n_groups, dtype=torch.int32, device=dev)
    lead = ()
    if chaos:
        lead = (torch.ones((P, P, n_groups), dtype=torch.bool, device=dev),
                uniform_loss(n_groups, P, dev))
    block = fused_step.fast_multi_round(cfg, k=K, with_chaos=chaos, count_fused=True,
                                        with_health=True, with_counters=True)
    fused = general = 0
    mid = None
    for b in range(blocks + crash_blocks):
        if b == blocks:
            mid = (st, health)
            leader = st.state.eq(ROLE_LEADER).to(torch.int64).argmax(0)
            crashed = crashed.clone()
            crashed[leader[::100], torch.arange(n_groups, device=dev)[::100]] = True
        args = lead
        if chaos:
            link = lead[0]
            if cut_last and b == blocks + crash_blocks - 1:
                link = link.clone()
                link[0, 1, ::100] = False
            args = (link, lead[1], round_base)
            round_base += K
        prev = fused
        st, counters, health, fused = block(st, crashed, append, *args, counters,
                                            health, fused)
        general += fused == prev
    if mid is None:
        mid = (st, health)
    window = counters.tolist()
    if min(window) < 0:
        raise AssertionError(f"the counter plane wrapped int32: {window}")
    totals = {k: v + w for (k, v), w in zip(totals.items(), window)}
    return dict(state=st, health=health, counters=totals, fused=fused,
                general=general, summary=summary_of(cfg, health.planes), mid=mid)


def assert_same_health(a, b, note):
    """Card run `a` against CPU run `b` (run_health_path's dicts)."""
    assert_same(a["state"], b["state"], note)
    assert_same(a["mid"][0], b["mid"][0], note + " (before the crash blocks)")
    for key in ("counters", "summary", "fused", "general"):
        if a[key] != b[key]:
            raise AssertionError(f"{note}: {key} differ: card {a[key]}, CPU {b[key]}")
    for h_a, h_b, when in ((a["health"], b["health"], ""),
                           (a["mid"][1], b["mid"][1], " (before the crash blocks)")):
        if h_a.window_pos != h_b.window_pos or not torch.equal(h_a.planes.cpu(), h_b.planes):
            raise AssertionError(f"{note}{when}: health planes or window_pos differ")


def on_cpu(st):
    return sim.SimState(*(None if v is None else v.cpu() for v in st))


def bare_launches(kernel, note):
    """The bare path just run launched `kernel`'s with_health=False variant
    and nothing else; returns that count."""
    counts = launch_counts()
    for name, (plain, health) in counts.items():
        if health or (plain > 0) != (name == kernel.__name__):
            raise AssertionError(f"{note}: unexpected launches {counts}")
    return counts[kernel.__name__][0]


def same_as_reference(bare, ref, note):
    """A bare card run (state, fused, general[, the state before the crash
    blocks]) against the CPU's instrumented run of the same schedule (the
    extras never change the state)."""
    assert_same(bare[0], ref["state"], note)
    if len(bare) > 3:
        assert_same(bare[3], ref["mid"][0], note + " (before the crash blocks)")
    if tuple(bare[1:3]) != (ref["fused"], ref["general"]):
        raise AssertionError(f"{note}: fused/general counts differ {bare[1:3]} "
                             f"{(ref['fused'], ref['general'])}")


def instrumented_pair(dev, name, kernel, expect, cpu_start=None, **kw):
    """A path run instrumented (run_health_path's `kw`) on the card, its
    launch counts zeroed just before it and read just after, then on the
    CPU (from `cpu_start` in place of kw's start): every field, the four
    health planes, window_pos, the counters, the summary and the (fused,
    general) block counts, which must be `expect`, equal.  Prints the
    end-of-run summary as bench.py --health-out writes it.  Returns (card
    run, CPU run, with_health launches)."""
    t0 = time.perf_counter()
    zero_launches()
    got = run_health_path(dev, **kw)
    counts = launch_counts()
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    for kname, (plain, health) in counts.items():
        if plain or (health > 0) != (kname == kernel.__name__):
            raise AssertionError(f"{name} --health: unexpected launches {counts}")
    n_groups = kw["cfg"].n_groups
    check_state(got["state"], n_groups)
    t0 = time.perf_counter()
    want = run_health_path("cpu", **(kw if cpu_start is None else dict(kw, start=cpu_start)))
    t_cpu = time.perf_counter() - t0
    assert_same_health(got, want, f"{name} --health")
    fused_blocks, general_blocks = expect
    if (got["fused"], got["general"]) != (fused_blocks * K * n_groups, general_blocks):
        raise AssertionError(f"{name} --health: fused {got['fused']}, general blocks "
                             f"{got['general']}")
    origin = "settled" if "start" in kw else f"{kw['settle']} instrumented settle rounds"
    print(f"health path {name} ({n_groups}x{P}, {origin}, {fused_blocks + general_blocks} "
          f"blocks of {K}, general {got['general']}): card == CPU on every field, the "
          f"four health planes, window_pos (={got['health'].window_pos}), the counters "
          f"{got['counters']}, the summary and the fused count ({got['fused']}); "
          f"launches by variant {counts}; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s")
    print(f"  end-of-run health summary: {json.dumps(got['summary'])}")
    return got, want, counts[kernel.__name__][1]


def health_time_path(dev, label, cfg, start, rb, fused_round, operands, kernel,
                     reference, kernel_name, work):
    """time_path over bench.py --health's block: fast_multi_round with the
    health planes threaded (no counters), the carry (SimState,
    HealthState); fused_frac must be 1.0."""
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    fast = fused_step.fast_multi_round(cfg, k=K, count_fused=True, with_health=True)

    def block(carry, rb, f):
        st, h, f = fast(carry[0], crashed, append, carry[1], f)
        return (st, h), f

    t = time_path(
        dev, label, start, rb, block=block,
        operands=lambda c, rb: operands(c[0], crashed, append,
                                        c[1].planes[pk.HP_SINCE_COMMIT], rb),
        kernel=kernel, reference=reference, kernel_name=kernel_name,
        fused_round=lambda c, rb: fused_round(c[0], crashed, append, c[1]),
        predicate=lambda c: fused_step.steady_predicate(cfg, c[0], crashed, K),
        work=work,
    )
    if t["fused_frac"] < 1.0:
        raise AssertionError(f"{label} timed loop left the fused path: "
                             f"fused_frac {t['fused_frac']}")
    return t


@phase("health timing")
def phase_health_timing(dev, card):
    """bench.py --health on the steady and the check-quorum path, and the
    lossy with_health kernel alone."""
    steady_cfg = sim.SimConfig(n_groups=G, n_peers=P)
    ticks = dict(rounds=K, election_tick=steady_cfg.election_tick,
                 heartbeat_tick=steady_cfg.heartbeat_tick)
    steady = health_time_path(
        dev, "steady --health", steady_cfg,
        (card["steady"]["state"], card["steady"]["health"]), 0,
        fused_round=fused_step.steady_round(steady_cfg, K, with_health=True),
        operands=lambda s, c, a, tsc, rb: (fused_step.steady_operands(s, c, a, tsc), ticks),
        kernel=steady_rounds, reference=steady_rounds_reference,
        kernel_name="steady_round_kernel", work=steady_work(P, G, K, with_health=True))
    cq_cfg = damped_cfg(G)
    cq_ticks = dict(round_base=0, rounds=K, election_tick=cq_cfg.election_tick,
                    heartbeat_tick=cq_cfg.heartbeat_tick, with_cq=True)
    damped = health_time_path(
        dev, "check-quorum --health", cq_cfg, card["damped"]["mid"], 0,
        fused_round=fused_step.damped_round(cq_cfg, K, with_health=True),
        operands=lambda s, c, a, tsc, rb: (
            fused_step.damped_operands(s, c, a, None, tsc), cq_ticks),
        kernel=damped_rounds, reference=damped_rounds_reference,
        kernel_name="damped_round_kernel",
        work=damped_work(P, G, K, with_health=True))
    lossy = kernel_timing(
        dev, "lossy with_health", card["lossy"]["state"], card["lossy"]["health"])
    return steady, damped, lossy


def kernel_timing(dev, label, st, health):
    """The lossy with_health kernel alone: device time cold and hot, a
    wrapper call, the plain version and the bound."""
    cfg = lossy_cfg(G)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    args = fused_step.chaos_operands(st, crashed, append, uniform_loss(G, P, dev),
                                     health.planes[pk.HP_SINCE_COMMIT])
    kw = dict(round_base=LOSSY_SETTLE, rounds=K, election_tick=cfg.election_tick,
              heartbeat_tick=cfg.heartbeat_tick)
    t = kernel_times(dev, chaos_rounds, chaos_rounds_reference, args, kw,
                     chaos_work(P, G, K, with_health=True))
    print(f"timing {label} {G}x{P} k={K} [{t['card']}]: chaos_round_kernel "
          f"{t['ms']:.4f} ms cold ({t['hot_ms']:.4f} ms hot; a wrapper call "
          f"{t['call_ms']:.4f} ms), plain version {t['plain_ms']:.3f} ms; bound "
          f"{t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f})")
    return t


# --- the chaos scenario (bench.py --chaos) -----------------------------------


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def prefix(st, n):
    """The first n groups of every plane."""
    return sim.SimState(*(None if v is None else v[..., :n] for v in st))


def chaos_cfg(n_groups, check_quorum):
    """bench.py --chaos's config: the plan's peers, health planes on."""
    return sim.SimConfig(n_groups=n_groups, n_peers=P, collect_health=True,
                         check_quorum=check_quorum)


def run_scenario(device, n_groups, check_quorum):
    """ClusterSim(chaos=the plan).run_plan() from init_state: (report, final
    state, final health, run_plan's wall seconds, which end with the
    report's download)."""
    s = sim.ClusterSim(chaos_cfg(n_groups, check_quorum),
                       chaos=chaos.load_plan(CHAOS_PLAN), device=device)
    sync()
    t0 = time.perf_counter()
    report = s.run_plan()
    return report, s.state, s._health, time.perf_counter() - t0


def same_scenario(a, b, note, n_groups=None):
    """Run b's state and health planes equal to the first n_groups groups
    (default all) of run a's."""
    n = b[1].term.shape[1] if n_groups is None else n_groups
    assert_same(prefix(a[1], n), b[1], note)
    if a[2].window_pos != b[2].window_pos or not torch.equal(
            a[2].planes[:, :n].cpu(), b[2].planes.cpu()):
        raise AssertionError(f"{note}: health planes or window_pos differ")


def worker_threads():
    """CPU threads for the reference worker: all but two, which drive the
    card meanwhile."""
    torch.set_num_threads(max(1, torch.get_num_threads() - 2))


def cpu_scenarios():
    """In the reference worker: the plan on the CPU at CHAOS_SMALL_G with
    check_quorum off and on, {check_quorum: (report, state arrays, health
    planes, window_pos, seconds)}."""
    worker_threads()
    out = {}
    for check_quorum in (False, True):
        report, st, health, secs = run_scenario("cpu", CHAOS_SMALL_G, check_quorum)
        out[check_quorum] = (report, sim.state_to_numpy(st), health.planes.numpy(),
                             health.window_pos, secs)
    return out


def scenario_parity(dev, check_quorum):
    """The plan on the card at CHAOS_SMALL_G, then at G with its launch
    counts zeroed just before and read just after (the scenario runs on the
    general step: no fused kernel may launch) and zero safety counts.
    Returns (the small run, the G run, check(cpu)), where check(cpu) holds
    them to the CPU run (cpu_scenarios' entry): equal report, state and
    health planes at CHAOS_SMALL_G, and the G run's first CHAOS_SMALL_G
    groups equal to it."""
    name = "check_quorum" if check_quorum else "undamped"
    small = run_scenario(dev, CHAOS_SMALL_G, check_quorum)
    zero_launches()
    full = run_scenario(dev, G, check_quorum)
    counts = launch_counts()
    if any(a or b for a, b in counts.values()):
        raise AssertionError(f"chaos {name}: a fused kernel launched: {counts}")
    if any(full[0]["safety"].values()):
        raise AssertionError(f"chaos {name} G={G}: safety violations {full[0]['safety']}")
    check_state(full[1])

    def check(cpu_entry):
        report, arrays, planes, window_pos, t_cpu = cpu_entry
        cpu = (report, sim.state_from_numpy(arrays, "cpu"),
               sim.HealthState(torch.from_numpy(planes), window_pos))
        if small[0] != cpu[0]:
            raise AssertionError(f"chaos {name} G={CHAOS_SMALL_G}: reports differ: "
                                 f"card {small[0]}, CPU {cpu[0]}")
        same_scenario(small, cpu, f"chaos {name} G={CHAOS_SMALL_G}")
        same_scenario(full, cpu, f"chaos {name}: the first {CHAOS_SMALL_G} of {G} "
                      "groups", CHAOS_SMALL_G)
        print(f"chaos scenario {name} ({CHAOS_PLAN_NAME}, {full[0]['rounds']} rounds): "
              f"card == CPU at {CHAOS_SMALL_G}x{P} (report, every field, the health "
              f"planes); at {G}x{P} safety all 0, the first {CHAOS_SMALL_G} groups == "
              f"the CPU run; card {full[3]:.2f}s at G={G}, CPU {t_cpu:.2f}s at "
              f"G={CHAOS_SMALL_G} (in the reference worker)")
        print(f"  report at G={G}: {json.dumps(full[0])}")
        print(f"  report at G={CHAOS_SMALL_G}: {json.dumps(cpu[0])}")
        return t_cpu

    return small, full, check


def scenario_timing(dev, check_quorum, first_s):
    """bench_chaos: G x rounds / wall of the whole plan from a fresh state,
    the median of CHAOS_REPS reps, the parity run's run_plan (`first_s`
    seconds; the host loop compiles nothing, so it needs no warm-up) the
    first of them; fused_frac 0; and the device's busy share over the first
    CHAOS_PROFILE_ROUNDS rounds."""
    cfg = chaos_cfg(G, check_quorum)
    compiled = chaos.compile_plan(chaos.load_plan(CHAOS_PLAN), G, dev)
    runner = chaos.make_runner(cfg, compiled)
    samples = [G * compiled.n_rounds / first_s]
    for _ in range(CHAOS_REPS - 1):
        st, health = sim.init_state(cfg, device=dev), sim.init_health(cfg, dev)
        sync()
        t0 = time.perf_counter()
        runner(st, health)
        sync()
        samples.append(G * compiled.n_rounds / (time.perf_counter() - t0))
    head = chaos.make_runner(cfg, compiled._replace(
        phase_of_round=compiled.phase_of_round[:CHAOS_PROFILE_ROUNDS]))
    st, health = sim.init_state(cfg, device=dev), sim.init_health(cfg, dev)
    prof = device_profile(lambda: head(st, health))
    med = statistics.median(samples)
    name = "check_quorum" if check_quorum else "undamped"
    print(f"timing chaos scenario {name} {G}x{P} [{card_line()}]: ticks/s median "
          f"{med:.1f} (min {min(samples):.1f}, max {max(samples):.1f}, {CHAOS_REPS} "
          f"reps), fused_frac 0; a round {1e3 * G / med:.2f} ms; profile of rounds "
          f"0-{CHAOS_PROFILE_ROUNDS - 1}: device busy {prof['busy_us']:.1f} of "
          f"{prof['wall_us']:.1f} us ({100 * prof['busy_share']:.1f}%), "
          f"{sum(r['count'] for r in prof['kernels'])} kernel launches")
    for row in prof["kernels"][:6]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return dict(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=0.0,
                profile=prof, card=card_line())


@phase("chaos scenario")
def phase_chaos_scenario(dev, cpu_runs):
    """bench.py --chaos examples/chaos/partition_heal.json [--check-quorum]
    at G on the card and timed, then held to the CPU runs (`cpu_runs`, the
    reference worker's future of cpu_scenarios())."""
    card = {}
    for check_quorum in (False, True):
        _, full, check = scenario_parity(dev, check_quorum)
        card[check_quorum] = (check, full, scenario_timing(dev, check_quorum, full[3]))
    cpu = cpu_runs.result()
    out = {}
    for check_quorum, (check, full, timing) in card.items():
        t_cpu = check(cpu[check_quorum])
        out["check_quorum" if check_quorum else "undamped"] = dict(
            report=full[0], card_s=full[3], cpu_s=t_cpu, **timing)
    return out


# --- the per-group split (bench.py --lossy 0.01 --check-quorum) --------------


def crash_leaders(st, crashed):
    """`crashed` with each group's acting leader down in every STORM_EVERY-th
    group."""
    lead = st.state.eq(ROLE_LEADER).to(torch.int64).argmax(0)
    idx = torch.arange(st.term.shape[1], device=st.term.device)[::STORM_EVERY]
    crashed = crashed.clone()
    crashed[lead[::STORM_EVERY], idx] = True
    return crashed


def align_leader_phases(st):
    """Every leader's election_elapsed set to 0, the value a check-quorum
    boundary round leaves it at, so that the fleet's boundaries fall
    together (after the settle they are spread over most of the 64-round
    interval)."""
    return st._replace(election_elapsed=torch.where(
        st.state == ROLE_LEADER, 0, st.election_elapsed))


def run_composed(start):
    """len(COMPOSED_BRANCHES) blocks of hybrid_multi_round(k=32,
    with_chaos=True, count_fused=True) over the all-up link plane with 1%
    loss from `start` at round CQ_SETTLE, the acting leader crashed in
    every STORM_EVERY-th group from block COMPOSED_CRASH_BLOCK on.  Returns
    (state, fused group-rounds, [(branch, fused delta)], the damped
    kernel's operands and keywords at the crash block)."""
    cfg = damped_cfg(G)
    st = start
    dev = st.term.device
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    link = torch.ones((P, P, G), dtype=torch.bool, device=dev)
    loss = uniform_loss(G, P, dev)
    fn = fused_step.hybrid_multi_round(cfg, k=K, with_chaos=True, count_fused=True,
                                       device=dev)
    fused, rb, branches, at_crash = 0, CQ_SETTLE, [], None
    for b in range(len(COMPOSED_BRANCHES)):
        if b == COMPOSED_CRASH_BLOCK:
            crashed = crash_leaders(st, crashed)
            at_crash = (fused_step.damped_operands(st, crashed, append, loss), rb)
        prev = fused
        st, fused = fn(st, crashed, append, link, loss, rb, fused)
        branches.append((fn.last_branch, fused - prev))
        rb += K
    return st, fused, branches, at_crash


def cpu_composed(settled):
    """In the reference worker: run_composed on the CPU from the settled
    state's arrays, aligned as on the card: (state arrays, fused count,
    branches, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    st, fused, branches, _ = run_composed(
        align_leader_phases(sim.state_from_numpy(settled, "cpu")))
    return sim.state_to_numpy(st), fused, branches, time.perf_counter() - t0


@phase("composed")
def phase_composed(dev, settled, cpu_run):
    """The composed path at G from phase 9's damped-settled state with the
    leaders' boundary phases aligned: a pure, a slow and a split block on
    the card, the launch counts zeroed just before and read just after,
    then held to the CPU run (`cpu_run`, the reference worker's future of
    cpu_composed()); every field equal, recent_active and the fused count
    included.  Then the damped kernel against its plain version on the
    split block's operands (storm groups with no acting leader included).
    Returns (the card's launches of the damped kernel, all with_loss, the
    with_loss parity error, the branches)."""
    start = align_leader_phases(settled)
    zero_launches()
    t0 = time.perf_counter()
    card = run_composed(start)
    counts = launch_counts()
    sync()
    t_gpu = time.perf_counter() - t0
    launches = counts["damped_rounds"][0]
    if launches < 1 or counts["damped_rounds"][1] or any(
            counts[k.__name__] != (0, 0) for k in (steady_rounds, chaos_rounds)):
        raise AssertionError(f"composed: unexpected launches {counts}")
    if [b for b, _ in card[2]] != list(COMPOSED_BRANCHES):
        raise AssertionError(f"composed: branches {card[2]}, want {COMPOSED_BRANCHES}")
    check_state(card[0])
    arrays, fused, branches, t_cpu = cpu_run.result()
    assert_same(card[0], sim.state_from_numpy(arrays, "cpu"), "composed")
    if (card[1], card[2]) != (fused, branches):
        raise AssertionError(f"composed: fused counts or branches differ: card "
                             f"{card[1:3]}, CPU {(fused, branches)}")
    args, rb = card[3]
    err = compare_damped(args, "composed split block (1% of leaders crashed)",
                         round_base=rb)
    print(f"composed path {G}x{P} (--lossy 0.01 --check-quorum, from the damped-settled "
          f"state with the leaders' boundary phases aligned): blocks "
          f"{', '.join(f'{b} (fused {d})' for b, d in card[2])}; card == CPU on all "
          f"{len(settled._fields)} fields, recent_active and the fused count "
          f"({card[1]}) included; damped kernel (with_loss) launches {launches}; card "
          f"{t_gpu:.2f}s, CPU {t_cpu:.2f}s (in the reference worker)")
    return launches, err, card[2]


@phase("steady hybrid")
def phase_steady_hybrid(dev, start):
    """One hybrid_multi_round(k=32) block on the steady path at G from the
    main path's final state, the acting leader crashed in 1% of groups: the
    split branch (elections in the gathered sub-batch), card == CPU."""
    cfg = sim.SimConfig(n_groups=G, n_peers=P)

    def block(st):
        dev = st.term.device
        crashed = crash_leaders(st, torch.zeros((P, G), dtype=torch.bool, device=dev))
        fn = fused_step.hybrid_multi_round(cfg, k=K, count_fused=True, device=dev)
        out, fused = fn(st, crashed, torch.ones(G, dtype=torch.int32, device=dev), 0)
        return out, fused, fn.last_branch

    zero_launches()
    card = block(start)
    counts = launch_counts()
    if counts["steady_rounds"] != (1, 0) or any(
            counts[k.__name__] != (0, 0) for k in (chaos_rounds, damped_rounds)):
        raise AssertionError(f"steady hybrid: unexpected launches {counts}")
    cpu = block(on_cpu(start))
    assert_same(card[0], cpu[0], "steady hybrid")
    if card[1:] != cpu[1:] or card[2] != "split":
        raise AssertionError(f"steady hybrid: card {card[1:]}, CPU {cpu[1:]}")
    elected = int((card[0].term.amax(0) > start.term.amax(0))[::STORM_EVERY].sum())
    print(f"steady hybrid block {G}x{P}: {card[2]}, fused {card[1]} of {K * G}, "
          f"{elected} of {len(range(0, G, STORM_EVERY))} storm groups elected; "
          f"card == CPU on all {len(start._fields)} fields; steady kernel launches "
          f"{counts['steady_rounds'][0]}")
    return card[1]


@phase("composed timing")
def phase_composed_timing(dev, settled):
    """bench.py --lossy 0.01 --check-quorum's timed loop from the settled
    state as it is (the natural boundary phases), COMPOSED_REPS reps of one
    64-round scan: ticks/s, the measured fused_frac, the block's parts, the
    busy share of the general rounds every such block runs, and the damped
    kernel's with_loss instance against its bound."""
    cfg = damped_cfg(G)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    link = torch.ones((P, P, G), dtype=torch.bool, device=dev)
    loss = uniform_loss(G, P, dev)
    fn = fused_step.hybrid_multi_round(cfg, k=K, with_chaos=True, count_fused=True,
                                       device=dev)
    round_fn = fused_step.chaos_round(cfg, rounds=K)
    storms = int((~fused_step.steady_mask(cfg, settled, crashed, K, link,
                                          loss_rate=loss)).sum())
    print(f"composed timing: {storms} of {G} groups storm at the settled state "
          f"(storm slots 4096)")

    def operands(s, rb):
        return fused_step.damped_operands(s, crashed, append, loss), dict(
            round_base=rb, rounds=K, election_tick=cfg.election_tick,
            heartbeat_tick=cfg.heartbeat_tick, with_cq=True)

    def general_rounds(s, rb):
        """The slow branch's work, which every block of the settled state
        takes, for its first CHAOS_PROFILE_ROUNDS rounds."""
        for r in range(CHAOS_PROFILE_ROUNDS):
            s = sim.step(cfg, s, crashed, append,
                         link=link & ~link_loss_draw(rb + r, loss))

    return time_path(
        dev, "composed", settled, CQ_SETTLE,
        block=lambda s, rb, f: fn(s, crashed, append, link, loss, rb, f),
        operands=operands, kernel=damped_rounds, reference=damped_rounds_reference,
        kernel_name="damped_round_kernel",
        fused_round=lambda s, rb: round_fn(s, crashed, append, loss, rb),
        predicate=lambda s: int((~fused_step.steady_mask(
            cfg, s, crashed, K, link, loss_rate=loss)).sum()),
        work=damped_work(P, G, K, with_loss=True), reps=COMPOSED_REPS, scans=1,
        part_reps=1, profile=(f"{CHAOS_PROFILE_ROUNDS} of the slow branch's general "
                              "rounds", general_rounds),
    )


def kernel_entry(name, source, replaces, launches, err, t):
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": err,
        "parity": "exact",
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        "hot_ms": t["hot_ms"],
        "call_ms": t["call_ms"],
        "block_ms": t.get("block_ms"),
        "wrapper_ms": t.get("wrapper_ms"),
        "predicate_ms": t.get("predicate_ms"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write all results as JSON here")
    ap.add_argument("--quick", action="store_true",
                    help="build, hold every kernel variant against its plain "
                         "version, and stop")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(card_line())
    print(f"device: {name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    phase_build()
    steady_err = phase_parity(dev)
    if opts.quick:
        phase_chaos_parity(dev)
        phase_damped_parity(dev)
        print("quick: every kernel variant equals its plain version on the card")
        return 0
    cfg, st_main, steady_launches, steady_run, steady_h_launches = phase_main(dev)
    steady = phase_timing(dev, cfg, st_main)
    chaos_err, settled = phase_chaos_parity(dev)
    st, chaos_launches, lossy_run, chaos_h_launches = phase_lossy(dev, settled)
    lossy = phase_lossy_timing(dev, st)
    damped_err, damped_loss_err, settled = phase_damped_parity(dev)
    st, damped_launches, damped_run, damped_h_launches = phase_damped(dev, settled)
    damped = phase_damped_timing(dev, st)
    steady_h, damped_h, lossy_h = phase_health_timing(
        dev, {"steady": steady_run, "lossy": lossy_run, "damped": damped_run})
    # This slice's CPU references run in a worker process while the card
    # runs its side of the same phases.
    with ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        cpu_runs = pool.submit(cpu_scenarios)
        cpu_run = pool.submit(cpu_composed, sim.state_to_numpy(settled))
        scenario = phase_chaos_scenario(dev, cpu_runs)
        composed = phase_composed_timing(dev, settled)
        steady_hybrid_fused = phase_steady_hybrid(dev, st_main)
        composed_launches, composed_err, composed_branches = phase_composed(
            dev, settled, cpu_run)

    rows = (
        ("steady_rounds", STEADY_SOURCE, STEADY_REPLACES, steady_err,
         (steady_launches, steady), (steady_h_launches, steady_h)),
        ("chaos_rounds", CHAOS_SOURCE, CHAOS_REPLACES, chaos_err,
         (chaos_launches, lossy), (chaos_h_launches, lossy_h)),
        ("damped_rounds", DAMPED_SOURCE, DAMPED_REPLACES, damped_err,
         (damped_launches, damped), (damped_h_launches, damped_h)),
    )
    kernels = {"kernels": [
        kernel_entry(f"{kname} with_health={flag}", source,
                     f"{replaces} (with_health={flag})", launches, errs[flag], t)
        for kname, source, replaces, errs, *variants in rows
        for flag, (launches, t) in zip((False, True), variants)
    ] + [kernel_entry(
        "damped_rounds with_loss=True with_health=False", DAMPED_SOURCE,
        f"{DAMPED_REPLACES} (with_loss=True, with_health=False)", composed_launches,
        worst(damped_loss_err, composed_err)[0], composed)]}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w", encoding="utf-8") as fh:
            json.dump({**kernels, "ptxas": PTXAS, "timing": {
                "steady": steady, "lossy": lossy, "damped": damped,
                "steady_health": steady_h, "damped_health": damped_h,
                "lossy_health_kernel": lossy_h, "chaos_scenario": scenario,
                "composed": composed}, "composed_branches": composed_branches,
                "steady_hybrid_fused": steady_hybrid_fused}, fh, indent=1,
                default=str)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
