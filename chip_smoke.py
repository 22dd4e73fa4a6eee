#!/usr/bin/env python3
"""Drive raft_tpu_torch's ported paths on one CUDA card and check them.

    python3 chip_smoke.py [--out results.json]

Three paths, all at 100,000 groups × 5 peers with one append per group
per round (bench.py's bench_device):

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

Phases, in order, each with its wall seconds; any failure raises and the
script exits nonzero:

  1. device        require CUDA; print the card's name and power limit
  2. build         build the three kernels from csrc/ with nvcc, in parallel;
                   print the times and ptxas registers and spills per P
  3. parity        the steady kernel against its plain PyTorch version on
                   the same card tensors, exact: settled states at
                   G=100,000 and a ragged G=100,003 (P=5), at P=3, and
                   random planes
  4. main          the steady path on the card (launch counts zeroed just
                   before, read just after), then on the CPU; every
                   SimState field must be equal
  5. timing        the steady path on the bench's schedule (64-round
                   scans, 6 scans a rep, median of 5 reps): ticks/s,
                   fused_frac, the kernel's device time (torch.profiler,
                   cold with L2 flushed before each launch, and hot), the
                   plain version's time, the block and its parts (CUDA
                   events), the device's busy share and time by kernel
  6. chaos parity  the chaos kernel against its plain version, exact:
                   lossy-settled states at G=100,000, G=100,003 (P=5) and
                   P=3, each with and without crashed followers, under 1%
                   and the heavy-loss layout, with the round base small
                   and near 2**31 - 32; random planes at P=3, 5 and 7
  7. lossy         the lossy path on the card: at G=8,192 from init_state
                   (192 settle rounds, 4 blocks), then the main path at
                   G=100,000 from the settled state (2 blocks on the
                   healed plane, 1 with a link down in 1% of groups, which
                   forces the general branch), each with the launch counts
                   zeroed just before it and read just after; the same on
                   the CPU from the same start; every SimState field and
                   the fused counts must be equal
  8. lossy timing  as phase 5, for the lossy path and the chaos kernel
  9. damped parity the damped kernel against its plain version, exact:
                   damped-settled states at G=100,000, G=100,003 (P=5) and
                   P=3, each with and without crashed followers, without
                   loss and under 1% and the heavy-loss layout (round base
                   small and near 2**31 - 32); with_cq off on a
                   pre-vote-settled state; random planes at P=3, 5 and 7
 10. damped        the check-quorum path on the card: at G=8,192 from
                   init_state (192 settle rounds, 4 blocks), then the main
                   path at G=100,000 from the settled state (2 fused
                   blocks, then 3 with the acting leader crashed in 1% of
                   groups: general blocks with check-quorum step-downs and
                   elections), the launch counts zeroed just before each
                   and read just after; the same on the CPU from the same
                   start; every SimState field, recent_active included, and
                   the fused counts must be equal
 11. damped timing as phase 5, for the damped path and kernel; fused_frac
                   must be 1.0
 12. report        one JSON line of kernels, then the device line last

Exits 2 without a result when no CUDA device is available.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from raft_tpu_torch.multiraft import _build, fused_step, sim
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
ROUNDS_PER_SCAN, SCANS, REPS = 64, 6, 5
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
        print(f"build: {name}.cu in {secs:.2f}s")
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # The template arguments: P, then the damped kernel's flags.
                args = line.split("ILi")[1].split("EE")[0].split("ELb") if "ILi" in line else ["?"]
                entry = f"P={args[0]}" + (
                    f" cq={args[1]} loss={args[2]}" if len(args) == 3 else "")
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {entry}: {line.strip()}")


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


def compare(kernel, reference, names, args, kw, note):
    """Kernel vs plain version on the same card tensors, exact; returns the
    max |difference| (0)."""
    got = kernel(*args, **kw)
    want = reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{note}: {name} is {g.dtype} {tuple(g.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{note}: kernel and plain version differ in {name}")
    print(f"parity {note}: exact ({len(names)} outputs, {args[0].shape[1]} groups)")
    return err


def compare_kernel(args, rounds, note):
    kw = dict(rounds=rounds, election_tick=10, heartbeat_tick=1)
    return compare(steady_rounds, steady_rounds_reference,
                   ("ee", "hb", "li", "lt", "matched", "commit"), args, kw, note)


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
    err = 0
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3)):
        st = settle_on(dev, n_groups, n_peers)
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
        err = max(err, compare_kernel(
            fused_step.steady_operands(st, crashed, append), K,
            f"settled G={n_groups} P={n_peers}"))
        crashed = crash_followers(st, n_peers, n_groups, dev)
        err = max(err, compare_kernel(
            fused_step.steady_operands(st, crashed, append), K,
            f"settled+crashed followers G={n_groups} P={n_peers}"))
    for n_peers in (3, 5, 7):
        err = max(err, compare_kernel(
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
    steady_rounds.launches = 0
    chaos_rounds.launches = 0
    t0 = time.perf_counter()
    cfg, st_gpu, fused = run_main_path(dev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = steady_rounds.launches
    if launches <= 0:
        raise AssertionError("the main path never launched the steady kernel")
    check_state(st_gpu)
    t0 = time.perf_counter()
    _, st_cpu, fused_cpu = run_main_path("cpu")
    t_cpu = time.perf_counter() - t0
    assert_same(st_gpu, st_cpu, "steady main path")
    if fused != fused_cpu:
        raise AssertionError(f"fused counts differ: card {fused}, CPU {fused_cpu}")
    total = MAIN_BLOCKS * K * G
    print(f"main path {G}x{P}: {SETTLE} settle rounds + {MAIN_BLOCKS} blocks of "
          f"{K}: card == CPU on all {len(st_gpu._fields)} fields (commit max "
          f"{int(st_gpu.commit.max())}); steady kernel launches {launches}; "
          f"fused {fused}/{total}; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s")
    return cfg, st_gpu, launches


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


def kernel_device_ms(fn, name, reps, flush=None):
    """Device milliseconds per launch of the kernel whose name contains
    `name`, by torch.profiler over `reps` calls of fn() (with `flush`
    before each): the mean over the launches the profiler recorded, which
    may miss a few of them.  Unlike CUDA events around a call, this leaves
    out the host's time to prepare the launch, during which the card
    waits."""
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
    if not 0 < count <= reps:
        raise AssertionError(f"profiler saw {count} launches of {name} in {reps} calls")
    if count < reps:
        print(f"  (the profiler recorded {count} of {reps} launches of {name})")
    return sum(e.self_device_time_total for e in rows) / count / 1e3


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
              fused_round, predicate, work):
    """The bench's timed loop over `block(st, rb, fused) -> (st, fused)`
    (rb the absolute round of the block's first round), then the parts of
    one block from the loop's final state: the kernel (`kernel(*args,
    **kw)` with `operands(st, rb) -> (args, kw)`), its plain version, the
    fused round and the predicate, and a profile of one rep."""
    blocks_per_scan = ROUNDS_PER_SCAN // K
    for _ in range(blocks_per_scan):  # warm-up scan, as the bench does
        st, _ = block(st, rb, 0)
        rb += K
    torch.cuda.synchronize()
    samples, fused_total = [], 0
    ticks = G * ROUNDS_PER_SCAN * SCANS
    for _ in range(REPS):
        fused = 0
        t0 = time.perf_counter()
        for _ in range(SCANS * blocks_per_scan):
            st, fused = block(st, rb, fused)
            rb += K
        torch.cuda.synchronize()
        samples.append(ticks / (time.perf_counter() - t0))
        fused_total += fused
    fused_frac = fused_total / (ticks * REPS)

    args, kw = operands(st, rb)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.fill_(1)  # 256 MB written: the 50 MB L2 holds none of the operands

    def launch():
        kernel(*args, **kw)

    kernel_ms = kernel_device_ms(launch, kernel_name, 30, flush)
    kernel_hot_ms = kernel_device_ms(launch, kernel_name, 30)
    call_ms = cuda_ms(launch, 30, flush)
    plain_ms = cuda_ms(lambda: reference(*args, **kw), 5, flush)
    round_ms = cuda_ms(lambda: fused_round(st, rb), 10, flush)
    pred_ms = cuda_ms(lambda: bool(predicate(st)), 10, flush)
    block_ms = cuda_ms(lambda: block(st, rb, 0), 10, flush)
    del scratch

    def one_rep():
        s, r = st, rb
        for _ in range(SCANS * blocks_per_scan):
            s, _ = block(s, r, 0)
            r += K

    prof = device_profile(one_rep)
    loop_block_ms = statistics.median(ticks / x for x in samples) * 1e3 / (
        SCANS * blocks_per_scan)

    nbytes, ops = work
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    card = card_line()
    med = statistics.median(samples)
    print(f"timing {label} {G}x{P} k={K} [{card}]: ticks/s median {med:.1f} "
          f"(min {min(samples):.1f}, max {max(samples):.1f}, {REPS} reps), "
          f"fused_frac {fused_frac:.4f}; {kernel_name} {kernel_ms:.4f} ms cold "
          f"({kernel_hot_ms:.4f} ms hot; a wrapper call {call_ms:.4f} ms), "
          f"plain version {plain_ms:.3f} ms; "
          f"block {loop_block_ms:.3f} ms in the loop, {block_ms:.3f} ms alone = "
          f"predicate {pred_ms:.3f} + fused round {round_ms:.3f} (wrapper "
          f"{round_ms - call_ms:.3f} + the kernel call); bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
    print(f"profile of one {label} rep ({SCANS * blocks_per_scan} blocks): device "
          f"busy {prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%)")
    for row in prof["kernels"][:8]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return dict(
        ticks_per_s=samples, ticks_per_s_median=med, fused_frac=fused_frac,
        ms=kernel_ms, hot_ms=kernel_hot_ms, call_ms=call_ms, plain_ms=plain_ms,
        block_ms=block_ms, loop_block_ms=loop_block_ms, predicate_ms=pred_ms,
        fused_round_ms=round_ms, profile=prof,
        wrapper_ms=round_ms - call_ms, bound_ms=bound_ms,
        bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, operations=ops, card=card,
    )


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
        work=steady_work(P, G, K),
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
    return compare(chaos_rounds, chaos_rounds_reference, CHAOS_OUTPUTS, args, kw,
                   f"{note} round_base={round_base}")


@phase("chaos parity")
def phase_chaos_parity(dev):
    """Returns (max |difference|, the settled 100k × 5 lossy state)."""
    err, settled = 0, None
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
                    err = max(err, compare_chaos(
                        args, rb, f"lossy-settled G={n_groups} P={n_peers} "
                        f"{loss_name} loss, {crashed_name}"))
    for n_peers in (3, 5, 7):
        args = random_chaos_inputs(n_peers, G + 3, 10 + n_peers, dev)
        for rb in (7, 2**31 - K):
            err = max(err, compare_chaos(
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
    """Returns (the 100k state, the chaos kernel's launches in the 100k
    run alone)."""
    settled_cpu = sim.SimState(*(None if v is None else v.cpu() for v in settled))
    t0 = time.perf_counter()
    steady_rounds.launches = 0
    chaos_rounds.launches = 0
    small = run_lossy_path(dev, LOSSY_SMALL_G, LOSSY_SMALL_BLOCKS)
    small_launches = (chaos_rounds.launches, steady_rounds.launches)
    # The main path at full size, its launches counted alone.
    steady_rounds.launches = 0
    chaos_rounds.launches = 0
    full = run_lossy_path(dev, G, 3, start=settled, cut_last=True)
    launches = chaos_rounds.launches
    full_steady = steady_rounds.launches
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if small_launches[0] <= 0 or launches <= 0:
        raise AssertionError(f"the lossy path never launched the chaos kernel "
                             f"(G={LOSSY_SMALL_G}: {small_launches[0]}, G={G}: "
                             f"{launches})")
    if full[2] <= 0:
        raise AssertionError(f"the lossy path at G={G} never ran the general branch")
    if small_launches[1] or full_steady:
        raise AssertionError("the lossy path launched the steady kernel")
    check_state(small[0], LOSSY_SMALL_G)
    check_state(full[0])
    t0 = time.perf_counter()
    small_cpu = run_lossy_path("cpu", LOSSY_SMALL_G, LOSSY_SMALL_BLOCKS)
    full_cpu = run_lossy_path("cpu", G, 3, start=settled_cpu, cut_last=True)
    t_cpu = time.perf_counter() - t0
    for note, a, b in (("lossy G=8192", small, small_cpu), ("lossy G=100000", full, full_cpu)):
        assert_same(a[0], b[0], note)
        if a[1:] != b[1:]:
            raise AssertionError(f"{note}: fused/general counts differ {a[1:]} {b[1:]}")
    print(f"lossy path {LOSSY_SMALL_G}x{P} (init, {LOSSY_SETTLE} settle rounds, "
          f"{LOSSY_SMALL_BLOCKS} blocks; fused {small[1]}, general blocks {small[2]}) "
          f"and {G}x{P} (settled, 3 blocks, the last with a link down in 1% of "
          f"groups; fused {full[1]}, general blocks {full[2]}): card == CPU on all "
          f"{len(settled._fields)} fields; chaos kernel launches {small_launches[0]} "
          f"at G={LOSSY_SMALL_G} and {launches} at G={G} (the main path's count); "
          f"card {t_gpu:.2f}s, CPU {t_cpu:.2f}s")
    return full[0], launches


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
    return compare(damped_rounds, damped_rounds_reference, DAMPED_OUTPUTS, args, kw,
                   f"{note} cq={with_cq} round_base={round_base}")


@phase("damped parity")
def phase_damped_parity(dev):
    """Returns (max |difference|, the settled 100k × 5 damped state)."""
    err, settled = 0, None
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
            err = max(err, compare_damped(
                fused_step.damped_operands(st, crashed, append), note))
            for loss_name, make_loss in (("1%", uniform_loss), ("heavy", heavy_loss)):
                args = fused_step.damped_operands(
                    st, crashed, append, make_loss(n_groups, n_peers, dev))
                for rb in (CQ_SETTLE, 2**31 - K):
                    err = max(err, compare_damped(
                        args, f"{note} {loss_name} loss", round_base=rb))
    st = damped_settle(dev, G, P, pre_vote=True)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    for loss in (None, uniform_loss(G, P, dev)):
        err = max(err, compare_damped(
            fused_step.damped_operands(st, crashed, append, loss),
            f"pre-vote-settled G={G} P={P} loss={loss is not None}", with_cq=False))
    for n_peers in (3, 5, 7):
        for with_cq in (False, True):
            for loss in (False, True):
                args = random_damped_inputs(n_peers, G + 3, 20 + n_peers, dev, loss)
                err = max(err, compare_damped(
                    args, f"random planes G={G + 3} P={n_peers} loss={loss}",
                    with_cq=with_cq, round_base=2**31 - K, election_tick=6))
    return err, settled


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
    """Returns (the 100k state after the fused blocks, the damped kernel's
    launches in the 100k run alone)."""
    settled_cpu = sim.SimState(*(None if v is None else v.cpu() for v in settled))
    t0 = time.perf_counter()
    for fn in (steady_rounds, chaos_rounds, damped_rounds):
        fn.launches = 0
    small = run_damped_path(dev, CQ_SMALL_G, CQ_SMALL_BLOCKS)
    small_launches = damped_rounds.launches
    # The main path at full size, its launches counted alone.
    for fn in (steady_rounds, chaos_rounds, damped_rounds):
        fn.launches = 0
    full = run_damped_path(dev, G, CQ_FUSED_BLOCKS, start=settled,
                           crash_blocks=CQ_CRASH_BLOCKS)
    launches = damped_rounds.launches
    others = steady_rounds.launches + chaos_rounds.launches
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if small_launches <= 0 or launches <= 0:
        raise AssertionError(f"the check-quorum path never launched the damped "
                             f"kernel (G={CQ_SMALL_G}: {small_launches}, G={G}: "
                             f"{launches})")
    if others:
        raise AssertionError("the check-quorum path launched another kernel")
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
    t0 = time.perf_counter()
    small_cpu = run_damped_path("cpu", CQ_SMALL_G, CQ_SMALL_BLOCKS)
    full_cpu = run_damped_path("cpu", G, CQ_FUSED_BLOCKS, start=settled_cpu,
                               crash_blocks=CQ_CRASH_BLOCKS)
    t_cpu = time.perf_counter() - t0
    for note, a, b in ((f"damped G={CQ_SMALL_G}", small, small_cpu),
                       (f"damped G={G}", full, full_cpu)):
        assert_same(a[0], b[0], note)
        assert_same(a[3], b[3], note + " (before the crash blocks)")
        if a[1:3] != b[1:3]:
            raise AssertionError(f"{note}: fused/general counts differ {a[1:3]} {b[1:3]}")
    print(f"check-quorum path {CQ_SMALL_G}x{P} (init, {CQ_SETTLE} settle rounds, "
          f"{CQ_SMALL_BLOCKS} blocks; fused {small[1]}, general blocks {small[2]}) "
          f"and {G}x{P} (settled, {CQ_FUSED_BLOCKS} blocks, then {CQ_CRASH_BLOCKS} "
          f"with the acting leader crashed in 1% of groups, {elected} of "
          f"{len(range(0, G, 100))} of which elected a new leader; fused "
          f"{full[1]}, general blocks {full[2]}): card == CPU "
          f"on all {len(settled._fields)} fields, recent_active included; damped "
          f"kernel launches {small_launches} at G={CQ_SMALL_G} and {launches} at "
          f"G={G} (the main path's count); card {t_gpu:.2f}s, CPU {t_cpu:.2f}s")
    return full[3], launches


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
        "block_ms": t["block_ms"],
        "wrapper_ms": t["wrapper_ms"],
        "predicate_ms": t["predicate_ms"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="also write all results as JSON here")
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
    cfg, st, steady_launches = phase_main(dev)
    steady = phase_timing(dev, cfg, st)
    chaos_err, settled = phase_chaos_parity(dev)
    st, chaos_launches = phase_lossy(dev, settled)
    lossy = phase_lossy_timing(dev, st)
    damped_err, settled = phase_damped_parity(dev)
    st, damped_launches = phase_damped(dev, settled)
    damped = phase_damped_timing(dev, st)

    kernels = {"kernels": [
        kernel_entry("steady_rounds", STEADY_SOURCE, STEADY_REPLACES,
                     steady_launches, steady_err, steady),
        kernel_entry("chaos_rounds", CHAOS_SOURCE, CHAOS_REPLACES,
                     chaos_launches, chaos_err, lossy),
        kernel_entry("damped_rounds", DAMPED_SOURCE, DAMPED_REPLACES,
                     damped_launches, damped_err, damped),
    ]}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w", encoding="utf-8") as fh:
            json.dump({**kernels, "timing": {"steady": steady, "lossy": lossy,
                                              "damped": damped}},
                      fh, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
