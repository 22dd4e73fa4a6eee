#!/usr/bin/env python3
"""Drive raft_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py [--out results.json]

The main path is the 100k-group steady configuration (100,000 groups × 5
peers, election_tick 10, heartbeat_tick 1, one append per group per
round): ClusterSim settles 30 general rounds, then fast_multi_round(k=32)
advances one 32-round block at a time on the hand-written CUDA kernel
(raft_tpu_torch/multiraft/csrc/steady_round.cu) whenever the steady
predicate holds.  Phases, in order; any failure raises and the script
exits nonzero:

  1. device   — require CUDA; print the card's name and power limit
  2. build    — build the kernel from csrc/ with nvcc; print the time
  3. parity   — the kernel against its plain PyTorch version on the same
                card tensors, exact equality: settled states at G=100,000
                and a ragged G=100,003 (P=5), at P=3, and random planes
  4. main     — the main path on the card (kernel launch count zeroed just
                before, read just after), then the same on the CPU with
                the plain versions; every SimState field must be equal
  5. timing   — the bench's schedule (64-round scans, 6 scans a rep,
                median of 5 reps): ticks/s, fused_frac, the kernel's device
                time (torch.profiler, cold with L2 flushed before each
                launch, and hot), the plain version's time, the whole
                block and its parts (CUDA events), and the device's busy
                share and time by kernel over one rep
  6. report   — one JSON line of kernels, then the device line last

Exits 2 without a result when no CUDA device is available.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from raft_tpu_torch.multiraft import _build, fused_step, sim
from raft_tpu_torch.multiraft.kernels import ROLE_LEADER
from raft_tpu_torch.multiraft.steady_kernel import (
    steady_rounds,
    steady_rounds_reference,
    steady_work,
)

G, P, K = 100_000, 5, 32
SETTLE = 30
MAIN_BLOCKS = 4
ROUNDS_PER_SCAN, SCANS, REPS = 64, 6, 5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
OPS_PER_S = 67e12  # H100 SXM published non-tensor 32-bit rate
STEADY_SOURCE = "raft_tpu_torch/multiraft/csrc/steady_round.cu"
STEADY_REPLACES = "raft_tpu/multiraft/pallas_step.py:116"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def settle_on(device, n_groups, n_peers):
    cfg = sim.SimConfig(n_groups=n_groups, n_peers=n_peers)
    s = sim.ClusterSim(cfg, device=device)
    s.run(SETTLE, None, torch.ones(n_groups, dtype=torch.int32, device=s.device))
    return s.state


def kernel_inputs(st, crashed, append):
    """The steady kernel's operands, gathered as fused_step.steady_round
    gathers them."""
    is_leader = (st.state == ROLE_LEADER) & ~crashed
    f = is_leader.to(torch.int32)
    return (
        st.state, st.term, st.election_elapsed, st.heartbeat_elapsed,
        st.last_index, st.last_term,
        (st.matched * f[:, None, :]).sum(0, dtype=torch.int32), st.commit,
        st.voter_mask, st.voter_mask | st.learner_mask, crashed,
        (st.term_start_index * f).sum(0, dtype=torch.int32), append,
    )


def random_inputs(n_peers, n_groups, seed, device):
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def ints(hi, shape=(n_peers, n_groups)):
        return torch.randint(0, hi, shape, generator=gen, dtype=torch.int32).to(device)

    def bools(p):
        return (torch.rand((n_peers, n_groups), generator=gen) < p).to(device)

    return (ints(3), ints(5), ints(12), ints(3), ints(40), ints(5), ints(40),
            ints(40), bools(0.8), bools(0.9), bools(0.2), ints(40, (n_groups,)),
            ints(3, (n_groups,)))


def compare_kernel(args, rounds, note):
    """Kernel vs plain on the same card tensors; returns max |difference|."""
    kw = dict(rounds=rounds, election_tick=10, heartbeat_tick=1)
    got = steady_rounds(*args, **kw)
    want = steady_rounds_reference(*args, **kw)
    torch.cuda.synchronize()
    err = 0
    for name, g, w in zip(("ee", "hb", "li", "lt", "matched", "commit"), got, want):
        if g.dtype != torch.int32 or g.shape != w.shape:
            raise AssertionError(f"{note}: {name} is {g.dtype} {tuple(g.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{note}: kernel and plain version differ in {name}")
    print(f"parity {note}: exact (6 outputs, {args[0].shape[1]} groups)")
    return err


def phase_parity(dev):
    err = 0
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3)):
        st = settle_on(dev, n_groups, n_peers)
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
        err = max(err, compare_kernel(
            kernel_inputs(st, crashed, append), K, f"settled G={n_groups} P={n_peers}"))
        lead = st.state.eq(ROLE_LEADER).to(torch.int64).argmax(0)
        idx = torch.arange(n_groups, device=dev)
        crashed[(lead + 1) % n_peers, idx] = idx % 3 == 0
        err = max(err, compare_kernel(
            kernel_inputs(st, crashed, append), K,
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


def check_state(st):
    """Shapes, dtypes and the protocol's own invariants after the main path."""
    for f, v in st._asdict().items():
        if v is None:
            continue
        want = torch.bool if f.endswith("_mask") else torch.int32
        shape = (P, P, G) if f in ("matched", "agree") else (P, G)
        if v.dtype != want or tuple(v.shape) != shape:
            raise AssertionError(f"{f}: {v.dtype} {tuple(v.shape)}")
    # The bench's sanity rule: every group committed something.
    if int(st.commit.amax(0).min()) <= 0:
        raise AssertionError("some group never committed")


def phase_main(dev):
    steady_rounds.launches = 0
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
    for f in st_gpu._fields:
        a, b = getattr(st_gpu, f), getattr(st_cpu, f)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            raise AssertionError(f"card and CPU main paths differ in {f}")
    if fused != fused_cpu:
        raise AssertionError(f"fused counts differ: card {fused}, CPU {fused_cpu}")
    total = MAIN_BLOCKS * K * G
    print(f"main path {G}x{P}: {SETTLE} settle rounds + {MAIN_BLOCKS} blocks of "
          f"{K}: card == CPU on all {len(st_gpu._fields)} fields (commit max "
          f"{int(st_gpu.commit.max())}); steady kernel launches {launches}; "
          f"fused {fused}/{total}; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s")
    return cfg, st_gpu, launches


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
    before each).  Unlike CUDA events around a call, this leaves out the
    host's time to prepare the launch, during which the card waits."""
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
    if count != reps:
        raise AssertionError(f"profiler saw {count} launches of {name}, not {reps}")
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


def phase_timing(dev, cfg, st):
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    block = fused_step.fast_multi_round(cfg, k=K, count_fused=True)

    # The bench's timed loop: ticks/s over REPS reps of SCANS 64-round scans.
    blocks_per_scan = ROUNDS_PER_SCAN // K
    for _ in range(blocks_per_scan):  # warm-up scan, as the bench does
        st, _ = block(st, crashed, append, 0)
    torch.cuda.synchronize()
    samples, fused_total = [], 0
    ticks = G * ROUNDS_PER_SCAN * SCANS
    for _ in range(REPS):
        fused = 0
        t0 = time.perf_counter()
        for _ in range(SCANS * blocks_per_scan):
            st, fused = block(st, crashed, append, fused)
        torch.cuda.synchronize()
        samples.append(ticks / (time.perf_counter() - t0))
        fused_total += fused
    fused_frac = fused_total / (ticks * REPS)

    # The kernel alone at the main path's shapes, from the current state.
    args = kernel_inputs(st, crashed, append)
    kw = dict(rounds=K, election_tick=cfg.election_tick,
              heartbeat_tick=cfg.heartbeat_tick)
    scratch = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)

    def flush():
        scratch.fill_(1)  # 256 MB written: the 50 MB L2 holds none of the operands

    def launch():
        steady_rounds(*args, **kw)

    kernel_ms = kernel_device_ms(launch, "steady_round_kernel", 30, flush)
    kernel_hot_ms = kernel_device_ms(launch, "steady_round_kernel", 30)
    call_ms = cuda_ms(launch, 30, flush)
    plain_ms = cuda_ms(lambda: steady_rounds_reference(*args, **kw), 5, flush)
    round_fn = fused_step.steady_round(cfg, rounds=K)
    round_ms = cuda_ms(lambda: round_fn(st, crashed, append), 10, flush)
    pred_ms = cuda_ms(
        lambda: bool(fused_step.steady_predicate(cfg, st, crashed, K)), 10, flush)
    block_ms = cuda_ms(lambda: block(st, crashed, append, 0), 10, flush)
    del scratch

    def one_rep():
        s = st
        for _ in range(SCANS * blocks_per_scan):
            s, _ = block(s, crashed, append, 0)

    prof = device_profile(one_rep)
    loop_block_ms = statistics.median(ticks / x for x in samples) * 1e3 / (
        SCANS * blocks_per_scan)

    nbytes, ops = steady_work(P, G, K)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    card = card_line()
    med = statistics.median(samples)
    print(f"timing {G}x{P} k={K} [{card}]: ticks/s median {med:.1f} "
          f"(min {min(samples):.1f}, max {max(samples):.1f}, {REPS} reps), "
          f"fused_frac {fused_frac:.4f}; steady kernel {kernel_ms:.4f} ms cold "
          f"({kernel_hot_ms:.4f} ms hot; a steady_rounds call {call_ms:.4f} ms), "
          f"plain version {plain_ms:.3f} ms; "
          f"block {loop_block_ms:.3f} ms in the loop, {block_ms:.3f} ms alone = "
          f"predicate {pred_ms:.3f} + steady_round {round_ms:.3f} (wrapper "
          f"{round_ms - call_ms:.3f} + the steady_rounds call); bound {bound_ms:.4f} ms "
          f"(bytes {bytes_ms:.4f}, operations {ops_ms:.4f})")
    print(f"profile of one rep ({SCANS * blocks_per_scan} blocks): device busy "
          f"{prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%)")
    for row in prof["kernels"][:8]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return dict(
        ticks_per_s=samples, ticks_per_s_median=med, fused_frac=fused_frac,
        ms=kernel_ms, hot_ms=kernel_hot_ms, call_ms=call_ms, plain_ms=plain_ms,
        block_ms=block_ms, loop_block_ms=loop_block_ms, predicate_ms=pred_ms,
        steady_round_ms=round_ms, profile=prof,
        wrapper_ms=round_ms - call_ms, bound_ms=bound_ms,
        bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, operations=ops, card=card,
    )


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

    t0 = time.perf_counter()
    _build.load_steady_cuda()
    log, _ = _build.build_log.get("steady_round", ("(cached build)", 0.0))
    print(f"build: steady_round.cu in {time.perf_counter() - t0:.2f}s")
    for line in log.splitlines():
        if "entry function" in line or "registers" in line:
            print("  ptxas:", line.strip())

    max_err = phase_parity(dev)
    cfg, st, launches = phase_main(dev)
    t = phase_timing(dev, cfg, st)

    kernels = {"kernels": [{
        "name": "steady_rounds",
        "route": "cuda",
        "source": STEADY_SOURCE,
        "replaces": STEADY_REPLACES,
        "launches": launches,
        "max_abs_err": max_err,
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
    }]}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w", encoding="utf-8") as fh:
            json.dump({**kernels, "timing": t}, fh, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
