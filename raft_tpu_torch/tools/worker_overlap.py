"""Time the steady fused loop (bare and `--health`) at 100k x 5 with
`chip_smoke.py`'s reference workers idle, busy, and busy at nice 19, in
turn, twice, and print one line a measurement: whether the CPU reference
runs beside the card's work slow the host-bound timing phases.

    python3 raft_tpu_torch/tools/worker_overlap.py [OUT.log]

Run it as a file from the root of a source tree; it imports that tree's
`chip_smoke.py`.  A busy worker runs damped general rounds at 100k on the
CPU for BUSY_S seconds with chip_smoke's thread share, as the reference
runs do; each timing is chip_smoke's loop: 6 warm-up blocks of 32 rounds,
then the median, min and max of 5 samples of 12 blocks.  Needs a CUDA card
and builds the steady kernel.
"""

import multiprocessing
import os
import statistics
import sys
import time
from concurrent.futures import ProcessPoolExecutor

BUSY_S = 40  # seconds of CPU work a worker does a measurement
SPAWN_S = 12  # seconds for the spawned workers to import and start working


def busy(nice):
    """In a worker: damped general rounds at 100k on the CPU for BUSY_S
    seconds, at `nice`; the rounds done."""
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.multiraft import sim

    os.nice(nice)
    cs.worker_threads()
    cfg = cs.damped_cfg(cs.G)
    st = sim.init_state(cfg, device="cpu")
    crashed = torch.zeros((cs.P, cs.G), dtype=torch.bool)
    append = torch.ones(cs.G, dtype=torch.int32)
    t0, n = time.time(), 0
    while time.time() - t0 < BUSY_S:
        st = sim.step(cfg, st, crashed, append)
        n += 1
    return n


def ticks(dev, st, h, health):
    """(median, min, max) ticks/s of fast_multi_round(k=32) from (st, h),
    with the health planes threaded when `health`."""
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.multiraft import fused_step, sim

    cfg = sim.SimConfig(n_groups=cs.G, n_peers=cs.P)
    crashed = torch.zeros((cs.P, cs.G), dtype=torch.bool, device=dev)
    append = torch.ones(cs.G, dtype=torch.int32, device=dev)
    fast = fused_step.fast_multi_round(cfg, k=cs.K, count_fused=True, with_health=health)

    def block(st, h):
        out = fast(st, crashed, append, *((h,) if health else ()), 0)
        return (out[0], out[1]) if health else (out[0], h)

    for _ in range(6):
        st, h = block(st, h)
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(12):
            st, h = block(st, h)
        torch.cuda.synchronize()
        samples.append(cs.G * cs.K * 12 / (time.perf_counter() - t0))
    return statistics.median(samples), min(samples), max(samples)


def main(argv):
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from raft_tpu_torch.multiraft import _build, sim

    out = open(argv[0], "a", encoding="utf-8") if argv else None

    def say(line):
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")

    say(f"{cs.card_line()}; {os.cpu_count()} CPUs, {cs.WORKERS} workers")
    dev = torch.device("cuda")
    _build.load_steady_cuda()
    st, _, h = cs.instrumented_settle(dev, sim.SimConfig(n_groups=cs.G, n_peers=cs.P), 30)
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(cs.WORKERS, mp_context=spawn) as pool:
        pool.submit(time.sleep, 0).result()
        for rnd in range(2):
            for mode, nice in (("idle", None), ("busy", 0), ("busy nice 19", 19)):
                futs = [] if nice is None else [
                    pool.submit(busy, nice) for _ in range(cs.WORKERS)]
                if futs:
                    time.sleep(SPAWN_S)
                res = {health: ticks(dev, st, h, health) for health in (False, True)}
                rounds = [f.result() for f in futs]
                say(f"round {rnd} {mode}: steady {res[False][0]:.4g} "
                    f"({res[False][1]:.4g}-{res[False][2]:.4g}), steady --health "
                    f"{res[True][0]:.4g} ({res[True][1]:.4g}-{res[True][2]:.4g}); "
                    f"worker rounds {rounds}")
    if out is not None:
        out.close()


if __name__ == "__main__":
    main(sys.argv[1:])
