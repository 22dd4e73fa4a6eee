#!/usr/bin/env python3
"""Drive raft_tpu_torch's ported paths on one CUDA card and check them.

    python3 chip_smoke.py [--out results.json]

Eleven paths at 100,000 groups × 5 peers, the fused kernels past P = 7,
the host driver at 3 × 10,000 groups, the port's bench entry point
(`python -m raft_tpu_torch.bench`) in every mode, and the multi-GPU path
(ClusterSim(mesh=): `--mesh 1` at 1M × 3, and two ranks sharing the card).
Three with one append per group per round (bench.py's bench_device), each bare and instrumented
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

and eight more:

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
            most 4,096 do, and 32 general damped steps otherwise;
  reconfig  bench.py --reconfig examples/reconfig/joint_churn.json
            [--check-quorum]: ClusterSim.run_reconfig(plan), 88 rounds of
            joint-consensus membership change from the plan's bootstrap
            config on the general step, each group's conf entries proposed,
            gated on their dual-majority commit and applied to the mask
            planes, the joint-window safety invariants folded every round;
  prod-fused bench.py --prod-fused examples/reconfig/prod_fused.json: after
            a 192-round settle, reconfig.make_split_runner(k=8) over 256
            rounds of health, counters, a lossy chaos phase, check-quorum,
            pre-vote and three conf changes: op windows on the general step,
            8-round blocks between them on the damped kernel's with_loss
            with_health instance whenever the whole batch is steady;
  reads     bench.py --reads examples/reads/zipf_mixed.json: after a
            192-round settle, workload.make_split_runner(k=8) over 256
            rounds of Zipf writes, lease reads and Safe (ReadIndex) reads
            under check-quorum, pre-vote and lease reads: blocks of pure
            lease reads on the damped kernel's no-loss with_health instance
            whenever the whole batch is steady and every acting leader holds
            its lease, the rest on the general step with the read phase;
  autopilot bench.py --autopilot: after a 192-round settle under a Zipf(1.8,
            max 8) workload, Autopilot(fused=True).run_plan over 320 rounds
            (192 steady, 32 with peer 2 crashed, 96 healed) in cadence
            segments of 16: between segments the health summary crosses to
            the host and the policy kicks leaderless groups and transfers
            leadership off stalled leaders; a segment with no action and the
            whole batch steady runs the chaos kernel's with_health instance
            at k=16, the others the link-gated general step with the
            transfer pump;
  blackbox  bench.py --blackbox: SimConfig(blackbox=True) (an 8-round ring,
            an 8-wide capture) on the plain round, one append a group a
            round, every round folded into the black box; a black-box config
            never fuses, so the steady path's fused median is its baseline;
            with it the injected traps (forensics.run_commit_regress_trap,
            run_clock_pause_trap) and their one-group scalar repros;
  compiled  ClusterSim.run_compiled: one round captured into a CUDA graph
            (csrc/graph_cond.cu adds the plain round's election branch as a
            conditional node) and replayed, the plain round with the black
            box off and on and the check-quorum round, against
            ClusterSim.run; a checkpoint mid-run; runner.make_runner, the
            factory every scenario runner above is built by.

Past P = 7 each kernel runs from libraries of its own, one a peer count
(csrc/*_round_wide.cu): held to the plain versions at P = 8, 11 and 15
(the chaos and damped kernels' also at 12, 13 and 14), and driven
at P = 8.  From P = 13 the steady kernel is one library for every width,
csrc/steady_round_warp.cu, half a warp or a warp a group: held to its
plain version at P = 13 to 128, and driven and timed at 100,000 groups x
P = 65, the first width the port refused before it.  The chaos and damped
kernels' bounds are their bodies' work (chaos_body_work,
damped_body_work), the steady warp instance's its body's
(steady_wide_body_work), with the plain versions' (chaos_work,
damped_work, steady_work) printed beside them.
The host driver: examples/multiraft_node.py's node, 3 MultiRaft drivers
(peer ids 1-3) of 10,000 groups each with the tick on the card.

Phases, in order, each with its wall seconds; any failure raises and the
script exits nonzero.  Every settle of a path runs through
ClusterSim.run_compiled, equal to as many eager rounds (phase 22).  Every CPU run goes to one of two worker processes
(spawned at the start) and runs while the card works: those that need
nothing of the card are queued first, the others as their input exists;
phases 13, 16 to 22 and 22a wait for theirs, and the checks of phases 4,
4a, 7 and 10 wait until phase 23.  Every parity phase holds both variants of its
kernel, with_health=False and with_health=True (the latter with a random
ticks_since_commit row), against the plain version on the same cases.
Phases 4, 7 and 10 run their path on the card bare and instrumented
(ClusterSim(collect_counters=True, collect_health=True) for the settle,
fast_multi_round(k=32, with_health=True, with_counters=True) for the
blocks), each with the launch counts of both variants zeroed just before it
and read just after, and once on the CPU, instrumented: the reference for
both, since the extras never change the state.  Every SimState field, the
four health planes, window_pos, the counters, the health summary and the
fused and general block counts must be equal; the end-of-run summary is
printed as bench.py --health-out writes it.

  1. device        require CUDA; print the card's name and power limit
  2. build         build the three kernels (every P <= 7 instance, and
                   the wide libraries of P = 8, 11, 15, the chaos and
                   the damped kernels' also of 13 and 14, each side of
                   their shape switches, and of 12, and the
                   steady kernel's warp library) and run_compiled's graph
                   helper
                   (csrc/graph_cond.cu) from csrc/ with nvcc, one nvcc a
                   library, and the bench's native anchor
                   (csrc/multiraft_engine.cpp, g++ -O3), in parallel;
                   print the times and ptxas
                   registers and spills per P and template flag, then on
                   one line a kernel each chaos and damped instance's
                   registers, local (spill) bytes, shared memory a block,
                   threads a block and resident blocks an SM
                   (chaos_round_occupancy, damped_round_occupancy), and
                   the same for the steady warp instance at P = 16 to 128
                   and 200 (steady_round_occupancy; its P = 16 is a half-warp
                   group)
  3. parity        the steady kernel against its plain PyTorch version on
                   the same card tensors, exact: settled states at
                   G=100,000 and a ragged G=100,003 (P=5), at P=3, 8 and
                   13 (the warp instance), random planes at P=3, 5, 7, 8,
                   11 and 15 (the warp instance), and the warp instance on
                   random planes and
                   on random planes with one acting leader a group at P =
                   16, 17, 31, 32, 33, 64, 65, 96 and 128 (G=16,387; k=8
                   past P = 64)
 3a. bench         `python -m raft_tpu_torch.bench` through its line builder
                   (raft_tpu_torch.bench.main, printing each JSON line as
                   the command line does) at 100k x 5: default (with the
                   native CPU anchor, csrc/multiraft_engine.cpp at -O3),
                   --health, --lossy 0.01, --check-quorum, --check-quorum
                   --health and --blackbox at 5 reps; --lossy 0.01
                   --check-quorum, --chaos partition_heal.json and --reconfig
                   joint_churn.json (each with and without --check-quorum),
                   --prod-fused, --reads, --autopilot and --autopilot
                   --autopilot-plan partition_heal.json (its transfer arm
                   must act) at 1 rep; --health and the damped modes with
                   --fused-floor 1.0; the launch counts zeroed just before
                   each mode and read just after (a mode with fused
                   group-rounds must have launched its kernel); --profile
                   over the default mode once (the trace's size and CUDA
                   kernel records); the suites with --quick and the config-3
                   BASELINE row at 100k x 5; before the reference workers
                   start, so the bench's host-bound loops run on an idle host
  4. main          the steady path: 30 settle rounds, 4 blocks; the
                   steady predicate kernel's launches counted, one a block
 4a. fast_step     fused_step.fast_step's fused arm (the steady kernel at
                   k = 1) against its plain version on phase 4's state;
                   16 rounds of fast_step from it, the acting leader down
                   in 1% of groups in 4 of them (both arms), the launches
                   counted, held to the CPU run in phase 23
 4b. predicate     the dispatcher's steady predicate kernel
                   (csrc/steady_predicate.cu) against its plain version,
                   fused_step.steady_mask_reference, both on the card, at
                   1M x 3 for the benchmark's two fleets (raft-rs's ticks
                   at k = 32; TiKV's with check quorum and pre-vote at
                   k = 8), each settled by 64 general rounds, with nothing
                   down and with one of 30 stores down, at horizons 1 and
                   k: the bool mask group by group and the whole-batch
                   flag, exact; then on the settled fleet at its k the
                   call (the flag's set and the kernel) timed cold and hot
                   against the composition and its .all(), its device
                   records a call, and its bound, predicate_work's bytes
                   at 3.35 TB/s
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
                   and near 2**31 - 32; P=8 lossy-settled the same way;
                   random planes at P=3, 5, 7, 8, 11, 12, 13, 14 and 15,
                   and at each of those P random planes with exactly 0, 1
                   and 3 acting leaders a group at group bases 50,000 and
                   8,300,000
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
                   small and near 2**31 - 32), and at P=8; with_cq off on
                   a pre-vote-settled state; random planes at P=3, 5, 7,
                   8, 11, 12, 13, 14 and 15, every flag variant (13
                   and 14 the two sides of the kernel's 64/32-thread
                   switch)
 9a. wide          from the P=8 steady-, lossy- and damped-settled states
                   at G=100,000, two fast_multi_round(k=32) blocks each,
                   the launch counts zeroed just before and read just
                   after, every block equal to 32 general steps on the
                   card; each kernel's P=8 instance timed cold and hot
                   against its bound
 9b. wide steady   the steady path at G=100,000 x P=65 on the warp
                   instance: a 30-round settle through run_compiled, two
                   fast_multi_round(k=32) blocks, the launch counts zeroed
                   just before and read just after, each equal to 32
                   general steps on the card on every field; the instance
                   against its plain version on the settled operands (k=8,
                   both variants), then timed cold and hot at k=32 against
                   its body's bound and the reference's, the plain
                   version's time beside
 10. damped        the check-quorum path: at G=8,192 from init_state (one
                   instrumented 192-round settle each on the card and the
                   CPU, then 4 blocks), then the main path at G=100,000
                   from phase 9's settled state (2 fused blocks, then 3
                   with the acting leader crashed in 1% of groups: general
                   blocks with check-quorum step-downs and elections);
                   recent_active included; the steady predicate kernel's
                   launches at G=100,000 counted, one a block
 11. damped timing as phase 5, for the damped path and kernel; fused_frac
                   must be 1.0
 12. health timing as phase 5 for the steady and the check-quorum path with
                   the health planes threaded as bench.py --health does
                   (fused_frac must be 1.0), and the lossy with_health
                   kernel's device time cold and hot
 13. chaos scenario the plan with check_quorum off and on on the card, at
                   G=8,192 and at G=100,000 (no fused launch, zero safety
                   counts), timed as bench_chaos does (G x rounds / wall
                   from a fresh state: the median of the parity run and
                   phase 3a's rep, fused_frac 0) with
                   the busy share of its first 4 rounds; then held to the
                   CPU run at G=8,192: equal reports, every field and the
                   health planes, and the 100k run's first 8,192 groups
 14. composed timing the composed path's ticks/s and fused_frac from phase
                   3a's line; from phase 9's settled state as it is, the
                   block's parts as phase 5 and the busy share of 4 of the
                   general rounds its blocks run, with the damped kernel's
                   with_loss instance against its bound
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
 17. reconfig      joint_churn.json with check_quorum off and on on the card,
                   at G=8,192 and at G (no fused launch, zero safety
                   counts), then split=True (k=8) at G, equal to the unsplit
                   run, its fused kernel launches counted; timed as
                   bench_reconfig does (G x rounds / wall from the bootstrap
                   state: the parity run and phase 3a's rep) with the busy
                   share of its first
                   4 rounds; then held to the CPU run at G=8,192 (report,
                   every field, the health planes) and the G run's first
                   8,192 groups to it
 18. prod-fused    the settle at G on the card, the split runner (k=8, window
                   4, counters) from its first 8,192 groups and at G, the
                   launch counts zeroed just before the G run and read just
                   after; card == CPU at 8,192 (the CPU from its own
                   settle; every field, the op-protocol state, the stats,
                   counters, fused count and segments), the G run's first
                   8,192 groups equal to it, zero safety counts; the damped
                   with_loss with_health k=8 instance against its plain
                   version on the settled and the final state; timed (the
                   parity run and phase 3a's rep, from the settled state,
                   fused_frac as measured, the busy
                   share of the plan's first 4 rounds) and the kernel
                   against its bound
 19. reads         the settle at G on the card, the split runner (k=8) from
                   its first 8,192 groups with the plan compiled at 8,192,
                   then at G with the launch counts zeroed just before the
                   run and read just after, make_runner at G (equal to it on
                   every output), the stale-read trap on the card (clock
                   paused: the stale-read and dual-lease slots fire; no
                   drift: none); card == CPU at 8,192 on every output and
                   the fused count, the G run's first 8,192 groups equal to
                   the CPU run over the G schedule's first 8,192 columns (the
                   Zipf draws depend on the width), zero safety counts, the
                   trap's counts and receipts equal; the damped no-loss
                   with_health k=8 instance against its plain version on the
                   settled and the final state; timed (the parity run and
                   phase 3a's rep, from the settled state, fused_frac and
                   the latency percentiles as
                   measured, the busy share and launches of 4 general rounds
                   of the Safe-read phase) and the kernel against its bound
 20. autopilot     the settle at G on the card; the autopilot run from its
                   first 8,192 groups, held to the CPU's own procedure at
                   8,192 (the end state with transferee, the health planes,
                   the report and the action planes of every cadence); the
                   run at G with the launch counts zeroed just before it and
                   read just after, its first 8,192 groups held to a CPU
                   replay of the settle's first columns through
                   make_cadence_runner(fused=False) with the card's recorded
                   actions cut to them; fused=False at G equal on every
                   output but the fused count; zero safety counts; the chaos
                   kernel's with_health k=16 instance against its plain
                   version on the settled state and at the entry of the
                   first fused heal segment; timed (the parity run and phase
                   3a's rep: ticks/s, fused_frac, the report's MTTR, re-elections,
                   commit-stall group-rounds and actions; the busy share and
                   launches of 4 general rounds of the crash phase) and the
                   kernel against its bound
 21. forensics     card == CPU at G=8,192 over 64 plain rounds with the black
                   box on (state, ring, trip plane, round count, and the
                   capture of a seeded mask stamped by record_safety);
                   partition_heal.json at G with the black box on: report and
                   end state == phase 13's black-box-off run, its first 8,192
                   groups' ring and trip plane == the CPU run; the
                   commit-regress trap at G (P=3, its group-1 repro ==
                   tests/testdata/forensics/commit_regress.txt below line 1;
                   P=5) and the clock-pause trap at G (P=3, ==
                   clock_pause.txt): each captures exactly its offenders, the
                   repros replay RED, then green with the trap disabled; one
                   stamped violation reaches a HealthMonitor's
                   record_incident once; then timed (ClusterSim.run, off and
                   on, 3 alternating reps a side: blackbox_overhead_pct, and
                   blackbox_overhead_fused_pct against phase 5's median; the
                   launches and busy share of 4 rounds each), and
                   fast_multi_round(k=32) on a black-box config runs the
                   general branch with no fused launch
 22. compiled      ClusterSim.run_compiled against ClusterSim.run over 64
                   rounds at G: the plain round from a settled state (black
                   box off and on: ring, trip plane, round count), from
                   init_state (elections: the conditional node's taken arm),
                   with counters and health and a HealthMonitor (counter
                   totals), with health and a monitor (the summary
                   stream), and the link-gated round (a one-way 0 -> 1 cut
                   in even groups, health on, from init_state: one capture
                   of _linked_step's round, replayed 64 rounds == 64
                   run_round(link=) calls); the check-quorum round with
                   the black box on from phase 9's settled state:
                   run_compiled(12), save_state and
                   save_blackbox_state, load into a fresh ClusterSim,
                   run_compiled(12) == run(24); the four checkpoint families
                   round trip at G (file sizes printed); card == CPU at
                   8,192 (64 compiled plain rounds with the black box on, 24
                   compiled check-quorum and pre-vote rounds, from
                   init_state); runner.make_runner on partition_heal.json at
                   G == phase 13's run (report, end state, health planes);
                   then timed: run(64) against run_compiled(64), 2
                   alternating reps a side, plain with the black box off and
                   on and check-quorum: ticks/s, the ratio,
                   blackbox_overhead_pct on run_compiled, the capture's
                   seconds and node count, the election arm, the busy share
                   and launches of 4 rounds each way
22a. driver        3 MultiRaft drivers x 10,000 groups on the card
                   (examples/multiraft_node.run_schedule: elect, one
                   proposal a group, 32 steady ticks) held to the same
                   schedule with device="cpu" in a reference worker: every
                   tick's active count, the ticks to elect, every group's
                   (term, state, leader_id, committed, last_index) on every
                   driver and status() but its metrics; the election and
                   steady timings, the tick's sync latency, the active and
                   ready-scan shares, and a profile of 4 ticks a driver
22b. mesh          `python -m raft_tpu_torch.bench --mesh 1 --groups 1000000`
                   (config 5: one NCCL rank; its line printed) with its end
                   state == an unsharded run_compiled over the same segments;
                   2 gloo ranks sharing the card at 100k x 5 (sharding.launch:
                   run_compiled(64) from the election storm, the lossy path's
                   compiled settle and 2 fused chaos blocks, prod_fused.json's
                   compiled settle and run_reconfig(split=True, k=8)) == the
                   same paths unsharded on the card (end states, the health
                   planes, the report with fused_frac, the fused counts), the
                   launch counts zeroed just before each fused path and summed
                   over the ranks just after; the chaos kernel (k=32) and the
                   damped kernel's with_loss with_health instance (k=8) at
                   group bases 50,000 and 8,300,000 == their plain versions
                   and the slices of whole-batch launches, each timed at base
                   50,000 on 50,000 groups against its bound; the damped
                   instance also at base 0 on those 50,000 groups, and on
                   all 100,000 groups at bases 0 and 50,000
 23. references    the held-back checks of phases 4, 4a, 7 and 10 against
                   their CPU runs
 24. report        each phase's seconds and their sum, then one JSON line
                   of the eighteen kernel rows (the six variants, the damped
                   kernel's with_loss instance, its with_loss with_health
                   instance at k=8, its no-loss with_health instance at
                   k=8, the chaos kernel's with_health instance at k=16,
                   each kernel's P=8 instance, the steady warp instance at
                   P=65, and the chaos and damped with_loss with_health k=8
                   instances at a mesh rank's group base, and the steady
                   predicate kernel at each fleet of phase 4b), then the
                   device line last

With --quick it runs phases 1 to 3, 4b, 6, 9, 9a and 9b only (the builds and every
kernel against its plain version) and prints no result.  Exits 2 without a
result when no CUDA device is available.
"""

import argparse
import ctypes
import itertools
import json
import multiprocessing
import os
import platform
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

from raft_tpu_torch import bench as tbench
from raft_tpu_torch import profiling
from raft_tpu_torch.benches import suites
from raft_tpu_torch.multiraft import (
    _build, autopilot, chaos, checkpoint, forensics, fused_step, kernels as pk, native,
    predicate_kernel, reconfig, runner, sim, workload,
)
from raft_tpu_torch.examples import multiraft_node
from raft_tpu_torch.multiraft.health import HealthMonitor
from raft_tpu_torch.scalar.metrics import Metrics
from raft_tpu_torch.multiraft.chaos_kernel import (
    OUTPUT_NAMES as CHAOS_OUTPUTS,
    chaos_rounds,
    chaos_rounds_reference,
    chaos_body_work,
    chaos_work,
)
from raft_tpu_torch.multiraft.damped_kernel import (
    OUTPUT_NAMES as DAMPED_OUTPUTS,
    damped_rounds,
    damped_rounds_reference,
    damped_body_work,
    damped_work,
)
from raft_tpu_torch.multiraft.kernels import LOSS_SCALE, ROLE_LEADER, link_loss_draw
from raft_tpu_torch.multiraft import steady_kernel
from raft_tpu_torch.multiraft.steady_kernel import (
    steady_rounds,
    steady_rounds_reference,
    steady_wide_body_work,
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
CHAOS_SMALL_G, CHAOS_PROFILE_ROUNDS = 8192, 4
HERE = os.path.dirname(os.path.abspath(__file__))
RECONFIG_PLAN_NAME = "examples/reconfig/joint_churn.json"
RECONFIG_PLAN = os.path.join(HERE, RECONFIG_PLAN_NAME)
RECONFIG_SMALL_G = 8192
PROD_PLAN_NAME = "examples/reconfig/prod_fused.json"
PROD_PLAN = os.path.join(HERE, PROD_PLAN_NAME)
# bench_prod_fused: election_tick 64, a 3 x 64-round settle, k=8, window 4.
PROD_TICK, PROD_K, PROD_WINDOW = 64, 8, 4
# The profile covers 4 rounds, as the other general-step profiles do: a
# general round here is some 6,800 launches, and the plan's first 72 rounds
# gave the profiler 272,614 records to process.
PROD_SETTLE, PROD_PROFILE_ROUNDS = 3 * 64, 4
READS_PLAN_NAME = "examples/reads/zipf_mixed.json"
READS_PLAN = os.path.join(HERE, READS_PLAN_NAME)
# bench_reads: election_tick 64, a 3 x 64-round settle, k=8.
READS_TICK, READS_K, READS_SETTLE = 64, 8, 3 * 64
READS_SMALL_G, READS_PROFILE_ROUNDS = 8192, 4
# The first rounds of the plan's first lease phase and of its Safe-read phase.
READS_LEASE_AT, READS_SAFE_AT = 64, 160
# bench_autopilot: election_tick 64, a 3 x 64-round settle, cadence 16, and its
# inline plan: 192 rounds steady, 32 with peer 2 crashed, 96 healed.
AUTO_TICK, AUTO_CADENCE, AUTO_SETTLE = 64, 16, 3 * 64
AUTO_SMALL_G, AUTO_PROFILE_ROUNDS = 8192, 4
AUTO_DOC = {"name": "autopilot-bench", "peers": 5, "phases": [
    {"rounds": 192, "append": 0},
    {"rounds": 32, "crash": [2], "append": 0},
    {"rounds": 96, "heal": True, "append": 0}]}
AUTO_ROUNDS, AUTO_CRASH_AT, AUTO_HEAL_AT = 320, 192, 224
# bench_blackbox: the plain round with the black box off and on (window 8,
# capture width 8), one append a group a round, after a 30-round settle; a rep
# is SCANS runs of 64 rounds (the bench's rep), the two sides alternating rep
# by rep, as the host's speed drifts (three 64-round reps a side spread 30%).
BB_SMALL_G, BB_ROUNDS, BB_SETTLE, BB_REPS, BB_PROFILE_ROUNDS = 8192, 64, 30, 3, 4
# The injected traps' offender groups: both ends of the batch, and a group
# past 65,536, where the timeout stream's group key wraps 32 bits.
REGRESS_OFFENDERS = [1, 4097, 50_000, 99_999]
PAUSE_OFFENDERS = [1, 65_537]
DRAIN_GROUP = 77_777  # the group of the drain check's stamped violation
GOLDEN_DIR = os.path.join(HERE, "tests", "testdata", "forensics")
STORM_EVERY = 100  # the acting leader crashed in 1% of groups
# The composed path's parity blocks from the aligned state: no boundary in
# the first horizon, every boundary in the second, then 1% of leaders down.
COMPOSED_BRANCHES, COMPOSED_CRASH_BLOCK = ("pure", "slow", "split"), 2
ROUNDS_PER_SCAN, SCANS, REPS = 64, 6, 5
WORKERS = 2  # reference worker processes for the CPU runs
# Calls of a kernel's plain version a timing takes the median of: the plain
# version repeats the kernel's arithmetic in thousands of launches, up to
# 1.7 s a call at P = 65.
PLAIN_REPS = 3
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
# The wide instances (P = 8..15, csrc/*_round_wide.cu): held against their
# plain versions at WIDE_PEERS on random planes and at WIDE_P on settled
# 100k states, driven and timed at WIDE_P.
WIDE_P = 8
WIDE_PEERS = (8, 11, 15)
# A chaos and damped wide instance that no earlier run built with nvcc:
# built beside the others and held against its plain versions on random
# planes (P = 9 and 10 too would take the run past its time budget).
FILL_PEERS = (12,)
# The damped kernel's shape changes past P = 13 (csrc/damped_round.cu's
# DampedShape: 32 threads a block, not 64): these wide instances are also
# built and held against their plain versions on random planes.
DAMPED_SHAPE_PEERS = (13, 14)
# The chaos kernel's shape changes past P = 13 (csrc/chaos_round.cu's
# ChaosShape: the agree block leaves the registers for shared memory, 32
# threads a block, not 128): these wide instances, the two sides of the
# switch, are also built and held against their plain versions.
CHAOS_SHAPE_PEERS = (13, 14)
# Random chaos planes with exactly 0, 1 and 3 acting leaders in every
# group (each arm of the body's loss draws and agreement events), held at
# the mesh group bases on this many groups.
ARMS_G = 16_387
# The steady kernel's warp instance (csrc/steady_round_warp.cu, from
# steady_kernel.WARP_PEERS on): held against its plain version on random
# planes, and on random planes with one acting leader a group, at
# WARP_PARITY_PEERS on ARMS_G groups (k = K to P = 64, WARP_WIDE_K past it,
# where the plain version's network costs thousands of launches a round),
# and on a settled 100k state at steady_kernel.WARP_PEERS; driven and timed
# at WARP_P, the first P the port refused before the warp instance.
WARP_PARITY_PEERS = (16, 17, 31, 32, 33, 64, 65, 96, 128)
WARP_WIDE_K = 8
WARP_P = 65
WIDE_BLOCKS = 2
STEADY_SOURCE = "raft_tpu_torch/multiraft/csrc/steady_round.cu"
STEADY_REPLACES = "raft_tpu/multiraft/pallas_step.py:116"
CHAOS_SOURCE = "raft_tpu_torch/multiraft/csrc/chaos_round.cu"
CHAOS_REPLACES = "raft_tpu/multiraft/pallas_step.py:297"
DAMPED_SOURCE = "raft_tpu_torch/multiraft/csrc/damped_round.cu"
DAMPED_REPLACES = "raft_tpu/multiraft/pallas_step.py:889"
STEADY_WIDE_SOURCE = "raft_tpu_torch/multiraft/csrc/steady_round_wide.cu"
STEADY_WARP_SOURCE = "raft_tpu_torch/multiraft/csrc/steady_round_warp.cu"
CHAOS_WIDE_SOURCE = "raft_tpu_torch/multiraft/csrc/chaos_round_wide.cu"
DAMPED_WIDE_SOURCE = "raft_tpu_torch/multiraft/csrc/damped_round_wide.cu"
PREDICATE_SOURCE = "raft_tpu_torch/multiraft/csrc/steady_predicate.cu"
PREDICATE_REPLACES = "raft_tpu/multiraft/pallas_step.py:1355 (steady_mask)"
KERNELS = (steady_rounds, chaos_rounds, damped_rounds)
# ptxas registers and spills by library and template instance, for --out.
PTXAS = {}
# Each phase's wall seconds, in order.
PHASE_SECONDS = {}


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
            secs = time.perf_counter() - t0
            PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + secs
            print(f"[phase {name}: {secs:.1f} s]", flush=True)
            return out
        return run
    return wrap


@phase("build")
def phase_build():
    """The three kernels (the narrow libraries, P <= 7, the wide ones at
    WIDE_PEERS, the chaos and damped kernels' also at their shape switches
    and FILL_PEERS, and the steady kernel's warp instance) and
    run_compiled's graph helper built at once, one nvcc per library."""
    loaders = {"steady_round": _build.load_steady_cuda,
               "chaos_round": _build.load_chaos_cuda,
               "damped_round": _build.load_damped_cuda,
               "graph_cond": _build.load_graph_cuda,
               "steady_round_warp": _build.load_steady_warp_cuda,
               "multiraft_engine": native.load_library}
    # The wide libraries, one a peer count: those the checks below launch.
    for kind, load in (("steady", _build.load_steady_cuda),
                       ("chaos", _build.load_chaos_cuda),
                       ("damped", _build.load_damped_cuda)):
        extra = {"steady": (), "chaos": CHAOS_SHAPE_PEERS + FILL_PEERS,
                 "damped": DAMPED_SHAPE_PEERS + FILL_PEERS}[kind]
        for n_peers in WIDE_PEERS + extra:
            if kind == "steady" and n_peers >= steady_kernel.WARP_PEERS:
                continue  # the warp library's
            loaders[f"{kind}_round_p{n_peers}"] = lambda n=n_peers, f=load: f(n)
    with ThreadPoolExecutor(len(loaders)) as pool:
        for fut in [pool.submit(fn) for fn in loaders.values()]:
            fut.result()  # raises a failed build's error
    for name in loaders:
        log, secs = _build.build_log.get(name, ("(cached build)", 0.0))
        if name == "multiraft_engine":
            print(f"build: lib{name} (the bench's native CPU anchor, g++ "
                  f"{' '.join(_build.NATIVE_FLAGS)}) in {secs:.2f}s")
            continue
        PTXAS[name] = {"seconds": secs, "instances": {}}
        entry = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                # The template arguments: P, then the flags (the damped
                # kernel's cq and loss), with_health last; the steady warp
                # instance's J (peers a lane, 0 for the runtime-J one),
                # with_health and its lanes a group.
                if "steady_warp_kernel" in line:
                    j, health, lanes = re.search(
                        r"ILi(\d+)ELb(\d)ELi(\d+)E", line).groups()
                    entry = f"J={j} health={health} lanes={lanes}"
                    continue
                if "ILi" not in line:  # not a kernel templated on P
                    entry = line.split("'")[1] if "'" in line else "?"
                    continue
                args = line.split("ILi")[1].split("EE")[0].split("ELb")
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
        print(f"build: lib{name} in {secs:.2f}s, {len(inst)} instances; ptxas "
              "registers (spill-store bytes where nonzero):")
        for entry in sorted(inst):
            r = inst[entry]
            spill = f" ({r['spill_stores']} B spilled)" if r.get("spill_stores") else ""
            print(f"  {entry}: {r.get('registers')}{spill}")


OCCUPANCY_KEYS = ("registers", "local_bytes", "shared_bytes", "threads", "blocks_per_sm")


def kernel_occupancy(kind):
    """Each built chaos or damped (`kind`) instance's registers a thread,
    local (spill) bytes a thread, shared memory bytes a block, threads a
    block and resident blocks an SM (the library's `{kind}_round_occupancy`),
    printed on one line."""
    narrow = tuple(range(1, _build.NARROW_PEERS + 1))
    if kind == "chaos":
        load, peers, names = _build.load_chaos_cuda, CHAOS_SHAPE_PEERS, ("health",)
    else:
        load, peers, names = _build.load_damped_cuda, DAMPED_SHAPE_PEERS, (
            "cq", "loss", "health")
    rows = {}
    for n_peers in sorted(set(narrow + WIDE_PEERS + peers + FILL_PEERS)):
        fn = getattr(load(n_peers), f"{kind}_round_occupancy")
        for flags in itertools.product((0, 1), repeat=len(names)):
            out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
            rc = fn(n_peers, *flags, out)
            if rc != 0:
                raise RuntimeError(f"{kind}_round_occupancy failed: CUDA error {rc}")
            key = " ".join([f"P={n_peers}"] + [f"{n}={v}" for n, v in zip(names, flags)])
            rows[key] = dict(zip(OCCUPANCY_KEYS, out))
    print(f"{kind} occupancy [{card_line()}] (registers / local bytes a thread / "
          "shared bytes a block / threads a block / resident blocks an SM): " + "; ".join(
              f"{k} {'/'.join(str(v) for v in r.values())}" for k, r in rows.items()))
    return rows


def warp_occupancy():
    """The steady warp instance's registers, local bytes, shared bytes a
    block, threads a block and resident blocks an SM at each P of
    WARP_PARITY_PEERS (J = 1..4) and at P = 200 (the runtime-J instance),
    both variants (steady_round_occupancy), printed on one line."""
    lib = _build.load_steady_warp_cuda()
    rows = {}
    for n_peers in WARP_PARITY_PEERS + (200,):
        for health in (0, 1):
            out = (ctypes.c_int * len(OCCUPANCY_KEYS))()
            rc = lib.steady_round_occupancy(n_peers, health, out)
            if rc != 0:
                raise RuntimeError(f"steady_round_occupancy failed: CUDA error {rc}")
            rows[f"P={n_peers} health={health}"] = dict(zip(OCCUPANCY_KEYS, out))
    print(f"steady warp occupancy [{card_line()}] (registers / local bytes a thread / "
          "shared bytes a block / threads a block / resident blocks an SM): " + "; ".join(
              f"{k} {'/'.join(str(v) for v in r.values())}" for k, r in rows.items()))
    return rows


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


def one_acting_leader(args, seed):
    """Steady operands `args` with new roles and crashes: exactly one acting
    leader in every group (a random slot, alive in the leader role), the
    other peers random followers and candidates."""
    n_peers, n_groups = args[0].shape
    dev = args[0].device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    state = torch.randint(0, 2, (n_peers, n_groups), generator=gen,
                          dtype=torch.int32).to(dev)
    lead = torch.randint(0, n_peers, (n_groups,), generator=gen).to(dev)
    idx = torch.arange(n_groups, device=dev)
    crashed = args[10].clone()
    state[lead, idx] = ROLE_LEADER
    crashed[lead, idx] = False
    return (state,) + tuple(args[1:10]) + (crashed,) + tuple(args[11:])


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
    """Returns ((plain, with_health) max |difference|, the same over the
    wide cases (P = 8..15) alone, the settled 100k x WIDE_P state, and the
    same over the warp instance's cases)."""
    err, wide_err, wide_settled, warp_err = (0, 0), (0, 0), None, (0, 0)
    warp_from = steady_kernel.WARP_PEERS
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3), (G, WIDE_P),
                              (G, warp_from)):
        st = settle_on(dev, n_groups, n_peers)
        if n_peers == WIDE_P:
            wide_settled = st
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
        e = compare_kernel(fused_step.steady_operands(st, crashed, append), K,
                           f"settled G={n_groups} P={n_peers}")
        crashed = crash_followers(st, n_peers, n_groups, dev)
        e = worst(e, compare_kernel(
            fused_step.steady_operands(st, crashed, append), K,
            f"settled+crashed followers G={n_groups} P={n_peers}"))
        err = worst(err, e)
        if n_peers >= warp_from:
            warp_err = worst(warp_err, e)
        elif n_peers > _build.NARROW_PEERS:
            wide_err = worst(wide_err, e)
    for n_peers in (3, 5, 7) + WIDE_PEERS:
        e = compare_kernel(random_inputs(n_peers, G + 3, n_peers, dev), K,
                           f"random planes G={G + 3} P={n_peers}")
        err = worst(err, e)
        if n_peers >= warp_from:
            warp_err = worst(warp_err, e)
        elif n_peers > _build.NARROW_PEERS:
            wide_err = worst(wide_err, e)
    for n_peers in WARP_PARITY_PEERS:
        rounds = K if n_peers <= 64 else WARP_WIDE_K
        planes = random_inputs(n_peers, ARMS_G, n_peers, dev)
        for note, args in (("random planes", planes),
                           ("one acting leader", one_acting_leader(planes, n_peers))):
            e = compare_kernel(args, rounds, f"{note} G={ARMS_G} P={n_peers} k={rounds}")
            err, warp_err = worst(err, e), worst(warp_err, e)
    return err, wide_err, wide_settled, warp_err


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
def phase_main(dev, pool):
    """The steady path on the card, bare and instrumented; the CPU's
    instrumented run (the reference for both) goes to a reference worker.
    Returns (cfg, the bare final state, its steady kernel launches, the
    instrumented card run, its with_health launches, check, its steady
    predicate kernel launches), check() holding both card runs to the CPU
    run."""
    zero_launches()
    t0 = time.perf_counter()
    cfg, st_gpu, fused = run_main_path(dev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = bare_launches(steady_rounds, "the steady main path")
    pred_launches = predicate_launches(MAIN_BLOCKS, "the steady main path")
    check_state(st_gpu)
    kw = dict(cfg=cfg, blocks=MAIN_BLOCKS, settle=SETTLE)
    run, check_run, h_launches = instrumented_pair(
        dev, "steady", steady_rounds, (MAIN_BLOCKS, 0), pool.submit(cpu_health_path, kw),
        **kw)

    def check():
        ref = check_run()
        same_as_reference((st_gpu, fused, 0), ref, "steady main path")
        print(f"main path {G}x{P}: {SETTLE} settle rounds + {MAIN_BLOCKS} blocks of "
              f"{K}: card == CPU on all {len(st_gpu._fields)} fields (commit max "
              f"{int(st_gpu.commit.max())}); steady kernel launches {launches}, "
              f"steady predicate launches {pred_launches}; "
              f"fused {fused}/{MAIN_BLOCKS * K * G}; card {t_gpu:.2f}s")

    return cfg, st_gpu, launches, run, h_launches, check, pred_launches


# --- the one-round dispatcher (fused_step.fast_step) --------------------------

FAST_STEP_ROUNDS = 16
FAST_STEP_CRASH = range(6, 10)  # rounds with the acting leader down in 1% of groups


def run_fast_step(st):
    """FAST_STEP_ROUNDS rounds of fast_step from `st` (one append a group a
    round, the acting leader down in every STORM_EVERY-th group in the
    FAST_STEP_CRASH rounds): (final state, the rounds whose predicate
    held)."""
    cfg = sim.SimConfig(n_groups=st.term.shape[1], n_peers=st.term.shape[0])
    fast = fused_step.fast_step(cfg)
    dev = st.term.device
    append = torch.ones(cfg.n_groups, dtype=torch.int32, device=dev)
    none = torch.zeros((cfg.n_peers, cfg.n_groups), dtype=torch.bool, device=dev)
    down = crash_leaders(st, none)
    fused = []
    for r in range(FAST_STEP_ROUNDS):
        crashed = down if r in FAST_STEP_CRASH else none
        if bool(fused_step.steady_predicate(cfg, st, crashed, 1)):
            fused.append(r)
        st = fast(st, crashed, append)
    return st, fused


def cpu_fast_step(start):
    """In a reference worker: run_fast_step on the CPU from a numpy state."""
    worker_threads()
    st, fused = run_fast_step(sim.state_from_numpy(start, "cpu"))
    return sim.state_to_numpy(st), fused


@phase("fast_step")
def phase_fast_step(dev, st, pool):
    """fast_step's fused arm (the steady kernel at k = 1) against its plain
    version on the settled 100k x 5 state, both variants; then
    FAST_STEP_ROUNDS rounds of fast_step on the card from that state, both
    arms, the launches counted.  Returns check(), which holds the card's
    rounds to the CPU's from a reference worker."""
    append = torch.ones(G, dtype=torch.int32, device=dev)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    err = compare_kernel(fused_step.steady_operands(st, crashed, append), 1,
                         f"fast_step's fused arm, k=1, settled G={G} P={P}")
    ref = pool.submit(cpu_fast_step, sim.state_to_numpy(st))
    zero_launches()
    got, fused = run_fast_step(st)
    torch.cuda.synchronize()
    launches = bare_launches(steady_rounds, "fast_step")
    if launches != len(fused) or not 0 < len(fused) < FAST_STEP_ROUNDS:
        raise AssertionError(f"fast_step: {launches} fused launches over the fused "
                             f"rounds {fused}: both arms must run")

    def check():
        want, cpu_fused = ref.result()
        assert_same(got, sim.state_from_numpy(want, "cpu"), "fast_step")
        if cpu_fused != fused:
            raise AssertionError(f"fast_step: fused rounds {fused} on the card, "
                                 f"{cpu_fused} on the CPU")
        print(f"fast_step {G}x{P}: {FAST_STEP_ROUNDS} rounds from the settled state "
              f"(the acting leader down in 1% of groups in rounds "
              f"{FAST_STEP_CRASH.start}-{FAST_STEP_CRASH.stop - 1}): card == CPU on "
              f"every field; fused arm in rounds {fused} ({launches} steady kernel "
              f"launches at k=1), the general step in the others")

    return err, check


# --- the dispatcher's steady predicate (csrc/steady_predicate.cu) -------------

PREDICATE_G, PREDICATE_P, PREDICATE_SETTLE = 1_000_000, 3, 64
# The benchmark's two fleets and their block lengths: raft-rs's harness
# ticks at k = 32, TiKV's raftstore settings at k = 8.
PREDICATE_FLEETS = {
    "raftrs-1m-r3": (dict(election_tick=10, heartbeat_tick=1), 32),
    "tikv-1m-r3": (dict(election_tick=10, heartbeat_tick=2, check_quorum=True,
                        pre_vote=True), 8),
}
PREDICATE_PROFILE_CALLS = 10


def store_down(n_peers, n_groups, dev):
    """The replicas on one of 30 stores down (peer p of group g on store
    (g * n_peers + p) % 30)."""
    g = torch.arange(n_groups, device=dev)[None, :]
    p = torch.arange(n_peers, device=dev)[:, None]
    return (g * n_peers + p) % 30 == 0


@phase("predicate")
def phase_predicate(dev):
    """The steady predicate kernel against fused_step.steady_mask_reference
    on the same card tensors at 1M x 3 for each fleet, exact; then its call
    timed against the composition.  Returns {fleet: (mismatched groups,
    timing)}."""
    out = {}
    for fleet, (ticks, k) in PREDICATE_FLEETS.items():
        G_, P_ = PREDICATE_G, PREDICATE_P
        cfg = sim.SimConfig(n_groups=G_, n_peers=P_, **ticks)
        s = sim.ClusterSim(cfg, device=dev)
        s.run(PREDICATE_SETTLE, None, torch.ones(G_, dtype=torch.int32, device=dev))
        st = s.state
        none = torch.zeros((P_, G_), dtype=torch.bool, device=dev)
        err = 0
        for label, crashed in (("settled", none), ("a store down", store_down(P_, G_, dev))):
            for horizon in (1, k):
                note = f"steady predicate {fleet}, {label}, horizon {horizon}"
                want = fused_step.steady_mask_reference(cfg, st, crashed, horizon)
                got = predicate_kernel.steady_invariant(cfg, st, crashed, horizon)
                flag = predicate_kernel.steady_invariant(cfg, st, crashed, horizon,
                                                         whole=True)
                err += int((got != want).sum())
                if bool(flag) != bool(want.all()):
                    raise AssertionError(f"{note}: flag {bool(flag)}, the composition's "
                                         f"{bool(want.all())}")
                # Both answers must be seen: the settled fleet holds the
                # invariant, and a store down breaks it in some groups only.
                held = int(want.sum())
                if (held == G_) != (crashed is none) or held == 0:
                    raise AssertionError(f"{note}: {held} of {G_} groups steady")
        if err:
            raise AssertionError(f"steady predicate {fleet}: {err} groups differ from "
                                 f"the composition")

        def kernel():
            return predicate_kernel.steady_invariant(cfg, st, none, k, whole=True)

        def reference():
            return fused_step.steady_mask_reference(cfg, st, none, k).all()

        # The bound is the bytes': the integer work is a tenth of their time
        # (predicate_kernel's docstring).
        work = (predicate_kernel.predicate_work(P_, G_, cfg.check_quorum), 0)
        t = kernel_times(dev, kernel, reference, (), {}, work)
        reps = PREDICATE_PROFILE_CALLS
        for route, fn in (("kernel", kernel), ("plain", reference)):
            prof = device_profile(lambda: [fn() for _ in range(reps)])
            t[f"{route}_records"] = sum(r["count"] for r in prof["kernels"]) / reps
            t[f"{route}_device_ms"] = prof["busy_us"] / reps / 1e3
            if route == "kernel":
                named = sum(r["count"] for r in prof["kernels"]
                            if "steady_predicate_kernel" in r["name"])
                if not 0 < named <= reps or t["kernel_records"] > 2:
                    raise AssertionError(
                        f"steady predicate {fleet}: {prof['kernels']} over {reps} calls")
        t["launches_per_call"] = t["kernel_records"]
        out[fleet] = (err, t)
        print(f"steady predicate {fleet} {G_}x{P_} k={k}: kernel == composition on "
              f"every group (settled and a store down, horizons 1 and {k}); "
              f"{t['ms']:.4f} ms cold, {t['hot_ms']:.4f} hot, call {t['call_ms']:.4f}, "
              f"{t['kernel_records']:.1f} device records a call against the "
              f"composition's {t['plain_records']:.1f} and {t['plain_ms']:.4f} ms; bound "
              f"{t['bound_ms']:.4f} ms by bytes ({100 * t['bound_ms'] / t['ms']:.1f} % "
              f"of it); {t['card']}")
        del s, st
    return out


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


def device_rows(averages):
    """The rows of a profile's key_averages() that are the card's own work:
    kernels, copies and sets.  With CUDA activity on, each record_function
    range that encloses device work (a span of the program's, were one not
    muted) has a CUDA row of its own over the same kernels; those rows are
    left out, or the work inside them would count again."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profiler_ms(fn, name, reps, flush=None):
    """(ms, launches seen): torch.profiler's device time a launch of the
    kernel whose name contains `name` over `reps` calls of fn() (`flush`
    before each), the mean over the launches it recorded; ms is None when
    it recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profiling.muted(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    rows = [e for e in device_rows(prof.key_averages()) if name in e.key]
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
    upper bound; the program's spans are muted, as each would add its own."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profiling.muted(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = sorted(
        ((e.key, e.self_device_time_total, e.count)
         for e in device_rows(prof.key_averages()) if e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in kernels)
    return dict(wall_us=wall_us, busy_us=busy_us,
                busy_share=busy_us / wall_us if wall_us else 0.0,
                kernels=[dict(name=k[:120], us=us, count=n) for k, us, n in kernels])


def time_path(dev, label, st, rb, block, operands, kernel, reference, kernel_name,
              fused_round, predicate, work, compare_methods=False, reps=REPS,
              scans=SCANS, part_reps=10, profile=None, line=None):
    """The bench's timed loop over `block(st, rb, fused) -> (st, fused)`
    (rb the absolute round of the block's first round; `st` is the loop's
    carry: a SimState, or (SimState, HealthState) on a health path), `reps`
    reps of `scans` scans, then the parts of one block from the loop's final
    state: the kernel (`kernel(*args, **kw)` with `operands(st, rb) ->
    (args, kw)`), its plain version, the fused round, the predicate and the
    block (`part_reps` calls each), and a profile of one rep, or with
    `profile` = (what, fn) of fn(st, rb).  With `compare_methods`, the
    kernel's time by each timing method as well.  With `line` (the bench's
    JSON line of the same loop, `reps` reps of `scans` scans), its ticks/s
    and fused_frac stand for the loop's, which does not run here."""
    blocks_per_scan = ROUNDS_PER_SCAN // K
    ticks = G * ROUNDS_PER_SCAN * scans
    if line is not None:
        samples, fused_frac = bench_samples(line), line["fused_frac"]
    else:
        for _ in range(blocks_per_scan):  # warm-up scan, as the bench does
            st, _ = block(st, rb, 0)
            rb += K
        torch.cuda.synchronize()
        samples, fused_total = [], 0
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
    source = "the bench line's" if line is not None else ""
    print(f"timing {label} {G}x{P} k={K} [{t['card']}]: ticks/s median {med:.1f} "
          f"(min {min(samples):.1f}, max {max(samples):.1f}, {source} {reps} reps of "
          f"{scans} scans), "
          f"fused_frac {fused_frac:.4f}; {kernel_name} {t['ms']:.4f} ms cold "
          f"({t['hot_ms']:.4f} ms hot; a wrapper call {t['call_ms']:.4f} ms), "
          f"plain version {t['plain_ms']:.3f} ms; "
          f"block {loop_block_ms:.3f} ms in the loop, {t['block_ms']:.3f} ms alone = "
          f"predicate {t['predicate_ms']:.3f} + fused round {t['fused_round_ms']:.3f} "
          f"(wrapper {t['wrapper_ms']:.3f} + the kernel call); bound "
          f"{t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f}){plain_bound_note(t)}")
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
             plain_ms=cuda_ms(lambda: reference(*args, **kw), PLAIN_REPS, flush))
    for name, fn in (parts or {}).items():
        t[name] = cuda_ms(fn, part_reps, flush)
    if methods_of is not None:
        t["methods"] = timing_methods(dev, launch, methods_of, flush)
    del scratch
    nbytes, ops, *plain = work
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    t.update(bound_ms=max(bytes_ms, ops_ms), bytes_bound_ms=bytes_ms,
             ops_bound_ms=ops_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=nbytes, operations=ops, card=card_line())
    if plain:  # the plain version's count beside the body's (bound_work)
        pbytes, pops = plain[0]
        t["plain_work_bound_ms"] = max(pbytes / HBM_BYTES_PER_S, pops / OPS_PER_S) * 1e3
    return t


def plain_bound_note(t):
    """The plain version's bound and the kernel's share of it, where
    kernel_times recorded one (the chaos and damped kernels), for a printed
    line."""
    if "plain_work_bound_ms" not in t:
        return ""
    b = t["plain_work_bound_ms"]
    return f"; the plain version's work {b:.4f} ms ({100 * b / t['ms']:.1f} % of it)"


# The chaos and damped kernels' work counts: the body's (chaos_body_work,
# damped_body_work), which sets the kernel's bound, and the plain
# version's (chaos_work, damped_work), the yardstick the rows before each
# kernel's redesign were held to.
WORK_COUNTS = {"chaos": (chaos_body_work, chaos_work),
               "damped": (damped_body_work, damped_work)}


def bound_work(kernel, n_peers, n_groups, rounds, **flags):
    """`kernel`'s ("chaos" or "damped") work for kernel_times: its body's
    (bytes, operations), then the plain version's, whose bound
    kernel_times records beside the kernel's as plain_work_bound_ms."""
    body, plain = WORK_COUNTS[kernel]
    work = (n_peers, n_groups, rounds)
    return body(*work, **flags) + (plain(*work, **flags),)


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


def compiled_settle(cfg, device, rounds, append=None, masks=()):
    """init_state (from `masks`) and `rounds` rounds of `append` (one a
    group by default) with no extras, through ClusterSim.run_compiled: the
    same state as as many sim.step calls (the compiled phase holds
    run_compiled to run), in a fraction of the eager rounds' time."""
    s = sim.ClusterSim(cfg._replace(collect_counters=False, collect_health=False),
                       *masks, device=device)
    if append is None:
        append = torch.ones(cfg.n_groups, dtype=torch.int32, device=s.device)
    s.run_compiled(rounds, append_n=append)
    return s.state


def lossy_settle(device, n_groups, n_peers=P):
    """init_state and LOSSY_SETTLE plain rounds of one append per group."""
    return compiled_settle(lossy_cfg(n_groups, n_peers), device, LOSSY_SETTLE)


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


def place_leaders(args, n_leaders, seed):
    """Chaos operands `args` with new roles and crashes: exactly
    `n_leaders` acting leaders in every group (slots g, g + 1, ... mod P,
    alive in the leader role), the other peers followers or candidates,
    one of them in every odd group in the leader role but crashed, so not
    acting."""
    P, n_groups = args[0].shape
    dev = args[0].device
    gen = torch.Generator(device="cpu").manual_seed(seed)
    state = torch.randint(0, 2, (P, n_groups), generator=gen, dtype=torch.int32).to(dev)
    crashed = args[10].clone()
    idx = torch.arange(n_groups, device=dev)
    for j in range(n_leaders):
        state[(idx + j) % P, idx] = ROLE_LEADER
        crashed[(idx + j) % P, idx] = False
    if n_leaders < P:
        odd = idx[1::2]
        state[(odd + n_leaders) % P, odd] = ROLE_LEADER
        crashed[(odd + n_leaders) % P, odd] = True
    acting = (state == ROLE_LEADER) & ~crashed
    if not bool((acting.sum(0) == n_leaders).all()):
        raise AssertionError(f"place_leaders: not {n_leaders} acting leaders a group")
    return (state,) + tuple(args[1:10]) + (crashed,) + tuple(args[11:])


def compare_chaos(args, round_base, note, election_tick=LOSSY_TICK, group_base=0):
    kw = dict(round_base=round_base, rounds=K, election_tick=election_tick,
              heartbeat_tick=1, group_base=group_base)
    return compare_variants(chaos_rounds, chaos_rounds_reference, CHAOS_OUTPUTS,
                            args, kw, f"{note} round_base={round_base}"
                            + (f" group_base={group_base}" if group_base else ""))


@phase("chaos parity")
def phase_chaos_parity(dev):
    """Returns ((plain, with_health) max |difference|, the settled 100k × 5
    lossy state, the difference over the wide cases alone, the settled
    100k x WIDE_P lossy state)."""
    err, wide_err, settled, wide_settled = (0, 0), (0, 0), None, None
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3), (G, WIDE_P)):
        st0 = lossy_settle(dev, n_groups, n_peers)
        if (n_groups, n_peers) == (G, P):
            settled = st0
        if n_peers == WIDE_P:
            wide_settled = st0
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
                    e = compare_chaos(
                        args, rb, f"lossy-settled G={n_groups} P={n_peers} "
                        f"{loss_name} loss, {crashed_name}")
                    err = worst(err, e)
                    if n_peers > _build.NARROW_PEERS:
                        wide_err = worst(wide_err, e)
    for n_peers in (3, 5, 7) + WIDE_PEERS + CHAOS_SHAPE_PEERS + FILL_PEERS:
        args = random_chaos_inputs(n_peers, G + 3, 10 + n_peers, dev)
        for rb in (7, 2**31 - K):
            e = compare_chaos(args, rb, f"random planes G={G + 3} P={n_peers}",
                              election_tick=6)
            err = worst(err, e)
            if n_peers > _build.NARROW_PEERS:
                wide_err = worst(wide_err, e)
        # Each leader arm of the body: no acting leader, one, and three.
        for n_leaders in (0, 1, 3):
            arms = place_leaders(random_chaos_inputs(n_peers, ARMS_G, 30 + n_peers, dev),
                                 n_leaders, 40 + n_peers)
            for base in MESH_BASES:
                e = compare_chaos(arms, 2**31 - K, f"random planes G={ARMS_G} "
                                  f"P={n_peers} {n_leaders} acting leaders",
                                  election_tick=6, group_base=base)
                err = worst(err, e)
                if n_peers > _build.NARROW_PEERS:
                    wide_err = worst(wide_err, e)
    return err, settled, wide_err, wide_settled


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


def cpu_lossy_small():
    """In a reference worker: the lossy path at LOSSY_SMALL_G from init_state
    on the CPU, (state arrays, fused, general blocks, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    st, fused, general = run_lossy_path("cpu", LOSSY_SMALL_G, LOSSY_SMALL_BLOCKS)
    return sim.state_to_numpy(st), fused, general, time.perf_counter() - t0


@phase("lossy")
def phase_lossy(dev, settled, pool, small_ref):
    """The lossy path: at G=8,192 from init_state and at G=100,000 from the
    settled state on the card, bare and instrumented; the CPU's runs (the
    small one, `small_ref`, a reference worker's future of
    cpu_lossy_small(), and the instrumented 100k one, the reference for
    both 100k runs) in a reference worker.  Returns (the bare 100k state,
    its chaos kernel launches, the instrumented card run, its with_health
    launches, check)."""
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
    cfg = lossy_cfg(G)
    kw = dict(cfg=cfg, blocks=3, chaos=True, round_base=LOSSY_SETTLE, cut_last=True)
    run, check_run, h_launches = instrumented_pair(
        dev, "lossy", chaos_rounds, (2, 1),
        pool.submit(cpu_health_path, kw, sim.state_to_numpy(settled)),
        start=fresh_start(settled, cfg), **kw)

    def check():
        arrays, fused, general, t_cpu = small_ref.result()
        assert_same(small[0], sim.state_from_numpy(arrays, "cpu"), f"lossy G={LOSSY_SMALL_G}")
        if small[1:] != (fused, general):
            raise AssertionError(f"lossy G={LOSSY_SMALL_G}: fused/general counts differ "
                                 f"{small[1:]} {(fused, general)}")
        same_as_reference(full, check_run(), f"lossy G={G}")
        print(f"lossy path {LOSSY_SMALL_G}x{P} (init, {LOSSY_SETTLE} settle rounds, "
              f"{LOSSY_SMALL_BLOCKS} blocks; fused {small[1]}, general blocks {small[2]}) "
              f"and {G}x{P} (settled, 3 blocks, the last with a link down in 1% of "
              f"groups; fused {full[1]}, general blocks {full[2]}): card == CPU on all "
              f"{len(settled._fields)} fields; chaos kernel launches {small_launches} "
              f"at G={LOSSY_SMALL_G} and {launches} at G={G} (the main path's count); "
              f"card {t_gpu:.2f}s, CPU (G={LOSSY_SMALL_G}) {t_cpu:.2f}s (in a "
              "reference worker)")

    return full[0], launches, run, h_launches, check


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
        work=bound_work("chaos", P, G, K),
    )


# --- the damped (check-quorum) path -------------------------------------------


def damped_cfg(n_groups, n_peers=P, pre_vote=False):
    """bench.py --check-quorum's config; with `pre_vote`, pre-vote alone."""
    return sim.SimConfig(n_groups=n_groups, n_peers=n_peers, election_tick=CQ_TICK,
                         check_quorum=not pre_vote, pre_vote=pre_vote)


def damped_settle(device, n_groups, n_peers=P, pre_vote=False):
    """init_state and CQ_SETTLE damped rounds of one append per group."""
    return compiled_settle(damped_cfg(n_groups, n_peers, pre_vote), device, CQ_SETTLE)


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
    state, the difference over the wide cases alone, the settled
    100k x WIDE_P damped state)."""
    err, loss_err, settled = (0, 0), (0, 0), None
    wide_err, wide_settled = (0, 0), None
    for n_groups, n_peers in ((G, P), (G + 3, P), (G, 3), (G, WIDE_P)):
        st = damped_settle(dev, n_groups, n_peers)
        if (n_groups, n_peers) == (G, P):
            settled = st
        if n_peers == WIDE_P:
            wide_settled = st
        append = torch.ones(n_groups, dtype=torch.int32, device=dev)
        for crashed_name in ("no crashes", "crashed followers"):
            crashed = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=dev)
            if crashed_name != "no crashes":
                crashed = crash_followers(st, n_peers, n_groups, dev)
            note = f"damped-settled G={n_groups} P={n_peers} {crashed_name}"
            e = compare_damped(fused_step.damped_operands(st, crashed, append), note)
            err = worst(err, e)
            for loss_name, make_loss in (("1%", uniform_loss), ("heavy", heavy_loss)):
                args = fused_step.damped_operands(
                    st, crashed, append, make_loss(n_groups, n_peers, dev))
                for rb in (CQ_SETTLE, 2**31 - K):
                    le = compare_damped(args, f"{note} {loss_name} loss", round_base=rb)
                    loss_err, e = worst(loss_err, le), worst(e, le)
            if n_peers > _build.NARROW_PEERS:
                wide_err = worst(wide_err, e)
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
    for n_peers in (3, 5, 7) + WIDE_PEERS + DAMPED_SHAPE_PEERS + FILL_PEERS:
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
                if n_peers > _build.NARROW_PEERS:
                    wide_err = worst(wide_err, e)
    return worst(err, loss_err), loss_err, settled, wide_err, wide_settled


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
def phase_damped(dev, settled, pool, small_ref):
    """The check-quorum path on the card, bare and instrumented: at G=8,192
    from one instrumented settle, and at G=100,000 from the settled state
    (fused blocks, then crash blocks); the CPU's instrumented runs, the
    reference for both, in a reference worker (`small_ref`, the future of
    cpu_health_path for the small run).  Returns (the bare 100k state before
    the crash blocks, its damped kernel launches, the instrumented card run,
    its with_health launches, check, the 100k run's steady predicate kernel
    launches)."""
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
    pred_launches = predicate_launches(CQ_FUSED_BLOCKS + CQ_CRASH_BLOCKS,
                                       f"the check-quorum path at G={G}")
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
    _, check_small, _ = instrumented_pair(
        dev, f"check-quorum G={CQ_SMALL_G}", damped_rounds, (CQ_SMALL_BLOCKS, 0),
        small_ref, cfg=small_cfg, blocks=CQ_SMALL_BLOCKS, start=small_start)
    cfg = damped_cfg(G)
    kw = dict(cfg=cfg, blocks=CQ_FUSED_BLOCKS, crash_blocks=CQ_CRASH_BLOCKS)
    run, check_run, h_launches = instrumented_pair(
        dev, "check-quorum", damped_rounds, (CQ_FUSED_BLOCKS, CQ_CRASH_BLOCKS),
        pool.submit(cpu_health_path, kw, sim.state_to_numpy(settled)),
        start=fresh_start(settled, cfg), **kw)

    def check():
        same_as_reference(small, check_small(), f"check-quorum G={CQ_SMALL_G}")
        same_as_reference(full, check_run(), f"check-quorum G={G}")
        print(f"check-quorum path {CQ_SMALL_G}x{P} (init, {CQ_SETTLE} instrumented settle "
              f"rounds, {CQ_SMALL_BLOCKS} blocks; fused {small[1]}, general blocks "
              f"{small[2]}) and {G}x{P} (settled, {CQ_FUSED_BLOCKS} blocks, then "
              f"{CQ_CRASH_BLOCKS} with the acting leader crashed in 1% of groups, "
              f"{elected} of {len(range(0, G, 100))} of which elected a new leader; fused "
              f"{full[1]}, general blocks {full[2]}): card == CPU "
              f"on all {len(settled._fields)} fields, recent_active included; damped "
              f"kernel launches {small_launches} at G={CQ_SMALL_G} and {launches} at "
              f"G={G} (the main path's count), steady predicate launches "
              f"{pred_launches} at G={G}; card {t_gpu:.2f}s")

    return full[3], launches, run, h_launches, check, pred_launches


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
        work=bound_work("damped", P, G, K),
    )
    if t["fused_frac"] < 1.0:
        raise AssertionError(f"damped timed loop left the fused path: "
                             f"fused_frac {t['fused_frac']}")
    return t

# --- the wide instances (P = 8..15) -------------------------------------------


def wide_block_pair(cfg, st, crashed, append, link=None, loss=None, round_base=0):
    """One fused block of fast_multi_round(k=K) and K general steps on the
    same card state: (fused block's state, general steps' state, fused)."""
    fast = fused_step.fast_multi_round(cfg, k=K, with_chaos=loss is not None,
                                       count_fused=True)
    lossy = (link, loss, round_base) if loss is not None else ()
    got, fused = fast(st, crashed, append, *lossy, 0)
    want = st
    for r in range(K):
        kw = {} if loss is None else {
            "link": link & ~link_loss_draw(round_base + r, loss)}
        want = sim.step(cfg, want, crashed, append, **kw)
    return got, want, fused


@phase("wide")
def phase_wide(dev, steady_st, lossy_st, damped_st):
    """C1 on the card at P = WIDE_P, G = 100,000: from each settled state
    (steady, lossy under 1% loss, check-quorum), WIDE_BLOCKS blocks of
    fast_multi_round(k=32) with the launch counts zeroed just before and
    read just after, each block equal on every field to 32 general steps
    on the card; then each kernel's WIDE_P instance timed cold and hot on
    the settled state's operands against its bound.  Returns {kernel:
    (launches, times)}."""
    crashed = torch.zeros((WIDE_P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    link = torch.ones((WIDE_P, WIDE_P, G), dtype=torch.bool, device=dev)
    loss = uniform_loss(G, WIDE_P, dev)
    cases = (
        ("steady", steady_rounds, sim.SimConfig(n_groups=G, n_peers=WIDE_P),
         steady_st, {}),
        ("chaos", chaos_rounds, lossy_cfg(G, WIDE_P), lossy_st,
         dict(link=link, loss=loss, round_base=LOSSY_SETTLE)),
        ("damped", damped_rounds, damped_cfg(G, WIDE_P), damped_st, {}),
    )
    out = {}
    for label, kernel, cfg, st0, kw in cases:
        zero_launches()
        st, fused = st0, 0
        for b in range(WIDE_BLOCKS):
            if "round_base" in kw:
                kw = dict(kw, round_base=LOSSY_SETTLE + b * K)
            got, want, n = wide_block_pair(cfg, st, crashed, append, **kw)
            for field in got._fields:
                a, w = getattr(got, field), getattr(want, field)
                if (a is None) != (w is None) or (a is not None and not torch.equal(a, w)):
                    raise AssertionError(f"P={WIDE_P} {label} block {b}: fused and "
                                         f"general differ in {field}")
            st, fused = got, fused + n
        torch.cuda.synchronize()
        launches = bare_launches(kernel, f"the P={WIDE_P} {label} path")
        if launches < 1:
            raise AssertionError(f"P={WIDE_P} {label} path: no fused launch "
                                 f"(fused {fused}/{WIDE_BLOCKS * K * G})")
        print(f"wide P={WIDE_P} {label}: {WIDE_BLOCKS} blocks of {K} == {K} general "
              f"steps each on every field; {label}_rounds launches {launches}, "
              f"fused {fused}/{WIDE_BLOCKS * K * G}")
        ticks = dict(rounds=K, election_tick=cfg.election_tick,
                     heartbeat_tick=cfg.heartbeat_tick)
        if label == "steady":
            args, ref = fused_step.steady_operands(st0, crashed, append), steady_rounds_reference
            work = steady_work(WIDE_P, G, K)
        elif label == "chaos":
            args, ref = fused_step.chaos_operands(st0, crashed, append, loss), chaos_rounds_reference
            ticks["round_base"] = LOSSY_SETTLE
            work = bound_work("chaos", WIDE_P, G, K)
        else:
            args, ref = fused_step.damped_operands(st0, crashed, append), damped_rounds_reference
            ticks.update(round_base=0, with_cq=True)
            work = bound_work("damped", WIDE_P, G, K)
        t = kernel_times(dev, kernel, ref, args, ticks, work)
        print(f"timing {label}_rounds P={WIDE_P}: {t['ms']:.4f} ms cold, "
              f"{t['hot_ms']:.4f} hot, bound {t['bound_ms']:.4f} by {t['bound_by']}, "
              f"plain {t['plain_ms']:.2f}{plain_bound_note(t)}; {t['card']}")
        out[label] = (launches, t)
    return out


@phase("wide steady")
def phase_warp(dev):
    """The steady path at P = WARP_P, G = 100,000 on the warp instance: a
    settle of SETTLE rounds through ClusterSim.run_compiled, then
    WIDE_BLOCKS blocks of fast_multi_round(k=32) with the launch counts
    zeroed just before and read just after, each block equal on every
    field to 32 general steps on the card; the warp instance against its
    plain version on the settled state's operands (k = WARP_WIDE_K, both
    variants); then timed cold and hot at k = 32 on those operands against
    both bounds: steady_wide_body_work's (the body's operations, with the
    selections these operands take) and steady_work's (the reference's
    network), with the plain version's time beside.  Returns (launches,
    (plain, with_health) max |difference|, times)."""
    cfg = sim.SimConfig(n_groups=G, n_peers=WARP_P)
    crashed = torch.zeros((WARP_P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    st0 = compiled_settle(cfg, dev, SETTLE)
    sync()
    settle_s = time.perf_counter() - t0
    zero_launches()
    st, fused = st0, 0
    for b in range(WIDE_BLOCKS):
        got, want, n = wide_block_pair(cfg, st, crashed, append)
        for field in got._fields:
            a, w = getattr(got, field), getattr(want, field)
            if (a is None) != (w is None) or (a is not None and not torch.equal(a, w)):
                raise AssertionError(f"P={WARP_P} steady block {b}: fused and general "
                                     f"differ in {field}")
        st, fused = got, fused + n
    sync()
    launches = bare_launches(steady_rounds, f"the P={WARP_P} steady path")
    if launches < 1:
        raise AssertionError(f"P={WARP_P} steady path: no fused launch "
                             f"(fused {fused}/{WIDE_BLOCKS * K * G})")
    print(f"wide P={WARP_P} steady: settled in {settle_s:.2f}s ({SETTLE} compiled "
          f"rounds); {WIDE_BLOCKS} blocks of {K} == {K} general steps each on every "
          f"field; steady_rounds launches {launches}, fused {fused}/{WIDE_BLOCKS * K * G}")
    args = fused_step.steady_operands(st0, crashed, append)
    err = compare_kernel(args, WARP_WIDE_K, f"settled G={G} P={WARP_P} k={WARP_WIDE_K}")
    sel = steady_kernel.warp_selections(*(args[i] for i in (0, 8, 9, 10, 6)))
    kw = dict(rounds=K, election_tick=cfg.election_tick, heartbeat_tick=cfg.heartbeat_tick)
    work = steady_wide_body_work(WARP_P, G, K, selections=sel) + (
        steady_work(WARP_P, G, K),)
    t = kernel_times(dev, steady_rounds, steady_rounds_reference, args, kw, work)
    t["selections"] = sel
    print(f"timing steady_rounds P={WARP_P} (the warp instance): {t['ms']:.4f} ms cold, "
          f"{t['hot_ms']:.4f} hot, bound {t['bound_ms']:.4f} by {t['bound_by']} "
          f"(steady_wide_body_work, {sel[0]} selections of {sel[1]} radix steps; "
          f"{100 * t['bound_ms'] / t['ms']:.1f} % of it), plain {t['plain_ms']:.2f}"
          f"{plain_bound_note(t)}; {t['card']}")
    return launches, err, t


# --- the instrumented paths (bench.py --health) -----------------------------


def zero_launches():
    for fn in KERNELS:
        fn.launches = fn.health_launches = 0
    predicate_kernel.steady_invariant.launches = 0


def predicate_launches(blocks, note):
    """The path just run launched the steady predicate kernel once a
    fast_multi_round block (its `blocks`); returns that count."""
    n = predicate_kernel.steady_invariant.launches
    if n != blocks:
        raise AssertionError(f"{note}: {n} steady predicate launches over {blocks} blocks")
    return n


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


def host_run(run):
    """A run_health_path dict with host arrays in place of its tensors, to
    cross the process boundary."""
    def health(h):
        return h.planes.cpu().numpy(), h.window_pos

    return dict(run, state=sim.state_to_numpy(run["state"]), health=health(run["health"]),
                mid=(sim.state_to_numpy(run["mid"][0]), health(run["mid"][1])))


def cpu_run(host):
    """host_run's inverse, on the CPU."""
    def health(h):
        return sim.HealthState(torch.from_numpy(h[0]), h[1])

    return dict(host, state=sim.state_from_numpy(host["state"], "cpu"),
                health=health(host["health"]),
                mid=(sim.state_from_numpy(host["mid"][0], "cpu"), health(host["mid"][1])))


def cpu_health_path(kw, start=None):
    """In a reference worker: run_health_path(**kw) on the CPU, from the
    arrays of a settled state (`start`, with fresh counters and health) when
    given; (host_run of it, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    if start is not None:
        kw = dict(kw, start=fresh_start(sim.state_from_numpy(start, "cpu"), kw["cfg"]))
    return host_run(run_health_path("cpu", **kw)), time.perf_counter() - t0


def instrumented_pair(dev, name, kernel, expect, cpu_ref, **kw):
    """A path run instrumented (run_health_path's `kw`) on the card, its
    launch counts zeroed just before it and read just after, its (fused,
    general) block counts `expect`.  `cpu_ref` is a reference worker's future
    of cpu_health_path for the same schedule.  Returns (card run, check,
    with_health launches): check() holds the card run to the CPU run (every
    field, the four health planes, window_pos, the counters, the summary and
    the block counts), prints the end-of-run summary as bench.py
    --health-out writes it, and returns the CPU run."""
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
    fused_blocks, general_blocks = expect
    if (got["fused"], got["general"]) != (fused_blocks * K * n_groups, general_blocks):
        raise AssertionError(f"{name} --health: fused {got['fused']}, general blocks "
                             f"{got['general']}")

    def check():
        host, t_cpu = cpu_ref.result()
        want = cpu_run(host)
        assert_same_health(got, want, f"{name} --health")
        origin = "settled" if "start" in kw else f"{kw['settle']} instrumented settle rounds"
        print(f"health path {name} ({n_groups}x{P}, {origin}, "
              f"{fused_blocks + general_blocks} blocks of {K}, general {got['general']}): "
              f"card == CPU on every field, the four health planes, window_pos "
              f"(={got['health'].window_pos}), the counters {got['counters']}, the "
              f"summary and the fused count ({got['fused']}); launches by variant "
              f"{counts}; card {t_gpu:.2f}s, CPU {t_cpu:.2f}s (in a reference worker)")
        print(f"  end-of-run health summary: {json.dumps(got['summary'])}")
        return want

    return got, check, counts[kernel.__name__][1]


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
        work=bound_work("damped", P, G, K, with_health=True))
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
                     bound_work("chaos", P, G, K, with_health=True))
    print(f"timing {label} {G}x{P} k={K} [{t['card']}]: chaos_round_kernel "
          f"{t['ms']:.4f} ms cold ({t['hot_ms']:.4f} ms hot; a wrapper call "
          f"{t['call_ms']:.4f} ms), plain version {t['plain_ms']:.3f} ms; bound "
          f"{t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f}){plain_bound_note(t)}")
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
    """CPU threads for a reference worker: its share of all but two, which
    drive the card meanwhile."""
    torch.set_num_threads(max(1, (torch.get_num_threads() - 2) // WORKERS))


def cpu_scenarios():
    """In a reference worker: the plan on the CPU at CHAOS_SMALL_G with
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
              f"G={CHAOS_SMALL_G} (in a reference worker)")
        print(f"  report at G={G}: {json.dumps(full[0])}")
        print(f"  report at G={CHAOS_SMALL_G}: {json.dumps(cpu[0])}")
        return t_cpu

    return small, full, check


def scenario_timing(dev, check_quorum, first_s, line):
    """bench_chaos: G x rounds / wall of the whole plan from a fresh state,
    the median of the parity run's run_plan (`first_s` seconds; the host
    loop compiles nothing, so it needs no warm-up) and the bench line's
    reps (`line`, bench --chaos [--check-quorum], the same runner);
    fused_frac 0; and the device's busy share over the first
    CHAOS_PROFILE_ROUNDS rounds."""
    cfg = chaos_cfg(G, check_quorum)
    compiled = chaos.compile_plan(chaos.load_plan(CHAOS_PLAN), G, dev)
    samples = [G * compiled.n_rounds / first_s] + bench_samples(line)
    head = chaos.make_runner(cfg, compiled._replace(
        phase_of_round=compiled.phase_of_round[:CHAOS_PROFILE_ROUNDS]))
    st, health = sim.init_state(cfg, device=dev), sim.init_health(cfg, dev)
    prof = device_profile(lambda: head(st, health))
    med = statistics.median(samples)
    name = "check_quorum" if check_quorum else "undamped"
    print(f"timing chaos scenario {name} {G}x{P} [{card_line()}]: ticks/s median "
          f"{med:.1f} (min {min(samples):.1f}, max {max(samples):.1f}, the parity run "
          f"and {line['reps']} bench reps), fused_frac 0; a round "
          f"{1e3 * G / med:.2f} ms; profile of rounds "
          f"0-{CHAOS_PROFILE_ROUNDS - 1}: device busy {prof['busy_us']:.1f} of "
          f"{prof['wall_us']:.1f} us ({100 * prof['busy_share']:.1f}%), "
          f"{sum(r['count'] for r in prof['kernels'])} kernel launches")
    for row in prof["kernels"][:6]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return dict(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=0.0,
                profile=prof, card=card_line())


@phase("chaos scenario")
def phase_chaos_scenario(dev, cpu_runs, lines):
    """bench.py --chaos examples/chaos/partition_heal.json [--check-quorum]
    at G on the card and timed (with the bench phase's `lines`), then held
    to the CPU runs (`cpu_runs`, the reference worker's future of
    cpu_scenarios())."""
    card = {}
    for check_quorum in (False, True):
        _, full, check = scenario_parity(dev, check_quorum)
        line = lines["chaos_cq" if check_quorum else "chaos"]["line"]
        card[check_quorum] = (check, full,
                              scenario_timing(dev, check_quorum, full[3], line))
    cpu = cpu_runs.result()
    out = {}
    for check_quorum, (check, full, timing) in card.items():
        t_cpu = check(cpu[check_quorum])
        out["check_quorum" if check_quorum else "undamped"] = dict(
            report=full[0], card_s=full[3], cpu_s=t_cpu, **timing)
    # The undamped G run, the black box's pure-observer baseline.
    return out, card[False][1]


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
    """In a reference worker: run_composed on the CPU from the settled
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
    then held to the CPU run (`cpu_run`, a reference worker's future of
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
          f"{t_gpu:.2f}s, CPU {t_cpu:.2f}s (in a reference worker)")
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
def phase_composed_timing(dev, settled, line):
    """bench.py --lossy 0.01 --check-quorum: ticks/s and the measured
    fused_frac from the bench phase's line (`line`: its settle and SCANS
    scans a rep); from the settled state as it is (the natural boundary
    phases), the block's parts, the busy share of the general rounds every
    such block runs, and the damped kernel's with_loss instance against its
    bound."""
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
        work=bound_work("damped", P, G, K, with_loss=True), reps=line["reps"], scans=SCANS,
        part_reps=1, profile=(f"{CHAOS_PROFILE_ROUNDS} of the slow branch's general "
                              "rounds", general_rounds), line=line,
    )


# --- membership change (bench.py --reconfig and --prod-fused) ----------------


def plan_docs(path):
    """(reconfig plan, chaos plan or None) of a bench.py plan file."""
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    chaos_doc = doc.get("chaos")
    return (reconfig.plan_from_dict(doc.get("reconfig", doc)),
            None if chaos_doc is None else chaos.plan_from_dict(chaos_doc))


def reconfig_cfg(n_groups, check_quorum):
    """bench.py --reconfig's config: the plan's peers, health planes on."""
    return sim.SimConfig(n_groups=n_groups, n_peers=P, collect_health=True,
                         check_quorum=check_quorum)


def run_reconfig_plan(device, n_groups, check_quorum, split=False):
    """ClusterSim.run_reconfig of the plan from its bootstrap masks: (report,
    final state, final health, run_reconfig's wall seconds, which end with
    the report's download, and with `split` the rejected blocks' first
    rounds)."""
    plan, _ = plan_docs(RECONFIG_PLAN)
    s = sim.ClusterSim(reconfig_cfg(n_groups, check_quorum),
                       *reconfig.initial_masks(plan, n_groups, device), device=device)
    sync()
    t0 = time.perf_counter()
    report = s.run_reconfig(plan, split=split, split_k=PROD_K, split_window=PROD_WINDOW)
    secs = time.perf_counter() - t0
    return report, s.state, s._health, secs, (
        rejected(s._reconfig_runner[3]) if split else None)


def rejected(runner):
    """The first rounds of a split runner's planned blocks that its last call
    ran on the general step."""
    return [r0 for r0, ran in runner.blocks if not ran]


def cpu_reconfig():
    """In a reference worker: the plan on the CPU at RECONFIG_SMALL_G with
    check_quorum off and on, as cpu_scenarios' entries."""
    worker_threads()
    out = {}
    for check_quorum in (False, True):
        report, st, health, secs, _ = run_reconfig_plan("cpu", RECONFIG_SMALL_G,
                                                     check_quorum)
        out[check_quorum] = (report, sim.state_to_numpy(st), health.planes.numpy(),
                             health.window_pos, secs)
    return out


def same_run(a, b, note):
    """Two runs on one device (run_reconfig_plan's tuples): every state field,
    the health planes and window_pos equal."""
    for f in sim.SimState._fields:
        x, y = getattr(a[1], f), getattr(b[1], f)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{note}: {f} differs")
    if a[2].window_pos != b[2].window_pos or not torch.equal(a[2].planes, b[2].planes):
        raise AssertionError(f"{note}: health planes or window_pos differ")


def unfused(report):
    return {k: v for k, v in report.items()
            if k not in ("fused_rounds", "total_rounds", "fused_frac")}


def reconfig_parity(dev, check_quorum):
    """The plan on the card at RECONFIG_SMALL_G, then unsplit at G with its
    launch counts zeroed just before and read just after (no fused kernel may
    launch) and zero safety counts, then split (k=8) at G, which must end
    equal to it.  Returns (the G run, the split run's fused kernel launches,
    its report, check(cpu)), check as scenario_parity's."""
    name = "check_quorum" if check_quorum else "undamped"
    small = run_reconfig_plan(dev, RECONFIG_SMALL_G, check_quorum)
    zero_launches()
    full = run_reconfig_plan(dev, G, check_quorum)
    counts = launch_counts()
    if any(a or b for a, b in counts.values()):
        raise AssertionError(f"reconfig {name}: a fused kernel launched: {counts}")
    if any(full[0]["safety"].values()):
        raise AssertionError(f"reconfig {name} G={G}: safety violations "
                             f"{full[0]['safety']}")
    check_state(full[1])
    zero_launches()
    split = run_reconfig_plan(dev, G, check_quorum, split=True)
    counts = launch_counts()
    kernel = damped_rounds if check_quorum else steady_rounds
    for kname, (plain, health) in counts.items():
        if plain or (health and kname != kernel.__name__):
            raise AssertionError(f"reconfig {name} split: unexpected launches {counts}")
    fused_launches = counts[kernel.__name__][1]
    if unfused(split[0]) != full[0] or split[0]["fused_rounds"] != fused_launches * PROD_K * G:
        raise AssertionError(f"reconfig {name}: split report {split[0]} != {full[0]}")
    same_run(full, split, f"reconfig {name} G={G}: split against unsplit")

    def check(cpu_entry):
        report, arrays, planes, window_pos, t_cpu = cpu_entry
        cpu = (report, sim.state_from_numpy(arrays, "cpu"),
               sim.HealthState(torch.from_numpy(planes), window_pos))
        if small[0] != cpu[0]:
            raise AssertionError(f"reconfig {name} G={RECONFIG_SMALL_G}: reports "
                                 f"differ: card {small[0]}, CPU {cpu[0]}")
        same_scenario(small, cpu, f"reconfig {name} G={RECONFIG_SMALL_G}")
        same_scenario(full, cpu, f"reconfig {name}: the first {RECONFIG_SMALL_G} of "
                      f"{G} groups", RECONFIG_SMALL_G)
        print(f"reconfig {name} ({RECONFIG_PLAN_NAME}, {full[0]['rounds']} rounds): "
              f"card == CPU at {RECONFIG_SMALL_G}x{P} (report, every field, the "
              f"health planes); at {G}x{P} safety all 0, the first "
              f"{RECONFIG_SMALL_G} groups == the CPU run, split=True (k={PROD_K}) == "
              f"unsplit with fused_frac {split[0]['fused_frac']} ({kernel.__name__} "
              f"with_health launches {fused_launches}; planned blocks rejected at "
              f"rounds {split[4]}); card {full[3]:.2f}s unsplit, "
              f"{split[3]:.2f}s split at G={G}, CPU {t_cpu:.2f}s at "
              f"G={RECONFIG_SMALL_G} (in a reference worker)")
        print(f"  report at G={G}: {json.dumps(full[0])}")
        return t_cpu

    return full, fused_launches, split[0], check


def reconfig_timing(dev, check_quorum, first_s, line):
    """bench_reconfig: G x rounds / wall of the whole plan from the bootstrap
    state (make_runner, unsplit: fused_frac 0), the median of the parity
    run's run_reconfig (`first_s`) and the bench line's reps (`line`, bench
    --reconfig [--check-quorum]); and the device's busy share over the
    first CHAOS_PROFILE_ROUNDS rounds."""
    cfg = reconfig_cfg(G, check_quorum)
    plan, _ = plan_docs(RECONFIG_PLAN)
    compiled = reconfig.compile_plan(plan, G, dev)

    def fresh():
        st = sim.init_state(cfg, *reconfig.initial_masks(plan, G, dev), device=dev)
        return st, sim.init_health(cfg, dev), reconfig.init_reconfig_state(st)

    samples = [G * compiled.n_rounds / first_s] + bench_samples(line)
    head = reconfig.make_runner(cfg, compiled._replace(
        phase_of_round=compiled.phase_of_round[:CHAOS_PROFILE_ROUNDS]))
    carry = fresh()
    prof = device_profile(lambda: head(*carry))
    med = statistics.median(samples)
    name = "check_quorum" if check_quorum else "undamped"
    print(f"timing reconfig {name} {G}x{P} [{card_line()}]: ticks/s median "
          f"{med:.1f} (min {min(samples):.1f}, max {max(samples):.1f}, "
          f"the parity run and {line['reps']} bench reps), fused_frac 0; a round "
          f"{1e3 * G / med:.2f} ms; "
          f"profile of rounds 0-{CHAOS_PROFILE_ROUNDS - 1}: device busy "
          f"{prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%), "
          f"{sum(r['count'] for r in prof['kernels'])} kernel launches")
    for row in prof["kernels"][:6]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return dict(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=0.0,
                profile=prof, card=card_line())


@phase("reconfig")
def phase_reconfig(dev, cpu_runs, lines):
    """bench.py --reconfig examples/reconfig/joint_churn.json [--check-quorum]
    at G on the card, split and unsplit, and timed (with the bench phase's
    `lines`), then held to the CPU runs (`cpu_runs`, a reference worker's
    future of cpu_reconfig())."""
    card = {}
    for check_quorum in (False, True):
        full, launches, split, check = reconfig_parity(dev, check_quorum)
        line = lines["reconfig_cq" if check_quorum else "reconfig"]["line"]
        card[check_quorum] = (check, full, launches, split,
                              reconfig_timing(dev, check_quorum, full[3], line))
    cpu = cpu_runs.result()
    out = {}
    for check_quorum, (check, full, launches, split, timing) in card.items():
        t_cpu = check(cpu[check_quorum])
        out["check_quorum" if check_quorum else "undamped"] = dict(
            report=full[0], card_s=full[3], cpu_s=t_cpu, split_report=split,
            split_launches=launches, **timing)
    return out


def prod_cfg(n_groups):
    """bench_prod_fused's config: election_tick 64, health, counters,
    check-quorum and pre-vote."""
    return sim.SimConfig(n_groups=n_groups, n_peers=P, election_tick=PROD_TICK,
                         collect_health=True, collect_counters=True,
                         check_quorum=True, pre_vote=True)


def prod_settle(device, n_groups):
    """bench_prod_fused's settle: init_state from the plan's bootstrap masks,
    then PROD_SETTLE general rounds of one append a group (no extras)."""
    plan, _ = plan_docs(PROD_PLAN)
    return compiled_settle(prod_cfg(n_groups), device, PROD_SETTLE,
                           masks=reconfig.initial_masks(plan, n_groups, device))


def prod_runner(start, rounds=None):
    """make_split_runner(k=8, window=4, with_counters=True) over the plan and
    its chaos overlay at the state's width and device (the first `rounds`
    rounds of both when given), and a fn() running it from `start` with fresh
    health, op-protocol state and counters (nothing is updated in place, so
    every run starts from the same settled state)."""
    plan, chaos_plan = plan_docs(PROD_PLAN)
    n_groups, dev = start.term.shape[1], start.term.device
    cfg = prod_cfg(n_groups)
    compiled = reconfig.compile_plan(plan, n_groups, dev)
    cc = chaos.compile_plan(chaos_plan, n_groups, dev)
    if rounds is not None:
        compiled = compiled._replace(phase_of_round=compiled.phase_of_round[:rounds])
        cc = cc._replace(phase_of_round=cc.phase_of_round[:rounds])
    runner = reconfig.make_split_runner(cfg, compiled, cc, k=PROD_K,
                                        window=PROD_WINDOW, with_counters=True)

    def run():
        return runner(start, sim.init_health(cfg, dev),
                      reconfig.init_reconfig_state(start), pk.zero_counters(dev))

    return runner, run


def prod_result(out, runner):
    """A split run's outputs as host values: (state arrays, health planes,
    window_pos, op-protocol arrays, stats, rstats, safety, fused, counters,
    the rejected blocks' first rounds)."""
    st, hl, rst, stats, rstats, safety, fused, ctrs = out
    return (sim.state_to_numpy(st), hl.planes.cpu().numpy(), hl.window_pos,
            {f: v.cpu().numpy() for f, v in rst._asdict().items()},
            stats.tolist(), rstats.tolist(), safety.tolist(), fused, ctrs.tolist(),
            rejected(runner))


def cpu_prod():
    """In a reference worker: the settle and the split run on the CPU at
    RECONFIG_SMALL_G: (prod_result, segments, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    runner, run = prod_runner(prod_settle("cpu", RECONFIG_SMALL_G))
    return prod_result(run(), runner), runner.segments, time.perf_counter() - t0


def same_prod(a, b, note, n_groups=None):
    """Two prod_result tuples: every state field, the health planes and
    window_pos (the first n_groups groups of a, default all); with n_groups
    None also the op-protocol state, the accumulators, the fused count, the
    counters and the rejected blocks."""
    n = n_groups
    cut = (lambda v: v) if n is None else (lambda v: v[..., :n])
    for f in sim.SimState._fields:
        x, y = a[0].get(f), b[0].get(f)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(cut(x), y)):
            raise AssertionError(f"{note}: state field {f} differs")
    if not np.array_equal(cut(a[1]), b[1]) or a[2] != b[2]:
        raise AssertionError(f"{note}: health planes or window_pos differ")
    if n is not None:
        return
    for f in a[3]:
        if not np.array_equal(a[3][f], b[3][f]):
            raise AssertionError(f"{note}: op-protocol field {f} differs")
    if a[4:] != b[4:]:
        raise AssertionError(f"{note}: accumulators, fused count, counters or "
                             f"rejected blocks differ: {a[4:]} != {b[4:]}")


@phase("prod-fused")
def phase_prod_fused(dev, cpu_run, line):
    """bench.py --prod-fused examples/reconfig/prod_fused.json: the settle at
    G on the card, the split runner from its first RECONFIG_SMALL_G groups,
    then at G with the launch counts zeroed just before the run and read
    just after, held to the CPU run (`cpu_run`, a reference worker's future of cpu_prod()):
    every field, the op-protocol state, the accumulators, the counters, the
    fused count and the segments at RECONFIG_SMALL_G, and the G run's first
    RECONFIG_SMALL_G groups; zero safety counts.  Then the damped kernel's
    with_loss with_health instance at k=8 against its plain version on a
    lossy block's operands, the timing (the parity run and the bench line's
    reps, `line`, each from the settled state, fused_frac as measured), the
    busy share of the plan's first 4 rounds, and the kernel against its
    bound.  Returns (launches, parity
    error, timing)."""
    t0 = time.perf_counter()
    settled = prod_settle(dev, G)
    sync()
    t_settle = time.perf_counter() - t0
    # The small run starts from the G settle's first groups (every seeded
    # stream keys on the global group id), the CPU from its own settle.
    runner_s, run_s = prod_runner(sim.SimState(*(
        None if v is None else v[..., :RECONFIG_SMALL_G].contiguous() for v in settled)))
    small = prod_result(run_s(), runner_s)
    runner, run = prod_runner(settled)
    zero_launches()
    t0 = time.perf_counter()
    out = run()
    sync()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["damped_rounds"][1]
    if launches < 1 or any(counts[k.__name__] != (0, 0) for k in (steady_rounds, chaos_rounds)) \
            or counts["damped_rounds"][0]:
        raise AssertionError(f"prod-fused: unexpected launches {counts}")
    if out[6] != launches * PROD_K * G:
        raise AssertionError(f"prod-fused: fused {out[6]} for {launches} launches")
    if any(out[5].tolist()):
        raise AssertionError(f"prod-fused G={G}: safety violations {out[5].tolist()}")
    check_state(out[0])
    full = prod_result(out, runner)
    cpu, segments, t_cpu = cpu_run.result()
    same_prod(small, cpu, f"prod-fused G={RECONFIG_SMALL_G}")
    if runner_s.segments != segments or runner.segments != segments:
        raise AssertionError(f"prod-fused: segments differ {runner.segments} {segments}")
    same_prod(full, cpu, f"prod-fused: the first {RECONFIG_SMALL_G} of {G} groups",
              RECONFIG_SMALL_G)
    rounds = sum(sg.rounds for sg in segments)
    total = G * rounds
    print(f"prod-fused {G}x{P} ({PROD_PLAN_NAME}, {rounds} rounds after a "
          f"{PROD_SETTLE}-round settle, k={PROD_K}, window {PROD_WINDOW}): card == CPU "
          f"at {RECONFIG_SMALL_G}x{P} (every field, the op-protocol state, stats "
          f"{small[4]}, rstats {small[5]}, counters {small[8]}, fused {small[7]}, "
          f"{len(segments)} segments, {len(runner.blocks)} planned blocks, rejected at "
          f"rounds {small[9]}); at {G}x{P} safety all 0, the first "
          f"{RECONFIG_SMALL_G} groups == the CPU run; fused_frac "
          f"{out[6] / total:.4f} ({out[6]} of {total}); damped kernel (with_loss, "
          f"with_health) launches {launches}; card {t_settle:.2f}s settle + "
          f"{first_s:.2f}s run, CPU {t_cpu:.2f}s (in a reference worker)")
    print(f"  rstats at G={G} {full[5]}, stats {full[4]}, counters {full[8]}, planned "
          f"blocks rejected at rounds {full[9]}")
    # The kernel against its plain version on the lossy phase's operands.
    plan, chaos_plan = plan_docs(PROD_PLAN)
    cc = chaos.compile_plan(chaos_plan, G, dev)
    lossy_r0 = int(torch.nonzero(cc.phase_of_round == 1)[0])
    _, loss, crashed, _ = chaos.schedule_planes(cc, lossy_r0)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    kw = dict(round_base=lossy_r0, rounds=PROD_K, election_tick=PROD_TICK,
              heartbeat_tick=1, with_cq=True)
    err = 0
    for st, tsc, note in ((settled, random_tsc(G, 6, dev), "settled"),
                          (out[0], out[1].planes[pk.HP_SINCE_COMMIT], "after the plan")):
        err = max(err, compare(damped_rounds, damped_rounds_reference, DAMPED_OUTPUTS,
                               fused_step.damped_operands(st, crashed, append, loss),
                               kw, f"prod-fused {note}", tsc))
    print(f"parity prod-fused damped with_loss with_health k={PROD_K}: exact on the "
          f"settled state and the plan's end state at G={G}, round base {lossy_r0}, "
          "2% loss on every directed link")
    samples = [total / first_s] + bench_samples(line)
    fused_frac = (out[6] + line["fused_rounds"]) / (total * (1 + line["reps"]))
    _, head = prod_runner(settled, PROD_PROFILE_ROUNDS)
    prof = device_profile(head)
    args = fused_step.damped_operands(settled, crashed, append, loss,
                                      random_tsc(G, 6, dev))
    t = kernel_times(dev, damped_rounds, damped_rounds_reference, args, kw,
                     bound_work("damped", P, G, PROD_K, with_loss=True, with_health=True))
    med = statistics.median(samples)
    t.update(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=fused_frac,
             profile=prof, segments=[list(sg) for sg in segments])
    print(f"timing prod-fused {G}x{P} k={PROD_K} [{t['card']}]: ticks/s median "
          f"{med:.1f} (min {min(samples):.1f}, max {max(samples):.1f}, the parity run "
          f"and {line['reps']} bench reps from the settled state), fused_frac "
          f"{fused_frac:.4f}; damped_round_kernel "
          f"(with_loss, with_health) {t['ms']:.4f} ms cold ({t['hot_ms']:.4f} ms hot; "
          f"a wrapper call {t['call_ms']:.4f} ms), plain version {t['plain_ms']:.3f} ms; "
          f"bound {t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f}){plain_bound_note(t)}")
    print(f"profile of the plan's first {PROD_PROFILE_ROUNDS} rounds: device busy "
          f"{prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%), "
          f"{sum(r['count'] for r in prof['kernels'])} kernel launches")
    for row in prof["kernels"][:8]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return launches, err, t


# --- client reads (bench.py --reads) ------------------------------------------


def reads_cfg(n_groups):
    """bench_reads' config: election_tick 64, health, check-quorum, pre-vote
    and lease reads."""
    return sim.SimConfig(n_groups=n_groups, n_peers=P, election_tick=READS_TICK,
                         collect_health=True, check_quorum=True, pre_vote=True,
                         lease_read=True)


def reads_settle(device, n_groups):
    """bench_reads' settle: init_state, then READS_SETTLE steps of one append
    a group (no extras)."""
    return compiled_settle(reads_cfg(n_groups), device, READS_SETTLE)


def sliced_schedule(plan, n_groups, n, device):
    """The plan's schedule compiled for n_groups groups, cut to its first n
    columns and packed again.  The Zipf draws depend on the width, so this
    is not compile_plan(plan, n): it is what the first n groups of an
    n_groups-wide run see."""
    host = workload.HostClientSchedule(plan, n_groups)

    def cut(a):
        return torch.from_numpy(np.ascontiguousarray(a[..., :n])).to(device)

    return workload.CompiledClient(
        phase_of_round=torch.from_numpy(host.phase_of_round),
        read_fire_packed=pk.pack_bits_g(cut(host.read_fire)),
        read_mode=cut(host.read_mode), append=cut(host.append), n_peers=host.n_peers)


def reads_run(start, compiled, split=True):
    """make_split_runner(k=8) (make_runner without `split`) over `compiled`
    at the state's width and device, and a fn() running it from `start` with
    fresh health, op-protocol state and read carry."""
    n_groups, dev = start.term.shape[1], start.term.device
    cfg = reads_cfg(n_groups)
    runner = (workload.make_split_runner(cfg, compiled, k=READS_K) if split
              else workload.make_runner(cfg, compiled))

    def run():
        return runner(start, sim.init_health(cfg, dev), reconfig.init_reconfig_state(start),
                      workload.init_read_carry(n_groups, dev))

    return runner, run


def reads_result(out):
    """A workload run's outputs as host values: the state arrays, the health
    planes and window_pos, the read carry, the chaos, reconfig and read
    stats, the safety counts, the latency histogram, its p50/p90/p99 (as
    latency_percentiles reduces it on the device) and the fused count (None
    for make_runner)."""
    st, hl, _, stats, rstats, safety, rcar, rdstats, lat = out[:9]
    return dict(
        state=sim.state_to_numpy(st), planes=hl.planes.cpu().numpy(),
        window_pos=hl.window_pos,
        carry={f: v.cpu().numpy() for f, v in rcar._asdict().items()},
        stats=stats.tolist(), rstats=rstats.tolist(), safety=safety.tolist(),
        read_stats=rdstats.tolist(), lat_hist=lat.tolist(),
        percentiles=workload.latency_percentiles(lat).tolist(),
        fused=out[9] if len(out) > 9 else None)


def same_reads(a, b, note, n=None, fused=True):
    """Two reads_result dicts: every state field, the health planes,
    window_pos and the read carry (of a's first n groups when n is given);
    without n also every accumulator, the percentiles and (with `fused`) the
    fused count."""
    cut = (lambda v: v) if n is None else (lambda v: v[..., :n])
    for f in sim.SimState._fields:
        x, y = a["state"].get(f), b["state"].get(f)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(cut(x), y)):
            raise AssertionError(f"{note}: state field {f} differs")
    if not np.array_equal(cut(a["planes"]), b["planes"]) or a["window_pos"] != b["window_pos"]:
        raise AssertionError(f"{note}: health planes or window_pos differ")
    for f, v in a["carry"].items():
        if not np.array_equal(cut(v), b["carry"][f]):
            raise AssertionError(f"{note}: read carry {f} differs")
    if n is not None:
        return
    keys = ["stats", "rstats", "safety", "read_stats", "lat_hist", "percentiles"]
    for key in keys + (["fused"] if fused else []):
        if a[key] != b[key]:
            raise AssertionError(f"{note}: {key} differ: {a[key]} != {b[key]}")


def stale_read_trap(device, paused):
    """tests/test_read_lease.py's stale-read trap through the port: a settled
    2-group check-quorum lease fleet (P=3), each leader cut off from its
    followers for 3 election ticks, its clock held at 0 with `paused` (the
    clock drift LeaseBased cannot survive), and one lease read forced on the
    last round; the linearizability slots audited every round on the
    round-entry lease holders.  Returns (safety counts, the receipts of
    every round as lists, the final state's arrays)."""
    n_groups, n_peers = 2, 3
    cfg = sim.SimConfig(n_groups=n_groups, n_peers=n_peers, election_tick=10,
                        check_quorum=True, lease_read=True)
    st = sim.init_state(cfg, device=device)
    app = torch.ones(n_groups, dtype=torch.int32, device=device)
    none = torch.zeros((n_peers, n_groups), dtype=torch.bool, device=device)
    for _ in range(30):
        st = sim.step(cfg, st, none, app)
    leads = st.state.argmax(0)
    cut = torch.arange(n_peers, device=device)[:, None] == leads[None, :]
    # Every link between the leader and the rest down, both ways.
    link = ~(cut[:, None, :] ^ cut[None, :, :])
    safety = torch.zeros(pk.N_SAFETY, dtype=torch.int32, device=device)
    receipts = []
    for r in range(3 * cfg.election_tick):
        if paused:
            st = st._replace(election_elapsed=torch.where(
                cut & (st.state == ROLE_LEADER), 0, st.election_elapsed))
        fire = r == 3 * cfg.election_tick - 1
        modes = torch.full((n_groups,), sim.READ_LEASE if fire else 0, dtype=torch.int32,
                           device=device)
        holder, _, _ = pk.lease_read(
            st.state, st.term, st.leader_id, st.election_elapsed, st.commit,
            st.term_start_index, none, cfg.election_tick, True, st.transferee,
            st.recent_active, st.voter_mask, st.outgoing_mask)
        st2, receipt = sim.step(cfg, st, none, app, link=link, read_propose=modes)
        safety = safety + pk.check_safety(
            st2.state, st2.term, st2.commit, st2.last_index, st2.agree, st.commit,
            lease_holder=holder, lease_fire=modes > 0)
        receipts.append([v.tolist() for v in receipt])
        st = st2
    return safety.tolist(), receipts, sim.state_to_numpy(st)


def cpu_reads():
    """In a reference worker: bench.py --reads' procedure on the CPU at
    READS_SMALL_G (its own settle and the plan compiled at that width), the
    split run over the G-wide schedule's first READS_SMALL_G columns from the
    same settled state, and the stale-read trap with the clock paused and
    not: (small result, sliced result, {paused: trap}, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    plan = workload.load_plan(READS_PLAN)
    start = reads_settle("cpu", READS_SMALL_G)
    _, run = reads_run(start, workload.compile_plan(plan, READS_SMALL_G, "cpu"))
    small = reads_result(run())
    _, run = reads_run(start, sliced_schedule(plan, G, READS_SMALL_G, "cpu"))
    sliced = reads_result(run())
    traps = {paused: stale_read_trap("cpu", paused) for paused in (True, False)}
    return small, sliced, traps, time.perf_counter() - t0


@phase("reads")
def phase_reads(dev, cpu_ref, line):
    """bench.py --reads examples/reads/zipf_mixed.json: the 192-round settle
    at G on the card; the split runner (k=8) at READS_SMALL_G from the
    settle's first groups with the plan compiled at that width, then at G
    with the launch counts zeroed just before the run and read just after;
    make_runner at G, which must equal it; the stale-read trap on the card;
    all held to the CPU runs (`cpu_ref`, a reference worker's future of
    cpu_reads()): card == CPU at READS_SMALL_G on every output, the G run's
    first READS_SMALL_G groups equal to the CPU run over the sliced G
    schedule, zero safety counts, the trap's counts and receipts.  Then the
    damped kernel's no-loss with_health instance at k=8 against its plain
    version on the settled and the final state, the timing (the parity run
    and the bench line's reps, `line`, each from the settled state), the
    busy share and
    launches of 4 general rounds of the Safe-read phase, and the kernel
    against its bound.  Returns (launches, parity error, timing)."""
    plan = workload.load_plan(READS_PLAN)
    t0 = time.perf_counter()
    settled = reads_settle(dev, G)
    sync()
    t_settle = time.perf_counter() - t0
    # The small run starts from the G settle's first groups (every seeded
    # stream keys on the global group id), the CPU from its own settle.
    start_s = sim.SimState(*(
        None if v is None else v[..., :READS_SMALL_G].contiguous() for v in settled))
    _, run_s = reads_run(start_s, workload.compile_plan(plan, READS_SMALL_G, dev))
    small = reads_result(run_s())
    compiled = workload.compile_plan(plan, G, dev)
    runner, run = reads_run(settled, compiled)
    zero_launches()
    t0 = time.perf_counter()
    out = run()
    sync()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["damped_rounds"][1]
    if launches < 1 or any(counts[k.__name__] != (0, 0) for k in (steady_rounds, chaos_rounds)) \
            or counts["damped_rounds"][0]:
        raise AssertionError(f"reads: unexpected launches {counts}")
    if out[9] != launches * READS_K * G:
        raise AssertionError(f"reads: fused {out[9]} for {launches} launches")
    if any(out[5].tolist()):
        raise AssertionError(f"reads G={G}: safety violations {out[5].tolist()}")
    check_state(out[0])
    full = reads_result(out)
    rejected_blocks = [r0 for r0, ran in runner.blocks if not ran]
    _, run_u = reads_run(settled, compiled, split=False)
    zero_launches()
    t0 = time.perf_counter()
    unsplit = reads_result(run_u())
    t_unsplit = time.perf_counter() - t0
    if any(a or b for a, b in launch_counts().values()):
        raise AssertionError(f"reads unsplit: a fused kernel launched: {launch_counts()}")
    same_reads(full, unsplit, f"reads G={G}: split against unsplit", fused=False)
    traps = {paused: stale_read_trap(dev, paused) for paused in (True, False)}
    fired = [traps[True][0][i] for i in (pk.SV_STALE_READ, pk.SV_DUAL_LEASE)]
    if min(fired) <= 0 or traps[True][0][pk.SV_DUAL_LEADER]:
        raise AssertionError(f"reads trap, clock paused: safety {traps[True][0]}")
    if any(traps[False][0]):
        raise AssertionError(f"reads trap, no drift: safety {traps[False][0]}")
    cpu_small, cpu_sliced, cpu_traps, t_cpu = cpu_ref.result()
    same_reads(small, cpu_small, f"reads G={READS_SMALL_G}")
    same_reads(full, cpu_sliced, f"reads: the first {READS_SMALL_G} of {G} groups "
               "against the sliced schedule", n=READS_SMALL_G)
    for paused, trap in traps.items():
        cpu_trap = cpu_traps[paused]
        if trap[:2] != cpu_trap[:2] or any(
                not np.array_equal(v, cpu_trap[2][f]) for f, v in trap[2].items()):
            raise AssertionError(f"reads trap paused={paused}: card and CPU differ")
    total = G * compiled.n_rounds
    report = workload.read_report(full["read_stats"], full["percentiles"], full["safety"],
                                  full["stats"], compiled.n_rounds)
    print(f"reads {G}x{P} ({READS_PLAN_NAME}, {compiled.n_rounds} rounds after a "
          f"{READS_SETTLE}-round settle, k={READS_K}): card == CPU at {READS_SMALL_G}x{P} "
          f"(every field, the health planes, the read carry, read stats "
          f"{small['read_stats']}, latency p50/p90/p99 {small['percentiles']}, stats "
          f"{small['stats']}, safety, fused {small['fused']}); at {G}x{P} safety all 0, "
          f"the first {READS_SMALL_G} groups == the CPU run over the sliced schedule, "
          f"split == unsplit on every output; fused_frac {out[9] / total:.4f} ({out[9]} "
          f"of {total}; planned blocks rejected at rounds {rejected_blocks}); damped kernel "
          f"(with_health) launches {launches}; stale-read trap on the card == CPU, clock "
          f"paused: stale_read {fired[0]}, dual_lease {fired[1]}, no drift: all 0; card "
          f"{t_settle:.2f}s settle + {first_s:.2f}s split run + {t_unsplit:.2f}s unsplit, "
          f"CPU {t_cpu:.2f}s (in a reference worker)")
    print(f"  report at G={G}: {json.dumps(report)}")
    # The kernel against its plain version on a lease block's operands.
    kw = dict(round_base=0, rounds=READS_K, election_tick=READS_TICK, heartbeat_tick=1,
              with_cq=True)
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = compiled.append[int(compiled.phase_of_round[READS_LEASE_AT])]
    err = 0
    for st, tsc, note in ((settled, random_tsc(G, 7, dev), "settled"),
                          (out[0], out[1].planes[pk.HP_SINCE_COMMIT], "after the plan")):
        err = max(err, compare(damped_rounds, damped_rounds_reference, DAMPED_OUTPUTS,
                               fused_step.damped_operands(st, crashed, append, None),
                               kw, f"reads {note}", tsc))
    print(f"parity reads damped with_health k={READS_K} (no loss): exact on the settled "
          f"state and the plan's end state at G={G}, the lease phase's Zipf appends")
    samples = [total / first_s] + bench_samples(line)
    fused_frac = (out[9] + line["fused_rounds"]) / (total * (1 + line["reps"]))
    # 4 general rounds of the Safe-read phase, where every block runs general.
    at = READS_SAFE_AT
    head = compiled._replace(
        phase_of_round=compiled.phase_of_round[at:at + READS_PROFILE_ROUNDS],
        read_fire_packed=compiled.read_fire_packed[at:at + READS_PROFILE_ROUNDS])
    _, run_h = reads_run(settled, head, split=False)
    prof = device_profile(run_h)
    n_launch = sum(r["count"] for r in prof["kernels"])
    args = fused_step.damped_operands(settled, crashed, append, None, random_tsc(G, 7, dev))
    t = kernel_times(dev, damped_rounds, damped_rounds_reference, args, kw,
                     bound_work("damped", P, G, READS_K, with_health=True))
    med = statistics.median(samples)
    t.update(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=fused_frac,
             profile=prof, report=report, rejected_blocks=rejected_blocks,
             launches_per_general_round=n_launch / READS_PROFILE_ROUNDS)
    print(f"timing reads {G}x{P} k={READS_K} [{t['card']}]: ticks/s median {med:.1f} "
          f"(min {min(samples):.1f}, max {max(samples):.1f}, the parity run and "
          f"{line['reps']} bench reps from the "
          f"settled state), fused_frac {fused_frac:.4f}; read latency p50/p90/p99 "
          f"{full['percentiles']} rounds; damped_round_kernel (with_health) "
          f"{t['ms']:.4f} ms cold ({t['hot_ms']:.4f} ms hot; a wrapper call "
          f"{t['call_ms']:.4f} ms), plain version {t['plain_ms']:.3f} ms; bound "
          f"{t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f}){plain_bound_note(t)}")
    print(f"profile of {READS_PROFILE_ROUNDS} general rounds of the Safe-read phase (rounds "
          f"{at}-{at + READS_PROFILE_ROUNDS - 1}, and the tail audit): device busy "
          f"{prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%), {n_launch} kernel launches, "
          f"{n_launch / READS_PROFILE_ROUNDS:.0f} a round")
    for row in prof["kernels"][:8]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return launches, err, t


# --- leader transfer and the autopilot (bench.py --autopilot) ------------------


def auto_cfg(n_groups):
    """bench_autopilot's config: election_tick 64, health, leader transfer
    and a commit-stall threshold of 8 rounds."""
    return sim.SimConfig(n_groups=n_groups, n_peers=P, election_tick=AUTO_TICK,
                         collect_health=True, transfer=True, commit_stall_ticks=8)


def auto_append(n_groups, device):
    """bench_autopilot's workload: min(Zipf(1.8), 8) appends a group a round,
    from RandomState(0) (a draw of n values is the first n of a wider one)."""
    rng = np.random.RandomState(0)
    plane = np.minimum(rng.zipf(1.8, size=n_groups), 8).astype(np.int32)
    return torch.from_numpy(plane).to(device)


def auto_settle(device, n_groups):
    """bench_autopilot's settle: init_state, then AUTO_SETTLE plain steps with
    the workload plane (the transfer pump runs every round)."""
    return compiled_settle(auto_cfg(n_groups), device, AUTO_SETTLE,
                           auto_append(n_groups, device))


def auto_run(start, fused=True, segments=None):
    """One Autopilot.run_plan over bench_autopilot's plan from `start` with a
    fresh sim, health planes and Autopilot (its policy state starts empty),
    as a timed rep of the bench does.  The action planes of every cadence
    are recorded by wrapping the instance's _decide; with `segments` (a
    list), each segment's (first round, fused group-rounds, entry state,
    entry health) is appended to it for the segments from the heal phase
    on.  Returns (report, sim, [(round, transfer, kick)])."""
    n_groups, dev = start.term.shape[1], start.term.device
    cfg = auto_cfg(n_groups)
    s = sim.ClusterSim(cfg, device=dev)
    s.state = start
    ap = autopilot.Autopilot(s, autopilot.AutopilotConfig(cadence=AUTO_CADENCE), fused=fused)
    planes = []
    decide = ap._decide

    def recorded(summary, round_idx):
        transfer, kick, inspected = decide(summary, round_idx)
        planes.append((round_idx, transfer.copy(), kick.copy()))
        return transfer, kick, inspected

    ap._decide = recorded
    if segments is not None:
        runner_for = ap._runner_for

        def watched(compiled, cc, rounds):
            run = runner_for(compiled, cc, rounds)

            def seg(*args):
                out = run(*args)
                if args[7] >= AUTO_HEAL_AT:
                    segments.append((args[7], out[7], args[0], args[1]))
                return out
            return seg

        ap._runner_for = watched
    report = ap.run_plan(chaos.plan_from_dict(AUTO_DOC), append=auto_append(n_groups, dev))
    return report, s, planes


def auto_result(report, s, planes):
    """A run as host values: the report, the state arrays, the health planes
    and window_pos, and the action planes of every cadence."""
    return dict(report=report, state=sim.state_to_numpy(s.state),
                planes=s._health.planes.cpu().numpy(), window_pos=s._health.window_pos,
                actions=planes)


def same_auto(a, b, note, n=None, fused=True):
    """Two auto_result dicts: every state field, the health planes and
    window_pos (of a's first n groups when n is given); without n also the
    report (without its fused keys unless `fused`) and the action planes."""
    cut = (lambda v: v) if n is None else (lambda v: v[..., :n])
    for f in sim.SimState._fields:
        x, y = a["state"].get(f), b["state"].get(f)
        if (x is None) != (y is None) or (x is not None and not np.array_equal(cut(x), y)):
            raise AssertionError(f"{note}: state field {f} differs")
    if not np.array_equal(cut(a["planes"]), b["planes"]) or a["window_pos"] != b["window_pos"]:
        raise AssertionError(f"{note}: health planes or window_pos differ")
    if n is not None:
        return
    drop = () if fused else ("fused_rounds", "total_rounds", "fused_frac")
    ra, rb = ({k: v for k, v in r.items() if k not in drop} for r in (a["report"], b["report"]))
    if ra != rb:
        raise AssertionError(f"{note}: reports differ: {ra} != {rb}")
    if len(a["actions"]) != len(b["actions"]) or any(
            x[0] != y[0] or not np.array_equal(x[1], y[1]) or not np.array_equal(x[2], y[2])
            for x, y in zip(a["actions"], b["actions"])):
        raise AssertionError(f"{note}: the action planes differ")


def cpu_autopilot():
    """In a reference worker: bench.py --autopilot's procedure on the CPU at
    AUTO_SMALL_G (its own settle, then the fused run): (result, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    out = auto_result(*auto_run(auto_settle("cpu", AUTO_SMALL_G)))
    return out, time.perf_counter() - t0


def cpu_autopilot_replay(arrays, actions):
    """In a reference worker: the plan from the given settled planes (the 100k
    settle's first AUTO_SMALL_G columns) through make_cadence_runner
    (fused=False), segment by segment, each segment carrying the recorded
    action planes cut to these columns: (state arrays, health planes,
    window_pos, safety, seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    n = AUTO_SMALL_G
    cfg = auto_cfg(n)
    st = sim.state_from_numpy(arrays, "cpu")
    cc = chaos.compile_plan(chaos.plan_from_dict(AUTO_DOC), n, "cpu")
    compiled = autopilot.empty_reconfig_schedule(cc.n_rounds, P, n, "cpu")
    compiled = compiled._replace(append=compiled.append + auto_append(n, "cpu")[None, :])
    run = autopilot.make_cadence_runner(cfg, compiled, cc, AUTO_CADENCE)
    carry = (st, sim.init_health(cfg, "cpu"), reconfig.init_reconfig_state(st),
             *reconfig._zero_accumulators("cpu"), torch.zeros((), dtype=torch.int32))
    by_round = {r: (t, k) for r, t, k in actions}
    for r0 in range(0, cc.n_rounds, AUTO_CADENCE):
        transfer, kick = by_round.get(r0, (np.zeros(n, np.int32), np.zeros((P, n), bool)))
        carry = run(*carry, r0, torch.from_numpy(np.ascontiguousarray(transfer)),
                    torch.from_numpy(np.ascontiguousarray(kick)))[:7]
    st, hl = carry[0], carry[1]
    return (sim.state_to_numpy(st), hl.planes.numpy(), hl.window_pos, carry[5].tolist(),
            time.perf_counter() - t0)


@phase("autopilot")
def phase_autopilot(dev, cpu_ref, pool, line):
    """bench.py --autopilot: the 192-round settle at G on the card; the run
    (fused cadence segments, k=16) from its first AUTO_SMALL_G groups, held to
    the CPU's own procedure at that width (`cpu_ref`, a reference worker's
    future of cpu_autopilot()): the end state, the health planes, the report
    and the action planes of every cadence; then the run at G with the
    launch counts zeroed just before it and read just after, its first
    AUTO_SMALL_G groups held to a CPU replay of the settle's first columns
    through make_cadence_runner(fused=False) with the card's recorded
    actions cut to them; fused=False at G equal on every output but the
    fused count; zero safety counts.  Then the chaos kernel's with_health
    k=16 instance against its plain version on the settled state and on the
    entry of the first fused segment of the heal phase, the timing (the
    parity run and the bench line's reps, `line`), the busy
    share and launches of 4 general rounds of the crash phase, and the
    kernel against its bound.  Returns (launches, parity error, timing)."""
    t0 = time.perf_counter()
    settled = auto_settle(dev, G)
    sync()
    t_settle = time.perf_counter() - t0
    start_s = sim.SimState(*(
        None if v is None else v[..., :AUTO_SMALL_G].contiguous() for v in settled))
    small = auto_result(*auto_run(start_s))
    segments = []
    zero_launches()
    t0 = time.perf_counter()
    report, s, planes = auto_run(settled, segments=segments)
    sync()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    launches = counts["chaos_rounds"][1]
    if any(counts[k.__name__] != (0, 0) for k in (steady_rounds, damped_rounds)) \
            or counts["chaos_rounds"][0]:
        raise AssertionError(f"autopilot: unexpected launches {counts}")
    if report["fused_rounds"] != launches * AUTO_CADENCE * G:
        raise AssertionError(f"autopilot: fused {report['fused_rounds']} for {launches} "
                             "launches")
    if launches < 1:
        raise AssertionError("autopilot: no segment ran the fused kernel")
    if any(report["safety"].values()):
        raise AssertionError(f"autopilot G={G}: safety violations {report['safety']}")
    check_state(s.state)
    full = auto_result(report, s, planes)
    replay = pool.submit(cpu_autopilot_replay, {
        f: v[..., :AUTO_SMALL_G] for f, v in sim.state_to_numpy(settled).items()},
        [(r, t[:AUTO_SMALL_G], k[:, :AUTO_SMALL_G]) for r, t, k in planes])
    t0 = time.perf_counter()
    general = auto_result(*auto_run(settled, fused=False))
    t_general = time.perf_counter() - t0
    same_auto(full, general, f"autopilot G={G}: fused against general", fused=False)
    # The k=16 instance against its plain version: the settled state and the
    # entry of the first fused segment of the heal phase.
    cc = chaos.compile_plan(chaos.plan_from_dict(AUTO_DOC), G, dev)
    # (The kernel equals its plain version on any operands; a heal phase that
    # fused nothing falls back to its first segment's entry.)
    heal = [sg for sg in segments if sg[1]] or segments
    r_heal, heal_fused, st_heal, hl_heal = heal[0]
    append = auto_append(G, dev)
    err = 0
    for st, tsc, rb, note in ((settled, random_tsc(G, 8, dev), 0, "settled"),
                              (st_heal, hl_heal.planes[pk.HP_SINCE_COMMIT], r_heal,
                               f"entry of the heal segment at round {r_heal} "
                               f"(fused: {bool(heal_fused)})")):
        _, loss, crashed, _ = chaos.schedule_planes(cc, rb)
        kw = dict(round_base=rb, rounds=AUTO_CADENCE, election_tick=AUTO_TICK,
                  heartbeat_tick=1)
        err = max(err, compare(chaos_rounds, chaos_rounds_reference, CHAOS_OUTPUTS,
                               fused_step.chaos_operands(st, crashed, append, loss),
                               kw, f"autopilot {note}", tsc))
    del segments, heal, st_heal, hl_heal
    print(f"parity autopilot chaos with_health k={AUTO_CADENCE}: exact on the settled "
          f"state and at the entry of the heal segment from round {r_heal} (fused: "
          f"{bool(heal_fused)}) at G={G}, an all-zero loss plane")
    samples = [G * AUTO_ROUNDS / first_s] + bench_samples(line)
    fused_frac = ((report["fused_rounds"] + line["fused_rounds"])
                  / (G * AUTO_ROUNDS * (1 + line["reps"])))
    # 4 general rounds of the crash phase.
    compiled = autopilot.empty_reconfig_schedule(cc.n_rounds, P, G, dev)
    compiled = compiled._replace(append=compiled.append + append[None, :])
    cfg = auto_cfg(G)
    head = autopilot.make_cadence_runner(cfg, compiled, cc, AUTO_PROFILE_ROUNDS)
    no_t = torch.zeros(G, dtype=torch.int32, device=dev)
    no_k = torch.zeros((P, G), dtype=torch.bool, device=dev)
    carry = (settled, sim.init_health(cfg, dev), reconfig.init_reconfig_state(settled),
             *reconfig._zero_accumulators(dev), torch.zeros((), dtype=torch.int32, device=dev))
    prof = device_profile(lambda: head(*carry, AUTO_CRASH_AT, no_t, no_k))
    n_launch = sum(r["count"] for r in prof["kernels"])
    _, loss, crashed, _ = chaos.schedule_planes(cc, 0)
    args = fused_step.chaos_operands(settled, crashed, append, loss, random_tsc(G, 8, dev))
    kw = dict(round_base=0, rounds=AUTO_CADENCE, election_tick=AUTO_TICK, heartbeat_tick=1)
    t = kernel_times(dev, chaos_rounds, chaos_rounds_reference, args, kw,
                     bound_work("chaos", P, G, AUTO_CADENCE, with_health=True))
    cpu_small, t_cpu = cpu_ref.result()
    same_auto(small, cpu_small, f"autopilot G={AUTO_SMALL_G}")
    t_wait = time.perf_counter()
    st_r, planes_r, pos_r, safety_r, t_replay = replay.result()
    t_wait = time.perf_counter() - t_wait
    same_auto(full, dict(state=st_r, planes=planes_r, window_pos=pos_r),
              f"autopilot: the first {AUTO_SMALL_G} of {G} groups against the CPU replay",
              n=AUTO_SMALL_G)
    if any(safety_r):
        raise AssertionError(f"autopilot replay: safety violations {safety_r}")
    med = statistics.median(samples)
    acted = sum(1 for _, tr, k in planes if tr.any() or k.any())
    print(f"autopilot {G}x{P} (bench.py --autopilot's plan: {AUTO_ROUNDS} rounds, "
          f"{AUTO_ROUNDS // AUTO_CADENCE} cadence segments of {AUTO_CADENCE}, after a "
          f"{AUTO_SETTLE}-round settle): card == CPU at {AUTO_SMALL_G}x{P} (every field, the "
          f"health planes, the report, the action planes of every cadence; actions "
          f"{small['report']['actions']}, fused {small['report']['fused_rounds']}); at "
          f"{G}x{P} safety all 0, the first {AUTO_SMALL_G} groups == the CPU replay of the "
          f"recorded actions, fused == general on every output but the fused count; "
          f"chaos kernel (with_health, k={AUTO_CADENCE}) launches {launches}; {acted} of "
          f"{len(planes)} boundaries acted; card {t_settle:.2f}s settle + {first_s:.2f}s "
          f"run + {t_general:.2f}s general run, CPU {t_cpu:.2f}s and replay "
          f"{t_replay:.2f}s (in reference workers; waited {t_wait:.1f}s)")
    print(f"  report at G={G}: {json.dumps(report)}")
    t.update(ticks_per_s=samples, ticks_per_s_median=med, fused_frac=fused_frac,
             profile=prof, report=report,
             launches_per_general_round=n_launch / AUTO_PROFILE_ROUNDS)
    print(f"timing autopilot {G}x{P} k={AUTO_CADENCE} [{t['card']}]: ticks/s median "
          f"{med:.1f} (min {min(samples):.1f}, max {max(samples):.1f}, the parity run "
          f"and {line['reps']} bench reps, from the settled state), fused_frac "
          f"{fused_frac:.4f}; mttr_rounds {report['mttr_rounds']}, reelections "
          f"{report['reelections']}, commit_stall_group_rounds "
          f"{report['commit_stall_group_rounds']}, actions {report['actions']}; "
          f"chaos_round_kernel (with_health) {t['ms']:.4f} ms cold ({t['hot_ms']:.4f} ms "
          f"hot; a wrapper call {t['call_ms']:.4f} ms), plain version {t['plain_ms']:.3f} "
          f"ms; bound {t['bound_ms']:.4f} ms (bytes {t['bytes_bound_ms']:.4f}, operations "
          f"{t['ops_bound_ms']:.4f}){plain_bound_note(t)}")
    print(f"profile of {AUTO_PROFILE_ROUNDS} general rounds of the crash phase (rounds "
          f"{AUTO_CRASH_AT}-{AUTO_CRASH_AT + AUTO_PROFILE_ROUNDS - 1}) [{t['card']}]: device "
          f"busy {prof['busy_us']:.1f} of {prof['wall_us']:.1f} us "
          f"({100 * prof['busy_share']:.1f}%), {n_launch} kernel launches, "
          f"{n_launch / AUTO_PROFILE_ROUNDS:.0f} a round")
    for row in prof["kernels"][:8]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return launches, err, t


# --- black-box forensics (bench.py --blackbox, the injected traps) -----------


def bb_mask(n_groups, device):
    """A seeded violation mask (0.1% of the slot-group pairs) that the parity
    runs stamp onto their last round with record_safety, so that the capture
    has offenders."""
    viol = np.random.RandomState(9).rand(pk.N_SAFETY, n_groups) < 0.001
    return torch.from_numpy(viol).to(device)


def bb_parity_run(device, n_groups=BB_SMALL_G):
    """BB_ROUNDS plain rounds of ClusterSim with the black box on from
    init_state, one append a group a round, then bb_mask stamped onto the last
    round: (state arrays, black-box arrays, capture)."""
    s = sim.ClusterSim(sim.SimConfig(n_groups=n_groups, n_peers=P, blackbox=True),
                       device=device)
    s.run(BB_ROUNDS, append_n=torch.ones(n_groups, dtype=torch.int32, device=device))
    s.record_safety(bb_mask(n_groups, device))
    return sim.state_to_numpy(s.state), sim.blackbox_to_numpy(s._blackbox), s.forensics()


def bb_scenario(device, n_groups):
    """partition_heal.json (check_quorum off) with the black box on: (report,
    state, black box)."""
    s = sim.ClusterSim(chaos_cfg(n_groups, False)._replace(blackbox=True),
                       chaos=chaos.load_plan(CHAOS_PLAN), device=device)
    report = s.run_plan()
    return report, s.state, s._blackbox


def cpu_forensics():
    """In a reference worker: bb_parity_run and bb_scenario at their small
    widths, (parity run, (report, state arrays, black-box arrays), seconds)."""
    worker_threads()
    t0 = time.perf_counter()
    plain = bb_parity_run("cpu")
    report, st, bb = bb_scenario("cpu", CHAOS_SMALL_G)
    return (plain, (report, sim.state_to_numpy(st), sim.blackbox_to_numpy(bb)),
            time.perf_counter() - t0)


def same_arrays(a, b, note, n=None):
    """Two {name: array or int} dicts equal; with `n`, `a`'s planes cut to
    their first n groups (the last axis)."""
    if a.keys() != b.keys():
        raise AssertionError(f"{note}: fields {sorted(a)} != {sorted(b)}")
    for k, v in a.items():
        if n is not None and isinstance(v, np.ndarray):
            v = v[..., :n]
        if not np.array_equal(v, b[k]):
            raise AssertionError(f"{note}: {k} differs")


def check_trap(session, slots, offenders, note, golden=None):
    """Each slot's capture is exactly `offenders`, nothing else tripped; the
    headline offender's repro (written to a scratch directory) equals the
    golden below its first line, the line that names the generating package;
    it replays RED, then green with the trap disabled.  Returns the repro's
    summary."""
    import tempfile

    cap = session.sim.forensics()
    for slot in slots:
        got = sorted(o["group"] for o in cap["offenders"][slot])
        if got != sorted(offenders) or cap["counts"][slot] != len(offenders):
            raise AssertionError(f"{note}: {slot} captured {got} ({cap['counts'][slot]}), "
                                 f"injected {offenders}")
    stray = {o["group"] for offs in cap["offenders"].values() for o in offs} - set(offenders)
    if stray:
        raise AssertionError(f"{note}: uninjected groups tripped: {sorted(stray)}")
    with tempfile.TemporaryDirectory() as tmp:
        out = session.extract(tmp)
        with open(out["scenario_path"], encoding="utf-8") as fh:
            text = fh.read()
        red = forensics.replay_scenario(out["scenario_path"])
        green = forensics.replay_scenario(out["scenario_path"], disable_traps=True)
    if golden is not None:
        with open(os.path.join(GOLDEN_DIR, golden), encoding="utf-8") as fh:
            want = fh.read().splitlines()[1:]
        if text.splitlines()[1:] != want:
            raise AssertionError(f"{note}: the group-{out['group']} repro differs from "
                                 f"tests/testdata/forensics/{golden}")
    if not (out["reproduced"] and red["fired"][out["slot"]] > 0
            and red["outcome"] == red["expected"]):
        raise AssertionError(f"{note}: the repro does not replay RED: {red['fired']}")
    if any(green["fired"].values()):
        raise AssertionError(f"{note}: the repro fires with the trap off: {green['fired']}")
    return {k: out[k] for k in ("slot", "group", "round", "fired")}


def bb_timing(dev, steady_med):
    """bench_blackbox: ClusterSim.run of SCANS x BB_ROUNDS plain rounds a rep
    at G with the black box off and on, in alternating reps after a
    BB_SETTLE-round settle;
    ticks/s, blackbox_overhead_pct, blackbox_overhead_fused_pct against the
    steady path's median (`steady_med`) from this run, and a profile of
    BB_PROFILE_ROUNDS black-box rounds and of as many plain ones.  Then the
    dispatcher on a black-box config: fast_multi_round(k=32) runs the general
    branch, no fused kernel launches, and both sims end in the same state."""
    append = torch.ones(G, dtype=torch.int32, device=dev)
    sims = {flag: sim.ClusterSim(sim.SimConfig(n_groups=G, n_peers=P, blackbox=flag),
                                 device=dev) for flag in (False, True)}
    for s in sims.values():
        s.run(BB_SETTLE, append_n=append)
    samples = {False: [], True: []}
    for rep in range(BB_REPS):
        for flag in (False, True) if rep % 2 == 0 else (True, False):
            sync()
            t0 = time.perf_counter()
            for _ in range(SCANS):
                sims[flag].run(BB_ROUNDS, append_n=append)
            sync()
            samples[flag].append(G * BB_ROUNDS * SCANS / (time.perf_counter() - t0))
    prof = {flag: device_profile(lambda f=flag: sims[f].run(BB_PROFILE_ROUNDS, append_n=append))
            for flag in (False, True)}
    assert_same(sims[True].state, on_cpu(sims[False].state), "black box on against off")
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    zero_launches()
    out, fused = fused_step.fast_multi_round(sims[True].cfg, k=K, count_fused=True)(
        sims[True].state, crashed, append, 0)
    counts = launch_counts()
    if fused or any(a or b for a, b in counts.values()):
        raise AssertionError(f"blackbox: a fused block ran on a black-box config: "
                             f"fused {fused}, launches {counts}")
    sims[False].run(K, append_n=append)
    assert_same(out, on_cpu(sims[False].state),
                "fast_multi_round on a black-box config against the plain rounds")
    check_state(out, G)
    off, on = (statistics.median(samples[f]) for f in (False, True))
    launches = {f: sum(r["count"] for r in prof[f]["kernels"]) / BB_PROFILE_ROUNDS
                for f in (False, True)}
    res = dict(
        card=card_line(), ticks_per_s_off=samples[False], ticks_per_s_on=samples[True],
        ticks_per_s_off_median=off, ticks_per_s_on_median=on,
        ticks_per_s_fused_median=steady_med,
        blackbox_overhead_pct=100 * (off - on) / off,
        blackbox_overhead_fused_pct=100 * (steady_med - on) / steady_med,
        launches_per_round_off=launches[False], launches_per_round_on=launches[True],
        busy_share_off=prof[False]["busy_share"], busy_share_on=prof[True]["busy_share"],
        profile_on=prof[True])
    print(f"timing blackbox {G}x{P} [{res['card']}]: ClusterSim.run, {BB_REPS} alternating "
          f"reps a side of {SCANS} x {BB_ROUNDS} plain rounds: ticks/s median off {off:.1f} (min "
          f"{min(samples[False]):.1f}, max {max(samples[False]):.1f}), on {on:.1f} (min "
          f"{min(samples[True]):.1f}, max {max(samples[True]):.1f}); "
          f"blackbox_overhead_pct {res['blackbox_overhead_pct']:.2f}; against the steady "
          f"fused path's median {steady_med:.1f} from this run, "
          f"blackbox_overhead_fused_pct {res['blackbox_overhead_fused_pct']:.2f}")
    for f in (False, True):
        print(f"profile of {BB_PROFILE_ROUNDS} plain rounds, black box {'on' if f else 'off'}"
              f": device busy {prof[f]['busy_us']:.1f} of {prof[f]['wall_us']:.1f} us "
              f"({100 * prof[f]['busy_share']:.1f}%), {launches[f]:.0f} kernel launches a "
              f"round")
    for row in prof[True]["kernels"][:6]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return res


@phase("forensics")
def phase_forensics(dev, cpu_ref, scenario_off, steady_med):
    """bench.py --blackbox and the injected traps at G.  The parity run at
    BB_SMALL_G on the card against the CPU's (`cpu_ref`, a reference worker's
    future of cpu_forensics()): the state, the ring, the trip plane, the round
    count and the capture.  partition_heal.json at G with the black box on:
    the same report and end state as the chaos phase's black-box-off run
    (`scenario_off`), and its first CHAOS_SMALL_G groups' ring and trip plane
    equal to the CPU run at that width.  The commit-regress trap at G, P=3
    (the golden repro) and P=5, and the clock-pause trap at G, P=3: each
    captures exactly its offenders, and the group-1 repro replays RED, then
    green with the trap disabled.  The drain: one stamped violation reaches
    a HealthMonitor once.  Then bb_timing."""
    t0 = time.perf_counter()
    plain = bb_parity_run(dev)
    scen = bb_scenario(dev, G)
    t_card = time.perf_counter() - t0
    if scen[0] != scenario_off[0]:
        raise AssertionError(f"blackbox chaos: the report differs from the black-box-off "
                             f"run: {scen[0]} != {scenario_off[0]}")
    assert_same(scen[1], on_cpu(scenario_off[1]), "blackbox chaos against the black-box-off run")
    if any(scen[0]["safety"].values()):
        raise AssertionError(f"blackbox chaos: safety violations {scen[0]['safety']}")
    traps = {}
    t0 = time.perf_counter()
    for n_peers, golden in ((3, "commit_regress.txt"), (5, None)):
        session = forensics.run_commit_regress_trap(
            n_groups=G, n_peers=n_peers, offenders=REGRESS_OFFENDERS, device=dev)
        if session.safety[pk.SV_COMMIT_REGRESSED] != len(REGRESS_OFFENDERS):
            raise AssertionError(f"commit-regress trap P={n_peers}: {session.safety}")
        traps[f"commit_regress_p{n_peers}"] = check_trap(
            session, ["commit_regressed"], REGRESS_OFFENDERS,
            f"commit-regress trap P={n_peers}", golden)
    session = forensics.run_clock_pause_trap(
        n_groups=G, offenders=PAUSE_OFFENDERS, device=dev)
    traps["clock_pause_p3"] = check_trap(
        session, ["stale_read", "dual_lease"], PAUSE_OFFENDERS, "clock-pause trap",
        "clock_pause.txt")
    t_traps = time.perf_counter() - t0
    mon = HealthMonitor()
    s = sim.ClusterSim(sim.SimConfig(n_groups=G, n_peers=P, blackbox=True),
                       health_monitor=mon, device=dev)
    s.run(3, append_n=torch.ones(G, dtype=torch.int32, device=dev))
    viol = torch.zeros((pk.N_SAFETY, G), dtype=torch.bool, device=dev)
    viol[pk.SV_DUAL_LEADER, DRAIN_GROUP] = True
    s.record_safety(viol)
    s._drain()
    first = mon.incidents()
    s._drain()
    if first != [{"slot": "dual_leader", "count": 1,
                  "offenders": [{"group": DRAIN_GROUP, "round": 2}]}] or mon.incidents() != first:
        raise AssertionError(f"blackbox drain: incidents {mon.incidents()}")
    (st_c, bb_c, cap_c), (rep_c, scen_st_c, scen_bb_c), t_cpu = cpu_ref.result()
    same_arrays(plain[0], st_c, f"blackbox parity G={BB_SMALL_G}: state")
    same_arrays(plain[1], bb_c, f"blackbox parity G={BB_SMALL_G}: black box")
    if plain[2] != cap_c:
        raise AssertionError(f"blackbox parity G={BB_SMALL_G}: capture {plain[2]} != {cap_c}")
    if any(rep_c["safety"].values()):
        raise AssertionError(f"blackbox chaos G={CHAOS_SMALL_G}: safety {rep_c['safety']}")
    same_arrays(sim.state_to_numpy(scen[1]), scen_st_c,
                f"blackbox chaos: the first {CHAOS_SMALL_G} groups' state", CHAOS_SMALL_G)
    same_arrays(sim.blackbox_to_numpy(scen[2]), scen_bb_c,
                f"blackbox chaos: the first {CHAOS_SMALL_G} groups' black box", CHAOS_SMALL_G)
    fired = sum(plain[2]["counts"].values())
    print(f"forensics: card == CPU at {BB_SMALL_G}x{P} over {BB_ROUNDS} plain rounds with "
          f"the black box on (state, ring, trip plane, round count {plain[1]['round_idx']}, "
          f"capture of {fired} stamped offenders); {CHAOS_PLAN_NAME} at {G}x{P} with the "
          f"black box on: report and end state == the black-box-off run, safety all 0, the "
          f"first {CHAOS_SMALL_G} groups' ring and trip plane == the CPU run; card "
          f"{t_card:.2f}s, CPU {t_cpu:.2f}s (in a reference worker)")
    print(f"forensics traps at G={G} (card {t_traps:.2f}s): commit-regress P=3 and P=5 "
          f"capture exactly {REGRESS_OFFENDERS}, clock-pause P=3 (stale_read, dual_lease) "
          f"exactly {PAUSE_OFFENDERS}; the group-1 repros == "
          f"tests/testdata/forensics/{{commit_regress,clock_pause}}.txt below line 1, RED "
          f"then green with the traps off: {json.dumps(traps)}; the drain reported one "
          f"incident, then none")
    return dict(traps=traps, parity_card_s=t_card, cpu_s=t_cpu, traps_s=t_traps,
                **bb_timing(dev, steady_med))


# --- the compiled scan (ClusterSim.run_compiled), checkpoints, make_runner ---

COMPILED_ROUNDS, COMPILED_HALF, COMPILED_REPS = 64, 12, 2
COMPILED_SMALL_G, COMPILED_PROFILE_ROUNDS = 8192, 4


def same_sims(a, b, note):
    """Two ClusterSims on the card: every SimState plane, the counter plane
    and host totals, the health planes and window_pos, the black box and
    its round count."""
    assert_same(a.state, on_cpu(b.state), note)
    if a._counters is not None and (a._host_counters != b._host_counters
                                    or not torch.equal(a._counters, b._counters)):
        raise AssertionError(f"{note}: counters differ")
    if a._health is not None and (a._health.window_pos != b._health.window_pos or
                                  not torch.equal(a._health.planes, b._health.planes)):
        raise AssertionError(f"{note}: health planes or window_pos differ")
    if a._blackbox is not None:
        same_arrays(sim.blackbox_to_numpy(a._blackbox), sim.blackbox_to_numpy(b._blackbox),
                    f"{note}: black box")


def summaries(mon):
    return [e["summary"] for e in mon.summary_ring()]


def one_way_cut(n_groups, dev):
    """tests/test_chaos_parity.py's link plane: all links up but 0 -> 1 in
    even groups."""
    link = torch.ones((P, P, n_groups), dtype=torch.bool, device=dev)
    link[0, 1, ::2] = False
    return link


def loop_against_graph(dev, cfg, note, settle=SETTLE, start=None, monitor=False,
                       link=None):
    """ClusterSim.run against run_compiled over COMPILED_ROUNDS rounds of one
    append a group, from `start` (else init_state) after `settle` rounds on
    both: equal sims, counter totals, and, with a monitor and no counters,
    equal summary streams; with `link`, COMPILED_ROUNDS run_round(link=)
    calls against run_compiled(link=), the graph of the link-gated round.
    Returns the run_compiled sim."""
    app = torch.ones(cfg.n_groups, dtype=torch.int32, device=dev)
    mons = (HealthMonitor(), HealthMonitor()) if monitor else (None, None)
    a, b = (sim.ClusterSim(cfg, health_monitor=m, device=dev) for m in mons)
    for s in (a, b):
        if start is not None:
            s.state = start
        s.run(settle, append_n=app)
    if link is None:
        a.run(COMPILED_ROUNDS, append_n=app)
    else:
        for _ in range(COMPILED_ROUNDS):
            a.run_round(append_n=app, link=link)
    b.run_compiled(COMPILED_ROUNDS, append_n=app, link=link)
    if cfg.collect_counters and a.counters() != b.counters():
        raise AssertionError(f"{note}: counter totals differ")
    same_sims(a, b, note)
    if monitor and not cfg.collect_counters and summaries(mons[0]) != summaries(mons[1]):
        raise AssertionError(f"{note}: the monitor's summary streams differ")
    check_state(b.state, cfg.n_groups)
    return b


def compiled_small(device):
    """At COMPILED_SMALL_G from init_state: COMPILED_ROUNDS compiled plain
    rounds with the black box on, and 2 x COMPILED_HALF compiled damped
    (check-quorum and pre-vote) rounds; (plain state arrays, black-box
    arrays, damped state arrays)."""
    n = COMPILED_SMALL_G
    app = torch.ones(n, dtype=torch.int32, device=device)
    s = sim.ClusterSim(sim.SimConfig(n_groups=n, n_peers=P, blackbox=True), device=device)
    s.run_compiled(COMPILED_ROUNDS, append_n=app)
    d = sim.ClusterSim(sim.SimConfig(n_groups=n, n_peers=P, check_quorum=True,
                                     pre_vote=True), device=device)
    d.run_compiled(2 * COMPILED_HALF, append_n=app)
    return (sim.state_to_numpy(s.state), sim.blackbox_to_numpy(s._blackbox),
            sim.state_to_numpy(d.state))


def cpu_compiled():
    """In a reference worker: compiled_small on the CPU, and its seconds."""
    worker_threads()
    t0 = time.perf_counter()
    return compiled_small("cpu"), time.perf_counter() - t0


def checkpoint_round_trips(dev, st, bb, tmp):
    """All four checkpoint families at G through files in `tmp`: what loads
    equals what was saved; {family: bytes}."""
    idx = torch.arange(G, dtype=torch.int32, device=dev)
    rst = reconfig.init_reconfig_state(st)._replace(
        stage=idx % 2, op_ptr=idx % 5, prop_owner=idx % (P + 1), prop_index=idx,
        prop_term=idx // 7)
    rcar = workload.ReadCarry(pending_mode=idx % 3, pending_since=idx)
    rstats = torch.arange(workload.N_READ_STATS, dtype=torch.int32, device=dev)
    hist = torch.arange(workload.N_LAT_BUCKETS, dtype=torch.int32, device=dev)
    paths = {f: os.path.join(tmp, f + ".npz") for f in ("state", "blackbox", "reconfig", "read")}
    checkpoint.save_state(st, paths["state"])
    checkpoint.save_blackbox_state(bb, paths["blackbox"])
    checkpoint.save_reconfig_state(rst, paths["reconfig"])
    checkpoint.save_read_state(rcar, rstats, hist, paths["read"])
    assert_same(checkpoint.load_state(paths["state"]), on_cpu(st), "checkpoint: state")
    same_arrays(sim.blackbox_to_numpy(checkpoint.load_blackbox_state(paths["blackbox"])),
                sim.blackbox_to_numpy(bb), "checkpoint: black box")
    back = checkpoint.load_reconfig_state(paths["reconfig"])
    (pm, ps), rstats2, hist2 = checkpoint.load_read_state(paths["read"])
    pairs = [(getattr(back, f), getattr(rst, f), f) for f in reconfig.ReconfigState._fields]
    pairs += [(pm, rcar.pending_mode, "pending_mode"), (ps, rcar.pending_since, "pending_since"),
              (rstats2, rstats, "read_stats"), (hist2, hist, "lat_hist")]
    for got, want, name in pairs:
        if not (got.device == want.device and got.dtype == want.dtype
                and torch.equal(got, want)):
            raise AssertionError(f"checkpoint: {name} differs")
    return {f: os.path.getsize(p) for f, p in paths.items()}


def compiled_timing(dev, damped_settled):
    """ClusterSim.run against run_compiled, COMPILED_ROUNDS rounds a rep,
    COMPILED_REPS alternating reps a side, for the plain round with the
    black box off and on and for the check-quorum round (from the damped
    parity phase's settled state): ticks/s, the graph's capture seconds,
    nodes and branch nodes, and the busy share and launches of
    COMPILED_PROFILE_ROUNDS rounds each way."""
    app = torch.ones(G, dtype=torch.int32, device=dev)
    cases = {"plain": sim.SimConfig(n_groups=G, n_peers=P),
             "blackbox": sim.SimConfig(n_groups=G, n_peers=P, blackbox=True),
             "damped": damped_cfg(G)}
    out = {}
    for name, cfg in cases.items():
        loop, graph = (sim.ClusterSim(cfg, device=dev) for _ in range(2))
        for s in (loop, graph):
            if name == "damped":
                s.state = damped_settled
            else:
                s.run(SETTLE, append_n=app)
        sync()
        t0 = time.perf_counter()
        graph.run_compiled(1, append_n=app)  # the capture
        sync()
        first_s = time.perf_counter() - t0
        loop.run(1, append_n=app)
        samples = {"loop": [], "graph": []}
        for rep in range(COMPILED_REPS):
            for side in ("loop", "graph") if rep % 2 == 0 else ("graph", "loop"):
                sync()
                t0 = time.perf_counter()
                if side == "loop":
                    loop.run(COMPILED_ROUNDS, append_n=app)
                else:
                    graph.run_compiled(COMPILED_ROUNDS, append_n=app)
                sync()
                samples[side].append(G * COMPILED_ROUNDS / (time.perf_counter() - t0))
        assert_same(loop.state, on_cpu(graph.state), f"compiled timing {name}: graph against loop")
        prof = {"loop": device_profile(lambda: loop.run(COMPILED_PROFILE_ROUNDS, append_n=app)),
                "graph": device_profile(
                    lambda: graph.run_compiled(COMPILED_PROFILE_ROUNDS, append_n=app))}
        g = next(iter(graph._round_graphs.values()))
        med = {k: statistics.median(v) for k, v in samples.items()}
        # The profiler's own host cost stretches its wall time, so the busy
        # share of the timed reps is the profiled device time a round over
        # the timed median's wall time a round.
        timed = {k: prof[k]["busy_us"] / COMPILED_PROFILE_ROUNDS / (1e6 * G / med[k])
                 for k in med}
        out[name] = dict(
            ticks_per_s_loop=samples["loop"], ticks_per_s_graph=samples["graph"],
            ticks_per_s_loop_median=med["loop"], ticks_per_s_graph_median=med["graph"],
            speedup=med["graph"] / med["loop"], first_call_s=first_s,
            capture_s=g.capture_s, nodes=g.nodes, branch_nodes=g.branch_nodes,
            busy_share_timed_loop=timed["loop"], busy_share_timed_graph=timed["graph"],
            election_arm=("conditional node" if g.capture.bodies
                          else "none: the damped round has no election branch"),
            **{f"{k}_{side}": prof[side][k] for side in prof for k in ("busy_share", "busy_us", "wall_us")},
            launches_per_round_loop=sum(r["count"] for r in prof["loop"]["kernels"])
            / COMPILED_PROFILE_ROUNDS,
            launches_per_round_graph=sum(r["count"] for r in prof["graph"]["kernels"])
            / COMPILED_PROFILE_ROUNDS)
    off, on = (out[k]["ticks_per_s_graph_median"] for k in ("plain", "blackbox"))
    out["blackbox_overhead_pct"] = 100 * (off - on) / off
    return out


@phase("compiled")
def phase_compiled(dev, cpu_ref, damped_settled, scenario_off):
    """ClusterSim.run_compiled (one round captured into a CUDA graph and
    replayed) against ClusterSim.run at G: the plain round from a settled
    state with the black box off and on, from init_state (elections: the
    conditional node's taken arm), with counters and health and a monitor,
    and with health and a monitor (equal summary streams).  The damped round
    with a checkpoint mid-run: run_compiled(COMPILED_HALF) from the damped
    parity phase's settled state with the black box on, save_state and
    save_blackbox_state, load into a fresh sim, run_compiled(COMPILED_HALF)
    more, equal to run(2 x COMPILED_HALF); the four checkpoint families round
    trip at G.  Card == CPU at COMPILED_SMALL_G (`cpu_ref`, a reference
    worker's future of cpu_compiled()).  runner.make_runner on the chaos plan
    at G equals the chaos scenario phase's run (`scenario_off`).  Then
    compiled_timing."""
    import tempfile

    app = torch.ones(G, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    plain = sim.SimConfig(n_groups=G, n_peers=P)
    graphs_info = {}
    for note, cfg, kw in (
            ("plain", plain, {}),
            ("plain from init_state", plain, dict(settle=0)),
            ("black box", plain._replace(blackbox=True), {}),
            ("counters, health, monitor", plain._replace(
                collect_counters=True, collect_health=True), dict(monitor=True)),
            ("health, monitor", plain._replace(collect_health=True), dict(monitor=True)),
            ("link-gated from init_state, health", plain._replace(collect_health=True),
             dict(settle=0, link=one_way_cut(G, dev)))):
        g = next(iter(loop_against_graph(dev, cfg, f"compiled {note}", **kw)
                      ._round_graphs.values()))
        graphs_info[note] = dict(nodes=g.nodes, branch_nodes=g.branch_nodes,
                                 capture_s=g.capture_s)
    cfg = damped_cfg(G)._replace(blackbox=True)
    a, b = (sim.ClusterSim(cfg, device=dev) for _ in range(2))
    a.state = b.state = damped_settled
    a.run(2 * COMPILED_HALF, append_n=app)
    b.run_compiled(COMPILED_HALF, append_n=app)
    with tempfile.TemporaryDirectory() as tmp:
        spath, bpath = os.path.join(tmp, "state.npz"), os.path.join(tmp, "bb.npz")
        checkpoint.save_state(b.state, spath)
        checkpoint.save_blackbox_state(b._blackbox, bpath)
        c = sim.ClusterSim(cfg, device=dev)
        c.state = checkpoint.load_state(spath)
        c._blackbox = checkpoint.load_blackbox_state(bpath)
        c.run_compiled(COMPILED_HALF, append_n=app)
        same_sims(a, c, "compiled damped with a checkpoint mid-run")
        sizes = checkpoint_round_trips(dev, c.state, c._blackbox, tmp)
    t_parity = time.perf_counter() - t0
    t0 = time.perf_counter()
    compiled = chaos.compile_plan(chaos.load_plan(CHAOS_PLAN), G, dev)
    ccfg = chaos_cfg(G, False)
    st0 = sim.init_state(ccfg, device=dev)
    out = runner.make_runner(ccfg, (compiled,))(st0, sim.init_health(ccfg, dev))
    stats, safety = out[-2:]
    report = HealthMonitor.chaos_report(stats.tolist(), safety.tolist(), compiled.n_rounds)
    if report != scenario_off[0]:
        raise AssertionError(f"make_runner: report {report} != the chaos phase's "
                             f"{scenario_off[0]}")
    assert_same(out[0], on_cpu(scenario_off[1]), "make_runner against the chaos phase")
    if out[1].window_pos != scenario_off[2].window_pos or not torch.equal(
            out[1].planes, scenario_off[2].planes):
        raise AssertionError("make_runner: health planes differ from the chaos phase's")
    t_runner = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = compiled_small(dev)
    t_small = time.perf_counter() - t0
    cpu, t_cpu = cpu_ref.result()
    same_arrays(small[0], cpu[0], f"compiled plain G={COMPILED_SMALL_G}: state")
    same_arrays(small[1], cpu[1], f"compiled plain G={COMPILED_SMALL_G}: black box")
    same_arrays(small[2], cpu[2], f"compiled damped G={COMPILED_SMALL_G}: state")
    timing = compiled_timing(dev, damped_settled)
    card = card_line()
    print(f"compiled {G}x{P} [{card}]: run_compiled == run over {COMPILED_ROUNDS} rounds "
          f"(plain settled, plain from init_state, black box on with ring, trip plane and "
          f"round count, counters and health with a monitor: counter totals, health "
          f"summary stream; the link-gated round with a one-way 0 -> 1 cut in even "
          f"groups and health from init_state == {COMPILED_ROUNDS} run_round(link=)) and damped with the black box on: run_compiled({COMPILED_HALF}), "
          f"save_state + save_blackbox_state, load into a fresh sim, run_compiled("
          f"{COMPILED_HALF}) == run({2 * COMPILED_HALF}) ({t_parity:.2f}s); checkpoint "
          f"files at G: {json.dumps(sizes)} bytes; card == CPU at {COMPILED_SMALL_G}x{P} "
          f"(plain with the black box on, {COMPILED_ROUNDS} rounds; damped "
          f"{2 * COMPILED_HALF} rounds; card {t_small:.2f}s, CPU {t_cpu:.2f}s in a reference "
          f"worker); runner.make_runner on {CHAOS_PLAN_NAME} at G == the chaos phase's report "
          f"and end state ({t_runner:.2f}s)")
    print(f"compiled graphs: {json.dumps(graphs_info)}")
    for name in ("plain", "blackbox", "damped"):
        r = timing[name]
        print(f"timing compiled {name} {G}x{P} [{card}]: {COMPILED_REPS} alternating reps a "
              f"side of {COMPILED_ROUNDS} rounds: ticks/s run {r['ticks_per_s_loop_median']:.1f}"
              f" (min {min(r['ticks_per_s_loop']):.1f}, max {max(r['ticks_per_s_loop']):.1f}), "
              f"run_compiled {r['ticks_per_s_graph_median']:.1f} (min "
              f"{min(r['ticks_per_s_graph']):.1f}, max {max(r['ticks_per_s_graph']):.1f}), "
              f"{r['speedup']:.2f}x; capture {r['capture_s']:.3f}s (first call "
              f"{r['first_call_s']:.3f}s), {r['nodes']} nodes + {r['branch_nodes']} in the "
              f"branch; election arm: {r['election_arm']}; over {COMPILED_PROFILE_ROUNDS} "
              f"rounds busy {100 * r['busy_share_loop']:.1f}% (run, "
              f"{r['launches_per_round_loop']:.0f} launches a round) against "
              f"{100 * r['busy_share_graph']:.1f}% (graph, "
              f"{r['launches_per_round_graph']:.0f} kernels a round), device "
              f"{r['busy_us_loop']:.1f} against {r['busy_us_graph']:.1f} us, so busy "
              f"{100 * r['busy_share_timed_loop']:.1f}% against "
              f"{100 * r['busy_share_timed_graph']:.1f}% of the timed reps' wall time")
    print(f"timing compiled [{card}]: blackbox_overhead_pct on run_compiled "
          f"{timing['blackbox_overhead_pct']:.2f}")
    return dict(card=card, parity_s=t_parity, runner_s=t_runner, small_card_s=t_small,
                small_cpu_s=t_cpu, checkpoint_bytes=sizes, graphs=graphs_info, **timing)


# --- the host driver (MultiRaft over RawNode) --------------------------------

# examples/multiraft_node.py's TiKV-style node at the group count its
# docstring names: 3 drivers (peer ids 1-3) x DRIVER_G groups, election_tick
# 10, heartbeat_tick 3, MemStorage, in-memory batched inboxes.  The schedule
# (multiraft_node.run_schedule): tick and pump until every group has a leader
# (at most 200 ticks), one proposal a group on its leader's driver, then
# DRIVER_STEADY ticks with a pump after each.
DRIVER_G = 10_000
DRIVER_STEADY = 32
DRIVER_PROFILE_TICKS = 4


class SyncTimes(Metrics):
    """Metrics that also keeps every tick's sync_seconds observation."""

    def __init__(self):
        super().__init__()
        self.sync = []

    def on_driver_tick(self, **kw):
        self.sync.append(kw["sync_seconds"])
        super().on_driver_tick(**kw)


def cpu_driver():
    """The driver schedule with device='cpu' (a reference worker)."""
    out = multiraft_node.run_schedule(DRIVER_G, "cpu", Metrics(), DRIVER_STEADY)
    return out["record"], out["elect_s"] + out["steady_s"]


@phase("driver")
def phase_driver(dev, cpu_ref):
    """The schedule on the card, held to the CPU run: every driver tick's
    active count, the ticks to elect, every group's (term, state,
    leader_id, committed, last_index) on every driver, and status()
    without its metrics entry; then the numbers of the card's run and a
    profile of DRIVER_PROFILE_TICKS ticks of every driver."""
    m = SyncTimes()
    t0 = time.perf_counter()
    out = multiraft_node.run_schedule(DRIVER_G, dev, m, DRIVER_STEADY)
    card_s = time.perf_counter() - t0
    rec, drivers = out["record"], out["drivers"]
    t0 = time.perf_counter()
    ref, cpu_s = cpu_ref.result()
    waited = time.perf_counter() - t0
    if rec["active"] != ref["active"]:
        raise AssertionError("driver: card and CPU differ in the active counts")
    if rec["elect_ticks"] != ref["elect_ticks"]:
        raise AssertionError(f"driver: elections took {rec['elect_ticks']} ticks "
                             f"on the card, {ref['elect_ticks']} on the CPU")
    for id in multiraft_node.PEERS:
        if not np.array_equal(rec["rows"][id], ref["rows"][id]):
            raise AssertionError(f"driver {id}: card and CPU differ in a group's "
                                 "(term, state, leader_id, committed, last_index)")
    if rec["status"] != ref["status"]:
        raise AssertionError(f"driver: status differs: card {rec['status']}, "
                             f"CPU {ref['status']}")
    n = len(multiraft_node.PEERS)
    steady = rec["active"][n * rec["elect_ticks"]:]
    snap = m.registry.snapshot()
    scanned = snap["multiraft_ready_scan_groups_scanned_total"]
    skipped = snap["multiraft_ready_scan_groups_skipped_total"]
    sync_ms = np.array(m.sync) * 1e3
    prof = device_profile(lambda: [d.tick() for _ in range(DRIVER_PROFILE_TICKS)
                                   for d in drivers.values()])
    launches = sum(k["count"] for k in prof["kernels"])
    res = dict(
        groups=DRIVER_G, drivers=n, elect_ticks=rec["elect_ticks"],
        elect_s=out["elect_s"], steady_ticks=DRIVER_STEADY, steady_s=out["steady_s"],
        steady_group_ticks_per_s=n * DRIVER_G * DRIVER_STEADY / out["steady_s"],
        sync_ms_median=float(np.median(sync_ms)),
        sync_ms_p99=float(np.percentile(sync_ms, 99)), sync_observations=len(sync_ms),
        steady_active_share=sum(steady) / (len(steady) * DRIVER_G),
        ready_scan_skipped_share=skipped / (scanned + skipped),
        tick_launches=launches / (DRIVER_PROFILE_TICKS * n),
        tick_device_us=prof["busy_us"] / (DRIVER_PROFILE_TICKS * n),
        card=card_line(), card_s=card_s, cpu_s=cpu_s, waited_s=waited)
    print(f"driver {n} x {DRIVER_G} groups (examples/multiraft_node.py's node, "
          f"election_tick 10, heartbeat_tick 3): card == CPU on every tick's "
          f"active count ({len(rec['active'])} driver ticks), the ticks to elect "
          f"({rec['elect_ticks']}), every group's (term, state, leader_id, "
          f"committed, last_index) on every driver and status() but its metrics; "
          f"card {card_s:.2f}s, CPU {cpu_s:.2f}s (in a reference worker; waited "
          f"{waited:.1f}s)")
    print(f"timing driver [{res['card']}]: elected in {rec['elect_ticks']} ticks, "
          f"{out['elect_s']:.3f} s; steady {res['steady_group_ticks_per_s']:.1f} "
          f"group-ticks/s ({DRIVER_STEADY} ticks with pumps, {out['steady_s']:.3f} s); "
          f"tick sync {res['sync_ms_median']:.4f} ms median, {res['sync_ms_p99']:.4f} "
          f"p99 ({len(sync_ms)} ticks); {100 * res['steady_active_share']:.2f}% of "
          f"groups active a steady tick; ready scan skipped "
          f"{100 * res['ready_scan_skipped_share']:.2f}%; a tick {res['tick_launches']:.1f} "
          f"device launches (copies included), {res['tick_device_us']:.1f} us of device "
          f"time (torch.profiler over {DRIVER_PROFILE_TICKS} ticks of each driver)")
    for row in prof["kernels"][:6]:
        print(f"  {row['us']:10.1f} us {row['count']:6d}x  {row['name']}")
    return res


# --- the bench entry point (python -m raft_tpu_torch.bench) -------------------

BENCH_FUSED_REPS, BENCH_SCENARIO_REPS = 5, 1
# (name, the bench's flags, reps); the fused floor is the one the timing
# phases hold (--health and the damped paths at 1.0).  The last mode runs
# the autopilot over partition_heal.json, under which its transfer arm acts.
BENCH_MODES = (
    ("default", [], BENCH_FUSED_REPS),
    ("health", ["--health", "--fused-floor", "1.0"], BENCH_FUSED_REPS),
    ("lossy", ["--lossy", "0.01"], BENCH_FUSED_REPS),
    ("check_quorum", ["--check-quorum", "--fused-floor", "1.0"], BENCH_FUSED_REPS),
    ("check_quorum_health", ["--check-quorum", "--health", "--fused-floor", "1.0"],
     BENCH_FUSED_REPS),
    ("blackbox", ["--blackbox"], BENCH_FUSED_REPS),
    ("composed", ["--lossy", "0.01", "--check-quorum"], BENCH_SCENARIO_REPS),
    ("chaos", ["--chaos", CHAOS_PLAN], BENCH_SCENARIO_REPS),
    ("chaos_cq", ["--chaos", CHAOS_PLAN, "--check-quorum"], BENCH_SCENARIO_REPS),
    ("reconfig", ["--reconfig", RECONFIG_PLAN], BENCH_SCENARIO_REPS),
    ("reconfig_cq", ["--reconfig", RECONFIG_PLAN, "--check-quorum"], BENCH_SCENARIO_REPS),
    ("prod_fused", ["--prod-fused", PROD_PLAN], BENCH_SCENARIO_REPS),
    ("reads", ["--reads", READS_PLAN], BENCH_SCENARIO_REPS),
    ("autopilot", ["--autopilot"], BENCH_SCENARIO_REPS),
    ("autopilot_transfer", ["--autopilot", "--autopilot-plan", CHAOS_PLAN],
     BENCH_SCENARIO_REPS),
)
BENCH_PROFILE_DIR = os.path.join(HERE, "build", "bench-profile")


def bench_samples(line):
    """A scenario bench line's per-rep ticks/s (its reps are 1, or its min
    and max bracket the median)."""
    return [line["median"]] if line["reps"] == 1 else [line["min"], line["median"],
                                                       line["max"]]


@phase("bench")
def phase_bench(dev):
    """Every mode of `python -m raft_tpu_torch.bench` but --mesh at 100k x 5,
    through its line builder (tbench.main prints each line as the command
    line does), the launch counts zeroed just before each mode and read just
    after; a mode with fused group-rounds must have launched its kernel.  A
    safety count, a failed sanity check or a fused-floor miss exits
    nonzero.  Then --profile over the default mode once, the suites with
    --quick and the config-3 BASELINE row at 100k x 5."""
    print(f"bench: {card_line()}; anchor host CPU: {host_cpu()}")
    lines = {}
    for name, flags, reps in BENCH_MODES:
        zero_launches()
        t0 = time.perf_counter()
        line = tbench.main(flags + ["--reps", str(reps)])
        sync()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        fused = line.get("fused_off", line)["fused_rounds"]
        launched = sum(sum(c) for c in counts.values())
        print(f"bench {name}: {secs:.1f} s, launches {counts}")
        if fused and not launched:
            raise AssertionError(f"bench {name}: {fused} fused group-rounds and no "
                                 "fused kernel launch")
        lines[name] = dict(line=line, seconds=secs, launches=counts)
    transfers = lines["autopilot_transfer"]["line"]["actions"]["transfers"]
    if not transfers:
        raise AssertionError("bench --autopilot --autopilot-plan partition_heal.json: "
                             "the transfer arm never acted at 100k")
    print(f"bench: the autopilot's transfer arm acted at G={G}: {transfers} transfers")

    t0 = time.perf_counter()
    profiled = tbench.main(["--profile", BENCH_PROFILE_DIR, "--reps", "1",
                            "--skip-anchor"])
    secs = time.perf_counter() - t0
    trace = os.path.join(BENCH_PROFILE_DIR, "trace.json")
    with open(trace, encoding="utf-8") as fh:
        events = json.load(fh)["traceEvents"]
    kernels = sum(1 for ev in events if ev.get("cat") == "kernel")
    print(f"bench --profile: {secs:.1f} s, {trace} {os.path.getsize(trace)} bytes, "
          f"{len(events)} events, {kernels} CUDA kernel records")
    if not kernels:
        print("bench --profile: the trace holds no CUDA kernel record")

    t0 = time.perf_counter()
    rows = suites.main(["--quick"])
    rows.append(suites.baseline_config(*suites.BASELINE_CONFIGS[1], dev))
    suites.print_table(rows[-1:])
    print(f"suites: {time.perf_counter() - t0:.1f} s")
    return dict(lines=lines, profile=dict(line=profiled, bytes=os.path.getsize(trace),
                                          events=len(events), kernels=kernels),
                suites=rows, card=card_line(), host_cpu=host_cpu())


def host_cpu():
    """The host CPU as the host reports it (the native anchor's hardware):
    /proc/cpuinfo's model name and vendor, else lscpu's model name; the
    machine type and the core count beside it."""
    info = {}
    try:
        with open("/proc/cpuinfo", encoding="utf-8") as fh:
            for row in fh:
                key, _, val = row.partition(":")
                info.setdefault(key.strip().lower(), val.strip())
    except OSError:
        pass
    if "model name" not in info:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            for row in out.splitlines():
                key, _, val = row.partition(":")
                info.setdefault(key.strip().lower(), val.strip())
        except (OSError, subprocess.SubprocessError):
            pass
    model = info.get("model name") or "model not reported"
    vendor = info.get("vendor_id") or info.get("vendor id") or "vendor not reported"
    return f"{model} ({vendor}, {platform.machine()}, {os.cpu_count()} cores)"


# --- multi-GPU (ClusterSim(mesh=), bench --mesh) -------------------------------

MESH_G = 1_000_000  # BASELINE config 5: 1M groups x 3 peers
MESH_REPS = 2
MESH_RANKS = 2  # gloo ranks sharing the one card
MESH_BASES = (50_000, 8_300_000)  # kernel group bases: rank 1's, and near 2**23
MESH_COMPILED_ROUNDS = 64
MESH_LOSSY_BLOCKS = 2


def mesh_prod_cfg(n_groups):
    """The split prod run's config on the mesh: prod_cfg without counters
    (ClusterSim.run_reconfig(split=True) refuses a 256-round plan past the
    counter drain cap at this width)."""
    return prod_cfg(n_groups)._replace(collect_counters=False)


def mesh_paths(s_plain, s_lossy, s_prod, mesh=None):
    """The mesh phase's three paths on three ClusterSims (each a rank's
    block on `mesh`, or unsharded): run_compiled(64) of the plain round from
    the election storm; the lossy path (LOSSY_SETTLE compiled rounds, then
    fast_multi_round(k=32, with_chaos=True) blocks under 1% loss); the prod
    plan's settle (PROD_SETTLE compiled rounds) and run_reconfig(split=True,
    k=8).  The launch counts are zeroed just before each fused path and read
    just after (summed over the ranks on a mesh).  Returns the whole batch's
    end states, the health planes, the report, the fused counts, the
    launches and the seconds of each path."""
    from raft_tpu_torch.multiraft import sharding

    dev, n_groups = s_plain.device, s_plain.cfg.n_groups
    ones = torch.ones(n_groups, dtype=torch.int32, device=dev)
    total = (lambda n: n) if mesh is None else (
        lambda n: int(sharding.reduce_i32(mesh, n, "sum").item()))
    whole = (lambda t: t) if mesh is None else (
        lambda t: sharding.gather_groups(mesh, t, n_groups))

    def state(s):
        st = s.state if mesh is None else sharding.gather_state(mesh, s.state, n_groups)
        return sim.state_to_numpy(st)

    out, secs = {}, {}
    t0 = time.perf_counter()
    s_plain.run_compiled(MESH_COMPILED_ROUNDS, append_n=ones)
    sync()
    secs["plain"] = time.perf_counter() - t0
    out["plain"] = state(s_plain)

    t0 = time.perf_counter()
    s_lossy.run_compiled(LOSSY_SETTLE, append_n=ones)
    lcfg = s_lossy._lcfg
    n = lcfg.n_groups
    link = torch.ones((P, P, n), dtype=torch.bool, device=dev)
    loss = uniform_loss(n, P, dev)
    fast = fused_step.fast_multi_round(lcfg, k=K, with_chaos=True, count_fused=True)
    (crashed_l, append_l) = s_lossy._block(
        torch.zeros((P, n_groups), dtype=torch.bool, device=dev), ones)
    zero_launches()
    st, fused = s_lossy.state, 0
    for b in range(MESH_LOSSY_BLOCKS):
        st, fused = fast(st, crashed_l, append_l, link, loss, LOSSY_SETTLE + b * K, fused)
    sync()
    lossy_launches = total(chaos_rounds.launches)
    s_lossy.state = st
    secs["lossy"] = time.perf_counter() - t0
    out["lossy"] = state(s_lossy)
    out["lossy_fused"] = total(fused)

    plan, chaos_plan = plan_docs(PROD_PLAN)
    t0 = time.perf_counter()
    s_prod.run_compiled(PROD_SETTLE, append_n=ones)
    sync()
    secs["prod_settle"] = time.perf_counter() - t0
    zero_launches()
    t0 = time.perf_counter()
    report = s_prod.run_reconfig(plan, chaos_plan=chaos_plan, split=True,
                                 split_k=PROD_K, split_window=PROD_WINDOW)
    sync()
    secs["prod"] = time.perf_counter() - t0
    prod_launches = total(damped_rounds.health_launches)
    out["prod"] = state(s_prod)
    out["prod_health"] = whole(s_prod._health.planes).cpu().numpy()
    out["prod_report"] = report
    out["launches"] = {"chaos": lossy_launches, "damped": prod_launches}
    out["seconds"] = secs
    return out


def mesh_sims(dev, mesh=None, n_groups=G):
    """The three ClusterSims of mesh_paths at n_groups x P on `mesh` (or
    unsharded on `dev`)."""
    plan, _ = plan_docs(PROD_PLAN)
    kw = dict(mesh=mesh) if mesh is not None else dict(device=dev)
    return (sim.ClusterSim(sim.SimConfig(n_groups=n_groups, n_peers=P), **kw),
            sim.ClusterSim(lossy_cfg(n_groups), **kw),
            sim.ClusterSim(mesh_prod_cfg(n_groups),
                           *reconfig.initial_masks(plan, n_groups, dev), **kw))


def mesh_rank(mesh, n_groups=G):
    """One gloo rank sharing the card: its block of mesh_paths' sims."""
    return mesh_paths(*mesh_sims(mesh.device, mesh, n_groups), mesh=mesh)


def same_mesh_paths(a, b, note):
    for path in ("plain", "lossy", "prod"):
        for f, v in b[path].items():
            if not np.array_equal(a[path][f], v):
                raise AssertionError(f"{note}: {path} differs in {f}")
    if not np.array_equal(a["prod_health"], b["prod_health"]):
        raise AssertionError(f"{note}: prod health planes differ")
    if a["prod_report"] != b["prod_report"]:
        raise AssertionError(f"{note}: prod reports differ {a['prod_report']} "
                             f"{b['prod_report']}")
    if a["lossy_fused"] != b["lossy_fused"]:
        raise AssertionError(f"{note}: fused counts differ {a['lossy_fused']} "
                             f"{b['lossy_fused']}")


def base_checks(kernel, reference, names, args, kw, note):
    """`kernel` at each MESH_BASES base on the operands' groups from the
    first base on: equal to its plain version at that base, and to the same
    slice of one launch over all the operands from that base minus the
    slice's offset.  Returns the max |difference| (0)."""
    lo = MESH_BASES[0]
    err = 0
    for base in MESH_BASES:
        part = tuple(a[..., lo:].contiguous() for a in args)
        got = kernel(*part, **kw, group_base=base)
        err = max(err, compare(kernel, reference, names, part,
                               dict(kw, group_base=base), f"{note} group_base={base}"))
        whole = kernel(*args, **kw, group_base=base - lo)
        for name, g, w in zip(names, got, whole):
            if not torch.equal(g, w[..., lo:]):
                raise AssertionError(f"{note} group_base={base}: {name} differs from "
                                     "the whole-batch launch's slice")
    return err


@phase("mesh")
def phase_mesh(dev):
    """The multi-GPU slice on the one card.  `python -m raft_tpu_torch.bench
    --mesh 1 --groups 1000000` (config 5, NCCL, world 1) with its end state
    equal to an unsharded run_compiled over the same segments; MESH_RANKS
    gloo ranks sharing the card at G x P (mesh_paths: run_compiled(64) from
    the election storm, the lossy path, the prod plan's split run) equal to
    the same paths unsharded on the card, the launch counts of the lossy
    and prod paths summed over the ranks; then the chaos kernel (k=32) and
    the damped kernel's with_loss with_health instance (k=8) at group bases
    50,000 and 8,300,000 against their plain versions and the slices of
    whole-batch launches, and each timed at base 50,000 on 50,000 groups.
    Returns the two kernel rows' (launches, error, timing) and the mesh
    numbers."""
    import tempfile

    out = {}
    # 1. bench --mesh 1 at 1M x 3, held to an unsharded run on the card.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh_state.npz")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "raft_tpu_torch.bench", "--mesh", "1", "--groups",
             str(MESH_G), "--reps", str(MESH_REPS), "--mesh-state", path],
            cwd=HERE, capture_output=True, text=True, timeout=600,
        )
        wall = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"bench --mesh 1 exited {res.returncode}:\n"
                                 f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(line))
        if not (line["n_devices"] == 1 and line["n_leaders"] > 0 and line["total_commit"] > 0):
            raise AssertionError(f"bench --mesh 1: bad line {line}")
        cfg = tbench.mesh_config(MESH_G)
        s = sim.ClusterSim(cfg, device=dev)
        ones = torch.ones(MESH_G, dtype=torch.int32, device=dev)
        t0 = time.perf_counter()
        for rounds in tbench.mesh_rounds(False, MESH_REPS):
            s.run_compiled(rounds, append_n=ones)
        sync()
        local_s = time.perf_counter() - t0
        got = np.load(path)
        for f, v in sim.state_to_numpy(s.state).items():
            if not np.array_equal(got[f], v):
                raise AssertionError(f"bench --mesh 1: the end state differs in {f}")
        del s, got, ones
    rounds = sum(tbench.mesh_rounds(False, MESH_REPS))
    out["bench_mesh1"] = dict(line=line, wall_s=wall, unsharded_s=local_s, rounds=rounds)
    print(f"mesh: bench --mesh 1 at {MESH_G}x{tbench.MESH_PEERS} [{card_line()}]: "
          f"{line['median']:.1f} ticks/s median over {MESH_REPS} reps, n_leaders "
          f"{line['n_leaders']}, total_commit {line['total_commit']}, per-card plane "
          f"bytes {line['per_chip_plane_bytes']['total_per_chip']}; its end state after "
          f"{rounds} rounds == an unsharded run_compiled over the same segments "
          f"({local_s:.2f}s on the card); the command {wall:.1f}s wall")
    torch.cuda.empty_cache()

    # 2. MESH_RANKS gloo ranks sharing the card, held to the paths unsharded.
    from raft_tpu_torch.multiraft import sharding

    t0 = time.perf_counter()
    ranks = sharding.launch(MESH_RANKS, mesh_rank, devices=[dev] * MESH_RANKS,
                            timeout=900)
    ranks_wall = time.perf_counter() - t0
    local_sims = mesh_sims(dev)
    local = mesh_paths(*local_sims)
    same_mesh_paths(ranks, local, f"{MESH_RANKS} gloo ranks vs unsharded")
    # Each rank launches the fused kernel over its own block for every block
    # the whole batch fuses.
    if (min(local["launches"].values()) < 1 or ranks["launches"]
            != {k: MESH_RANKS * v for k, v in local["launches"].items()}):
        raise AssertionError(f"mesh: launches {ranks['launches']} on the ranks, "
                             f"{local['launches']} unsharded")
    if any(ranks["prod_report"]["safety"].values()):
        raise AssertionError(f"mesh: safety violations {ranks['prod_report']['safety']}")
    rep = ranks["prod_report"]
    print(f"mesh: {MESH_RANKS} gloo ranks on the card at {G}x{P} == unsharded on the "
          f"card: run_compiled({MESH_COMPILED_ROUNDS}) from the election storm, the lossy "
          f"path ({LOSSY_SETTLE} compiled rounds + {MESH_LOSSY_BLOCKS} fused blocks, "
          f"fused {ranks['lossy_fused']}), prod_fused.json split k={PROD_K} (report, "
          f"fused_frac {rep['fused_frac']}, health planes); launches summed over the "
          f"ranks {ranks['launches']} ({local['launches']} unsharded); rank 0's "
          f"seconds {ranks['seconds']} "
          f"(launch to result {ranks_wall:.1f}s), unsharded {local['seconds']}")
    out["ranks"] = dict(seconds=ranks["seconds"], wall_s=ranks_wall,
                        unsharded_seconds=local["seconds"], launches=ranks["launches"],
                        fused_frac=rep["fused_frac"], lossy_fused=ranks["lossy_fused"])

    # 3. The kernels at a nonzero group base, on the unsharded lossy path's
    # end state and the prod plan's end state.
    crashed = torch.zeros((P, G), dtype=torch.bool, device=dev)
    append = torch.ones(G, dtype=torch.int32, device=dev)
    ckw = dict(round_base=LOSSY_SETTLE + MESH_LOSSY_BLOCKS * K, rounds=K,
               election_tick=LOSSY_TICK, heartbeat_tick=1)
    cargs = fused_step.chaos_operands(local_sims[1].state, crashed, append,
                                      uniform_loss(G, P, dev))
    chaos_err = base_checks(chaos_rounds, chaos_rounds_reference, CHAOS_OUTPUTS,
                            cargs, ckw, "chaos k=32")
    plan, chaos_plan = plan_docs(PROD_PLAN)
    cc = chaos.compile_plan(chaos_plan, G, dev)
    lossy_r0 = int(torch.nonzero(cc.phase_of_round == 1)[0])
    _, ploss, pcrashed, _ = chaos.schedule_planes(cc, lossy_r0)
    dkw = dict(round_base=lossy_r0, rounds=PROD_K, election_tick=PROD_TICK,
               heartbeat_tick=1, with_cq=True)
    prod_sim = local_sims[2]
    dargs = fused_step.damped_operands(prod_sim.state, pcrashed, append, ploss,
                                       prod_sim._health.planes[pk.HP_SINCE_COMMIT])
    damped_err = base_checks(damped_rounds, damped_rounds_reference,
                             DAMPED_OUTPUTS + ("tsc",), dargs, dkw,
                             f"damped with_loss with_health k={PROD_K}")
    lo = MESH_BASES[0]
    n = G - lo
    part_c = tuple(a[..., lo:].contiguous() for a in cargs)
    part_d = tuple(a[..., lo:].contiguous() for a in dargs)
    tc = kernel_times(dev, chaos_rounds, chaos_rounds_reference, part_c,
                      dict(ckw, group_base=lo), bound_work("chaos", P, n, K))
    dlabel = f"damped with_loss with_health k={PROD_K}"
    dtimes = {(groups, base): kernel_times(
        dev, damped_rounds, damped_rounds_reference, args, dict(dkw, group_base=base),
        bound_work("damped", P, groups, PROD_K, with_loss=True, with_health=True))
        for groups, args in ((n, part_d), (G, dargs)) for base in (lo, 0)}
    td = dtimes[(n, lo)]
    for label, groups, base, t in [("chaos k=32", n, lo, tc)] + [
            (dlabel, groups, base, t) for (groups, base), t in dtimes.items()]:
        print(f"mesh: {label} at group_base {base} on {groups} groups [{t['card']}]: "
              f"{t['ms']:.4f} ms cold ({t['hot_ms']:.4f} hot), plain version "
              f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
              f"{100 * t['bound_ms'] / t['ms']:.1f} % of it){plain_bound_note(t)}")
    print(f"mesh: chaos and damped kernels at group_base {MESH_BASES} == their plain "
          "versions and the slices of whole-batch launches, exact")
    out.update(chaos_kernel=tc, damped_kernel=td, damped_kernel_bases={
        f"{groups} groups at base {base}": t for (groups, base), t in dtimes.items()})
    return ((ranks["launches"]["chaos"], chaos_err, tc),
            (ranks["launches"]["damped"], damped_err, td), out)


@phase("references")
def phase_references(checks):
    """The deferred checks of the steady, lossy and check-quorum phases:
    each card run against its CPU run from a reference worker."""
    for check in checks:
        check()


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

    t_start = time.perf_counter()
    phase_build()
    occupancy = {kind: kernel_occupancy(kind) for kind in ("chaos", "damped")}
    occupancy["steady_warp"] = warp_occupancy()
    steady_err, steady_wide_err, steady_wide_st, steady_warp_err = phase_parity(dev)
    if opts.quick:
        phase_predicate(dev)
        *_, chaos_wide_st = phase_chaos_parity(dev)
        *_, damped_wide_st = phase_damped_parity(dev)
        phase_wide(dev, steady_wide_st, chaos_wide_st, damped_wide_st)
        phase_warp(dev)
        print("quick: every kernel variant equals its plain version on the card")
        return 0
    # The bench's loops are host-bound: they run before the reference workers
    # load the host.
    bench_out = phase_bench(dev)
    lines = {name: v["line"] for name, v in bench_out["lines"].items()}
    # The CPU references run in reference worker processes while the card
    # works: first the ones that need nothing of the card, in the order the
    # card's phases wait for them, then each as its input exists.  The
    # steady, lossy and check-quorum phases' checks wait for the end.
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(WORKERS, mp_context=spawn) as pool:
        cpu_runs = pool.submit(cpu_scenarios)
        cpu_reconfig_runs = pool.submit(cpu_reconfig)
        cpu_prod_run = pool.submit(cpu_prod)
        cpu_reads_run = pool.submit(cpu_reads)
        cpu_auto_run = pool.submit(cpu_autopilot)
        cpu_bb_run = pool.submit(cpu_forensics)
        cpu_compiled_run = pool.submit(cpu_compiled)
        lossy_small = pool.submit(cpu_lossy_small)
        damped_small = pool.submit(cpu_health_path, dict(
            cfg=damped_cfg(CQ_SMALL_G), blocks=CQ_SMALL_BLOCKS, settle=CQ_SETTLE))
        checks = []
        (cfg, st_main, steady_launches, steady_run, steady_h_launches, check,
         predicate_launches_plain) = phase_main(dev, pool)
        checks.append(check)
        fast_step_err, check = phase_fast_step(dev, st_main, pool)
        checks.append(check)
        steady_err = worst(steady_err, fast_step_err)
        predicate = phase_predicate(dev)
        steady = phase_timing(dev, cfg, st_main)
        chaos_err, settled, chaos_wide_err, chaos_wide_st = phase_chaos_parity(dev)
        st, chaos_launches, lossy_run, chaos_h_launches, check = phase_lossy(
            dev, settled, pool, lossy_small)
        checks.append(check)
        lossy = phase_lossy_timing(dev, st)
        (damped_err, damped_loss_err, settled, damped_wide_err,
         damped_wide_st) = phase_damped_parity(dev)
        wide = phase_wide(dev, steady_wide_st, chaos_wide_st, damped_wide_st)
        del steady_wide_st, chaos_wide_st, damped_wide_st
        warp_launches, warp_err, warp = phase_warp(dev)
        steady_warp_err = worst(steady_warp_err, warp_err)
        cpu_run = pool.submit(cpu_composed, sim.state_to_numpy(settled))
        (st, damped_launches, damped_run, damped_h_launches, check,
         predicate_launches_cq) = phase_damped(dev, settled, pool, damped_small)
        checks.append(check)
        damped = phase_damped_timing(dev, st)
        steady_h, damped_h, lossy_h = phase_health_timing(
            dev, {"steady": steady_run, "lossy": lossy_run, "damped": damped_run})
        scenario, scenario_off = phase_chaos_scenario(dev, cpu_runs, bench_out["lines"])
        composed = phase_composed_timing(dev, settled, lines["composed"])
        steady_hybrid_fused = phase_steady_hybrid(dev, st_main)
        composed_launches, composed_err, composed_branches = phase_composed(
            dev, settled, cpu_run)
        reconfig_out = phase_reconfig(dev, cpu_reconfig_runs, bench_out["lines"])
        prod_launches, prod_err, prod = phase_prod_fused(dev, cpu_prod_run,
                                                         lines["prod_fused"])
        reads_launches, reads_err, reads = phase_reads(dev, cpu_reads_run, lines["reads"])
        auto_launches, auto_err, auto = phase_autopilot(dev, cpu_auto_run, pool,
                                                        lines["autopilot"])
        blackbox = phase_forensics(dev, cpu_bb_run, scenario_off,
                                   steady["ticks_per_s_median"])
        compiled_out = phase_compiled(dev, cpu_compiled_run, settled, scenario_off)
        # Submitted here, so the driver's host-bound CPU run overlaps the
        # card's driver run and not the timed loops of the phases before.
        driver = phase_driver(dev, pool.submit(cpu_driver))
        del scenario_off
        mesh_chaos, mesh_damped, mesh_out = phase_mesh(dev)
        phase_references(checks)

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
        worst(damped_loss_err, composed_err)[0], composed), kernel_entry(
        f"damped_rounds with_loss=True with_health=True k={PROD_K}", DAMPED_SOURCE,
        f"{DAMPED_REPLACES} (with_loss=True, with_health=True, k={PROD_K})",
        prod_launches, prod_err, prod), kernel_entry(
        f"damped_rounds with_loss=False with_health=True k={READS_K}", DAMPED_SOURCE,
        f"{DAMPED_REPLACES} (with_loss=False, with_health=True, k={READS_K})",
        reads_launches, reads_err, reads), kernel_entry(
        f"chaos_rounds with_health=True k={AUTO_CADENCE}", CHAOS_SOURCE,
        f"{CHAOS_REPLACES} (with_health=True, k={AUTO_CADENCE})",
        auto_launches, auto_err, auto)] + [kernel_entry(
        f"{label}_rounds P={WIDE_P} with_health=False", source,
        f"{replaces} (P={WIDE_P}, with_health=False)", wide[label][0], err[0],
        wide[label][1])
        for label, source, replaces, err in (
            ("steady", STEADY_WIDE_SOURCE, STEADY_REPLACES, steady_wide_err),
            ("chaos", CHAOS_WIDE_SOURCE, CHAOS_REPLACES, chaos_wide_err),
            ("damped", DAMPED_WIDE_SOURCE, DAMPED_REPLACES, damped_wide_err))] + [
        kernel_entry(f"steady_rounds P={WARP_P} with_health=False (the warp instance)",
                     STEADY_WARP_SOURCE, f"{STEADY_REPLACES} (P={WARP_P}, with_health=False)",
                     warp_launches, steady_warp_err[0], warp),
        kernel_entry(f"chaos_rounds with_health=False group_base={MESH_BASES[0]}",
                     CHAOS_SOURCE, f"{CHAOS_REPLACES} (a mesh rank's block)",
                     *mesh_chaos),
        kernel_entry(f"damped_rounds with_loss=True with_health=True k={PROD_K} "
                     f"group_base={MESH_BASES[0]}", DAMPED_SOURCE,
                     f"{DAMPED_REPLACES} (with_loss=True, with_health=True, "
                     f"k={PROD_K}, a mesh rank's block)", *mesh_damped)] + [
        # Each fleet's launches are those of the main path of its kind:
        # the steady path's (plain) and the check-quorum path's at G.
        kernel_entry(f"steady_predicate {fleet} k={PREDICATE_FLEETS[fleet][1]}",
                     PREDICATE_SOURCE, f"{PREDICATE_REPLACES} ({fleet}'s config)",
                     launches, *predicate[fleet])
        for fleet, launches in (("raftrs-1m-r3", predicate_launches_plain),
                                ("tikv-1m-r3", predicate_launches_cq))]}
    if opts.out:
        os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
        with open(opts.out, "w", encoding="utf-8") as fh:
            json.dump({**kernels, "ptxas": PTXAS, "chaos_occupancy": occupancy["chaos"],
                       "damped_occupancy": occupancy["damped"],
                       "steady_warp_occupancy": occupancy["steady_warp"],
                       "phase_seconds": PHASE_SECONDS,
                       "timing": {
                "steady": steady, "lossy": lossy, "damped": damped,
                "steady_health": steady_h, "damped_health": damped_h,
                "lossy_health_kernel": lossy_h, "chaos_scenario": scenario,
                "composed": composed, "reconfig": reconfig_out, "prod_fused": prod,
                "reads": reads, "autopilot": auto, "blackbox": blackbox,
                "compiled": compiled_out, "wide": wide, "wide_steady": warp,
                "driver": driver,
                "bench": bench_out, "mesh": mesh_out,
                "predicate": {fleet: t for fleet, (_, t) in predicate.items()}},
                "composed_branches": composed_branches,
                "steady_hybrid_fused": steady_hybrid_fused}, fh, indent=1,
                default=str)
    print(f"phases: {sum(PHASE_SECONDS.values()):.1f} s in all, "
          f"{time.perf_counter() - t_start:.1f} s from the first build; "
          + ", ".join(f"{k} {v:.1f}" for k, v in PHASE_SECONDS.items()))
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
