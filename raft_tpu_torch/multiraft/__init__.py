"""Batched MultiRaft in PyTorch: G groups × P peers as peer-major [P, G]
tensors, counterpart of `raft_tpu/multiraft`.

Modules:
  platform      — resolve_device: `cuda` by default, the CPU on request
  kernels       — elementwise protocol kernels (timeout and loss PRNGs, tick,
                  quorum index, check-quorum liveness and boundary bound, the
                  event counters and the health planes, the packed schedule
                  words, the safety invariants and their per-group form, the
                  lease gate, the black box's fold, mark and capture)
  sim           — SimConfig, SimState, HealthState, BlackboxState, init_state,
                  init_health, init_blackbox, the plain, link-gated and
                  damped steps (with group_ids, the client reads'
                  read_propose and the black box), read_index, ClusterSim
                  (with chaos=, run_plan, run_reconfig, run_reads, the read
                  probes and the forensics accessors)
  chaos         — chaos plans, their compiled schedules, the scenario runner
  reconfig      — membership-change plans compiled through the scalar
                  Changer, the op-protocol runner and the split-horizon
                  runner (ClusterSim.run_reconfig)
  workload      — client read/write plans, their compiled schedules, the
                  workload runner and the fused split runner
                  (ClusterSim.run_reads)
  autopilot     — the fleet autopilot (policy, cadence runner, Autopilot) and
                  the no-op op schedule the workload runners compose
  forensics     — the black box's host half: incident JSON, the datadriven
                  repro format, the one-group scalar replay, extract_repro
                  and the injected traps
  simref        — ScalarCluster: real scalar Rafts (raft_tpu_torch/scalar/)
                  in lockstep rounds, the repros' replay engine
  health        — HealthMonitor, the host consumer of health summaries, chaos,
                  reconfig, read and autopilot reports and black-box incidents
  steady_kernel — k fused steady rounds: the CUDA kernel and its plain version
  chaos_kernel  — k fused loss-gated rounds: the CUDA kernel and its plain version
  damped_kernel — k fused check-quorum/pre-vote rounds: the CUDA kernel and its
                  plain version
  fused_step    — steady_mask/steady_predicate, steady_round, chaos_round,
                  damped_round, fast_step, fast_multi_round,
                  hybrid_multi_round
  planes        — the plane registry: one row per device plane (packing,
                  checkpoint family, gating flags)
  schedules     — the schedule registry: one row per compiled schedule
                  array, family and runner variant
  runner        — make_runner, the one factory of every scenario runner
                  (chaos, reconfig, workload, their split forms, the
                  autopilot's cadence segment)
  graphs        — CUDA-graph capture with a device-side branch (the
                  conditional node), for ClusterSim.run_compiled
  checkpoint    — save and load of the four checkpoint families, whose files
                  cross between the packages
  driver        — MultiRaft: G RawNodes behind one peer id, one device tick
                  a tick, host work only on the fired groups
"""

from .driver import MultiRaft
from .fused_step import (
    fast_multi_round,
    fast_step,
    hybrid_multi_round,
    steady_predicate,
    steady_round,
)
from .health import HealthMonitor
from .sim import (
    ClusterSim,
    HealthState,
    SimConfig,
    SimState,
    init_health,
    init_state,
    step,
)

__all__ = [
    "ClusterSim",
    "HealthMonitor",
    "HealthState",
    "MultiRaft",
    "SimConfig",
    "SimState",
    "fast_multi_round",
    "fast_step",
    "hybrid_multi_round",
    "init_health",
    "init_state",
    "steady_predicate",
    "steady_round",
    "step",
]
