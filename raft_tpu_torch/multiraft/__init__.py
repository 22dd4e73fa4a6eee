"""Batched MultiRaft in PyTorch: G groups × P peers as peer-major [P, G]
tensors, counterpart of `raft_tpu/multiraft`.

Modules:
  platform      — resolve_device: `cuda` by default, the CPU on request
  kernels       — elementwise protocol kernels (timeout and loss PRNGs, tick,
                  quorum index, check-quorum liveness and boundary bound, the
                  event counters and the health planes, the packed schedule
                  words, the safety invariants)
  sim           — SimConfig, SimState, HealthState, init_state, init_health,
                  the plain, link-gated and damped steps (with group_ids),
                  ClusterSim (with chaos= and run_plan)
  chaos         — chaos plans, their compiled schedules, the scenario runner
  health        — HealthMonitor, the host consumer of health summaries and
                  chaos scenario reports
  steady_kernel — k fused steady rounds: the CUDA kernel and its plain version
  chaos_kernel  — k fused loss-gated rounds: the CUDA kernel and its plain version
  damped_kernel — k fused check-quorum/pre-vote rounds: the CUDA kernel and its
                  plain version
  fused_step    — steady_mask/steady_predicate, steady_round, chaos_round,
                  damped_round, fast_multi_round, hybrid_multi_round
"""

from .fused_step import (
    fast_multi_round,
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
    "SimConfig",
    "SimState",
    "fast_multi_round",
    "hybrid_multi_round",
    "init_health",
    "init_state",
    "steady_predicate",
    "steady_round",
    "step",
]
