"""Batched MultiRaft in PyTorch: G groups × P peers as peer-major [P, G]
tensors, counterpart of `raft_tpu/multiraft`.

Modules:
  platform      — resolve_device: `cuda` by default, the CPU on request
  kernels       — elementwise protocol kernels (timeout and loss PRNGs, tick,
                  quorum index, check-quorum liveness and boundary bound)
  sim           — SimConfig, SimState, init_state, the plain, link-gated and
                  damped steps, ClusterSim
  steady_kernel — k fused steady rounds: the CUDA kernel and its plain version
  chaos_kernel  — k fused loss-gated rounds: the CUDA kernel and its plain version
  damped_kernel — k fused check-quorum/pre-vote rounds: the CUDA kernel and its
                  plain version
  fused_step    — steady_mask/steady_predicate, steady_round, chaos_round,
                  damped_round, fast_multi_round
"""

from .fused_step import fast_multi_round, steady_predicate, steady_round
from .sim import ClusterSim, SimConfig, SimState, init_state, step

__all__ = [
    "ClusterSim",
    "SimConfig",
    "SimState",
    "fast_multi_round",
    "init_state",
    "steady_predicate",
    "steady_round",
    "step",
]
