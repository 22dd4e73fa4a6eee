"""raft_tpu_torch: the batched multi-Raft engine in PyTorch, with its hot
kernels hand-written in CUDA for the NVIDIA H100 (sm_90a).

A port of `raft_tpu` (JAX on a TPU), module by module; `raft_tpu` stays the
reference and this package imports nothing from it.  Entry points run on
the CUDA card unless the caller passes `device="cpu"`.
"""

from .multiraft import (
    ClusterSim,
    SimConfig,
    SimState,
    fast_multi_round,
    init_state,
    step,
)

__all__ = [
    "ClusterSim",
    "SimConfig",
    "SimState",
    "fast_multi_round",
    "init_state",
    "step",
]
