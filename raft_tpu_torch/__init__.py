"""raft_tpu_torch: the batched multi-Raft engine in PyTorch, with its hot
kernels hand-written in CUDA for the NVIDIA H100 (sm_90a).

A port of `raft_tpu` (JAX on a TPU), module by module; `raft_tpu` stays the
reference and this package imports nothing from it.  Entry points run on
the CUDA card unless the caller passes `device="cpu"`.

The package root re-exports the scalar API that `raft_tpu/__init__.py`
does (`Raft`, `RawNode` and the Ready protocol, `MemStorage`, `Metrics`,
...; from `scalar/`), beside the batched sim and the host driver
`MultiRaft` (from `multiraft/`).
"""

from .multiraft import (
    ClusterSim,
    MultiRaft,
    SimConfig,
    SimState,
    fast_multi_round,
    init_state,
    step,
)
from .scalar import *  # noqa: F401,F403 - the reference's prelude
from .scalar import __all__ as _scalar_all

__all__ = [
    "ClusterSim",
    "MultiRaft",
    "SimConfig",
    "SimState",
    "fast_multi_round",
    "init_state",
    "step",
] + list(_scalar_all)
