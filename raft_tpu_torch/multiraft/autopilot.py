"""The leader-placement autopilot's schedule helpers.

Counterpart of `raft_tpu/multiraft/autopilot.py`, reduced to what the ported
paths run: `empty_reconfig_schedule` (:128-149), the no-op op schedule that
the client-workload runners (workload.make_runner, make_split_runner)
compose with their plans.
"""

from __future__ import annotations

import torch

from .platform import DeviceLike, resolve_device
from .reconfig import NO_ROUND, CompiledReconfig

I32 = torch.int32


def empty_reconfig_schedule(
    n_rounds: int, n_peers: int, n_groups: int, device: DeviceLike = None
) -> CompiledReconfig:
    """A no-op CompiledReconfig spanning `n_rounds`: zero ops and zero extra
    append, so composing it through reconfig._runner_body leaves the
    op-protocol carry unmoved.  `phase_of_round` stays on the CPU, as
    compile_plan keeps it; the other arrays lie on `cuda` unless `device`
    says otherwise."""
    dev = resolve_device(device)
    P, G = n_peers, n_groups

    def masks():
        return torch.zeros((1, P, G), dtype=torch.bool, device=dev)

    return CompiledReconfig(
        phase_of_round=torch.zeros((n_rounds,), dtype=I32),
        append=torch.zeros((1, G), dtype=I32, device=dev),
        op_start=torch.full((1, G), NO_ROUND, dtype=I32, device=dev),
        n_ops=torch.zeros((G,), dtype=I32, device=dev),
        tgt_voter=masks(),
        tgt_outgoing=masks(),
        tgt_learner=masks(),
        added=masks(),
        removed=masks(),
        n_peers=P,
    )
