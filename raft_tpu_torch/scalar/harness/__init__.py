"""Deterministic in-memory multi-node test network
(reference: harness/src/{network,interface}.rs).

`Network` wires N `Raft` instances by ID and pumps messages to quiescence,
persisting each peer's unstable data before delivering its outbound messages
(exactly the reference's persist-before-send discipline).  Fault injection:
per-edge drop probabilities, cut/isolate/recover, and message-type filters.

The MultiRaft equivalence harness (raft_tpu_torch.multiraft.parity) drives this
same schedule into the batched backend and asserts identical commit indices.
"""

from .interface import Interface, NOP_STEPPER
from .network import Network

__all__ = ["Interface", "Network", "NOP_STEPPER"]
