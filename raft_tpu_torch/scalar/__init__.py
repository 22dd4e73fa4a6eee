"""The scalar Raft core, copied from `raft_tpu`'s pure-Python modules so that
the port imports nothing of the JAX package.

For now this holds what the reconfig slice needs: the membership-change
`Changer` (`confchange/`), the `ProgressTracker` (`tracker/`), the quorum
math (`quorum/`), and from `eraftpb`, `errors` and `util` only
`ConfChangeSingle`, `ConfChangeType`, `ConfState`, `conf_state_eq`,
`ConfChangeError` and `majority`.  `reconfig.compile_plan` drives the
`Changer` to validate each planned transition and compute its target
masks.  The layout follows the reference (`raft_tpu/eraftpb.py`,
`raft_tpu/quorum/`, ...), so the rest of the scalar core can join it
module by module.  Nothing here needs torch.
"""

from .eraftpb import ConfChangeSingle, ConfChangeType, ConfState, conf_state_eq
from .errors import ConfChangeError, RaftError

__all__ = [
    "ConfChangeError",
    "ConfChangeSingle",
    "ConfChangeType",
    "ConfState",
    "RaftError",
    "conf_state_eq",
]
