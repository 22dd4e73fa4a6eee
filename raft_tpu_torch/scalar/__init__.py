"""The scalar Raft core, copied from `raft_tpu`'s pure-Python modules so that
the port imports nothing of the JAX package.

It holds the wire format (`eraftpb`), the errors, `util`, the read-only
queue (`read_only`, `read_only_option`), `Config`, `MemStorage`
(`storage`), the log (`log_unstable`, `raft_log`), the `Raft` state machine
(`raft`), the membership-change `Changer` (`confchange/`), the
`ProgressTracker` (`tracker/`), the quorum math (`quorum/`), the test
`harness/` (`Interface`, `Network`) and the datadriven file format
(`datadriven`).  `reconfig.compile_plan` drives the `Changer` to validate
each planned transition and compute its target masks; `multiraft.simref`
builds a `ScalarCluster` of real `Raft`s on the harness, which the
forensics replay runs one group of.  The layout follows the reference
(`raft_tpu/eraftpb.py`, `raft_tpu/quorum/`, ...).  `raw_node`, `status`
and `metrics` are not copied yet.  Nothing here needs torch.
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
