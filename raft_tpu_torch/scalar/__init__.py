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
forensics replay runs one group of.  `raw_node` (`RawNode`
and the Ready protocol), `status`, `metrics` (`Registry`, `EventTracer`,
`Metrics`) and `codec` (the binary wire format) complete the copy; the
host driver `multiraft.driver.MultiRaft` runs one `RawNode` a group.  The
layout follows the reference (`raft_tpu/eraftpb.py`, `raft_tpu/quorum/`,
...).  Nothing here needs torch, except `Metrics.on_health_summary`,
which reads the lag bucket bounds from `multiraft.kernels`.  The exports
are `raft_tpu/__init__.py`'s (reference: lib.rs:543-570, the prelude).
"""

from .config import Config, INVALID_ID, INVALID_INDEX
from .errors import (
    Compacted,
    ConfChangeError,
    ConfigInvalid,
    ProposalDropped,
    RaftError,
    RequestSnapshotDropped,
    SnapshotOutOfDate,
    SnapshotTemporarilyUnavailable,
    StepLocalMsg,
    StepPeerNotFound,
    StorageError,
    Unavailable,
)
from .eraftpb import (
    ConfChange,
    ConfChangeV2,
    ConfChangeSingle,
    ConfChangeTransition,
    ConfChangeType,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    SnapshotMetadata,
    conf_state_eq,
)
from .log_unstable import Unstable
from .metrics import EventTracer, Metrics, Registry
from .quorum import JointConfig, MajorityConfig, VoteResult
from .raft import (
    CAMPAIGN_ELECTION,
    CAMPAIGN_PRE_ELECTION,
    CAMPAIGN_TRANSFER,
    Raft,
    SoftState,
    StateRole,
    vote_resp_msg_type,
)
from .raft_log import NO_LIMIT, RaftLog
from .raw_node import (
    LightReady,
    Peer,
    RawNode,
    Ready,
    SnapshotStatus,
    is_local_msg,
)
from .read_only import ReadOnly, ReadOnlyOption, ReadState
from .status import Status
from .storage import (
    ArrayStorage,
    ArrayStorageCore,
    MemStorage,
    MemStorageCore,
    RaftState,
    Storage,
)
from .tracker import (
    Configuration,
    Inflights,
    Progress,
    ProgressState,
    ProgressTracker,
)
from .util import default_logger, majority

__all__ = [
    "Compacted",
    "ConfChangeError",
    "ConfigInvalid",
    "ProposalDropped",
    "RaftError",
    "RequestSnapshotDropped",
    "SnapshotOutOfDate",
    "SnapshotTemporarilyUnavailable",
    "StepLocalMsg",
    "StepPeerNotFound",
    "StorageError",
    "Unavailable",
    "Config",
    "ConfChange",
    "ConfChangeV2",
    "ConfChangeSingle",
    "ConfChangeTransition",
    "ConfChangeType",
    "ConfState",
    "Entry",
    "EntryType",
    "HardState",
    "Message",
    "MessageType",
    "Snapshot",
    "SnapshotMetadata",
    "Raft",
    "RawNode",
    "Ready",
    "LightReady",
    "Peer",
    "SnapshotStatus",
    "RaftLog",
    "Storage",
    "ArrayStorage",
    "ArrayStorageCore",
    "MemStorage",
    "MemStorageCore",
    "RaftState",
    "Unstable",
    "Metrics",
    "Registry",
    "EventTracer",
    "ProgressTracker",
    "Progress",
    "ProgressState",
    "Inflights",
    "Configuration",
    "MajorityConfig",
    "JointConfig",
    "VoteResult",
    "ReadOnly",
    "ReadOnlyOption",
    "ReadState",
    "SoftState",
    "StateRole",
    "Status",
    "majority",
    "default_logger",
    "conf_state_eq",
    "is_local_msg",
    "vote_resp_msg_type",
    "NO_LIMIT",
    "INVALID_ID",
    "INVALID_INDEX",
    "CAMPAIGN_ELECTION",
    "CAMPAIGN_PRE_ELECTION",
    "CAMPAIGN_TRANSFER",
]
