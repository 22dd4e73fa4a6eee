"""Error hierarchy for raft-tpu (reference: src/errors.rs:6-109).

The reference models errors as two enums (`Error`, `StorageError`); here they
are an exception hierarchy so both the scalar Python core and the C++ runtime
bindings can raise/translate them uniformly.  Equality (used heavily by the
reference's tests, errors.rs:111-169) compares type + message.
"""

from __future__ import annotations


class RaftError(Exception):
    """Base class for all raft-tpu errors (reference: src/errors.rs:6)."""

    def __eq__(self, other: object) -> bool:
        return type(self) is type(other) and self.args == other.args  # type: ignore[union-attr]

    def __hash__(self) -> int:
        return hash((type(self), self.args))


class Exists(RaftError):
    """The node already exists in the cluster (reference: errors.rs Exists)."""

    def __init__(self, id: int, set: str):
        super().__init__(id, set)
        self.id = id
        self.set = set

    def __str__(self) -> str:
        return f"The node {self.id} already exists in the {self.set} set."


class NotExists(RaftError):
    """The node does not exist in the cluster (reference: errors.rs NotExists)."""

    def __init__(self, id: int, set: str):
        super().__init__(id, set)
        self.id = id
        self.set = set

    def __str__(self) -> str:
        return f"The node {self.id} is not in the {self.set} set."


class ConfChangeError(RaftError):
    """Invalid membership-change request (reference: errors.rs ConfChangeError)."""


class ConfigInvalid(RaftError):
    """Config validation failure (reference: errors.rs ConfigInvalid)."""


class Io(RaftError):
    """IO error wrapper (reference: errors.rs Io)."""


class StepLocalMsg(RaftError):
    """Raft message stepped on a local message type (reference: errors.rs StepLocalMsg)."""

    def __str__(self) -> str:
        return "raft: cannot step raft local message"


class StepPeerNotFound(RaftError):
    """Raft responses dropped: no progress for the peer (reference: errors.rs StepPeerNotFound)."""

    def __str__(self) -> str:
        return "raft: cannot step as peer not found"


class ProposalDropped(RaftError):
    """Proposal was ignored (no leader / transferring / full) (reference: errors.rs ProposalDropped)."""

    def __str__(self) -> str:
        return "raft: proposal dropped"


class RequestSnapshotDropped(RaftError):
    """Follower snapshot request dropped (reference: errors.rs RequestSnapshotDropped)."""

    def __str__(self) -> str:
        return "raft: request snapshot dropped"


class CodecError(RaftError):
    """Serialization/deserialization failure (reference: errors.rs CodecError)."""


# --- Storage errors (reference: src/errors.rs:71-109) ---


class StorageError(RaftError):
    """Base class for storage errors (reference: errors.rs:71)."""


class Compacted(StorageError):
    """Requested log entries are unavailable due to compaction."""

    def __str__(self) -> str:
        return "log compacted"


class Unavailable(StorageError):
    """Requested log entries are unavailable."""

    def __str__(self) -> str:
        return "log unavailable"


class SnapshotOutOfDate(StorageError):
    """Requested snapshot is older than the existing snapshot."""

    def __str__(self) -> str:
        return "snapshot out of date"


class SnapshotTemporarilyUnavailable(StorageError):
    """Snapshot is being generated and not ready yet; retry later."""

    def __str__(self) -> str:
        return "snapshot is temporarily unavailable"
