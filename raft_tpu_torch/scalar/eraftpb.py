"""Wire format for raft-tpu: the TPU-native re-design of raft-rs's `eraftpb`.

This module is the Python-side equivalent of the reference's protobuf schema
(reference: proto/proto/eraftpb.proto:1-191).  It deliberately keeps the same
*field semantics* (names, meanings, zero-value defaults) so that an application
written against raft-rs can map its transport 1:1, but the in-memory
representation is plain dataclasses: the consensus core never serializes, and
the batched MultiRaft device path uses dense struct-of-arrays tensors instead
of per-message objects (see raft_tpu_torch.multiraft.sim.SimState).

Zero-valued fields mean "absent", matching proto3 semantics the reference
relies on (e.g. `vote == 0` means "voted for nobody", INVALID_ID).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional


class EntryType(enum.IntEnum):
    """reference: proto/proto/eraftpb.proto:7-11"""

    EntryNormal = 0
    EntryConfChange = 1
    EntryConfChangeV2 = 2


class MessageType(enum.IntEnum):
    """The 19 raft message types (reference: proto/proto/eraftpb.proto:49-69).

    MsgHup/MsgBeat/MsgUnreachable/MsgSnapStatus/MsgCheckQuorum are local
    messages that never travel the network (reference: raw_node.rs:57-66).
    """

    MsgHup = 0
    MsgBeat = 1
    MsgPropose = 2
    MsgAppend = 3
    MsgAppendResponse = 4
    MsgRequestVote = 5
    MsgRequestVoteResponse = 6
    MsgSnapshot = 7
    MsgHeartbeat = 8
    MsgHeartbeatResponse = 9
    MsgUnreachable = 10
    MsgSnapStatus = 11
    MsgCheckQuorum = 12
    MsgTransferLeader = 13
    MsgTimeoutNow = 14
    MsgReadIndex = 15
    MsgReadIndexResp = 16
    MsgRequestPreVote = 17
    MsgRequestPreVoteResponse = 18


class ConfChangeTransition(enum.IntEnum):
    """reference: proto/proto/eraftpb.proto:100-116"""

    Auto = 0
    Implicit = 1
    Explicit = 2


class ConfChangeType(enum.IntEnum):
    """reference: proto/proto/eraftpb.proto:133-137"""

    AddNode = 0
    RemoveNode = 1
    AddLearnerNode = 2


@dataclass(slots=True)
class Entry:
    """A single raft log entry (reference: proto/proto/eraftpb.proto:23-33).

    `data` carries the application payload for EntryNormal, or an encoded
    ConfChange/ConfChangeV2 for the conf-change entry types.  `context` is an
    opaque application blob.
    """

    entry_type: EntryType = EntryType.EntryNormal
    term: int = 0
    index: int = 0
    data: bytes = b""
    context: bytes = b""
    sync_log: bool = False  # deprecated; kept for wire parity

    def compute_size(self) -> int:
        """Approximate byte size used for max_size_per_msg accounting.

        The reference uses protobuf's computed size (util.rs:161-179 adds a
        12-byte overhead estimate per entry on top of payload lengths); we use
        the same payload + fixed-overhead model so size-based batching limits
        behave equivalently.
        """
        return len(self.data) + len(self.context)


@dataclass(slots=True)
class ConfState:
    """Membership configuration (reference: proto/proto/eraftpb.proto:118-131)."""

    voters: List[int] = field(default_factory=list)
    learners: List[int] = field(default_factory=list)
    voters_outgoing: List[int] = field(default_factory=list)
    learners_next: List[int] = field(default_factory=list)
    auto_leave: bool = False

    def clone(self) -> "ConfState":
        return ConfState(
            voters=list(self.voters),
            learners=list(self.learners),
            voters_outgoing=list(self.voters_outgoing),
            learners_next=list(self.learners_next),
            auto_leave=self.auto_leave,
        )


def conf_state_eq(lhs: ConfState, rhs: ConfState) -> bool:
    """Order-insensitive ConfState equality (reference: proto/src/confstate.rs:21-40)."""
    return (
        sorted(lhs.voters) == sorted(rhs.voters)
        and sorted(lhs.learners) == sorted(rhs.learners)
        and sorted(lhs.voters_outgoing) == sorted(rhs.voters_outgoing)
        and sorted(lhs.learners_next) == sorted(rhs.learners_next)
        and lhs.auto_leave == rhs.auto_leave
    )


@dataclass(slots=True)
class SnapshotMetadata:
    """reference: proto/proto/eraftpb.proto:35-42"""

    conf_state: ConfState = field(default_factory=ConfState)
    index: int = 0
    term: int = 0


@dataclass(slots=True)
class Snapshot:
    """reference: proto/proto/eraftpb.proto:44-47"""

    data: bytes = b""
    metadata: SnapshotMetadata = field(default_factory=SnapshotMetadata)

    def is_empty(self) -> bool:
        """A snapshot is empty iff its applied index is zero (mirrors the
        reference's `Snapshot::get_metadata().index == 0` convention)."""
        return self.metadata.index == 0

    def clone(self) -> "Snapshot":
        return Snapshot(
            data=self.data,
            metadata=SnapshotMetadata(
                conf_state=self.metadata.conf_state.clone(),
                index=self.metadata.index,
                term=self.metadata.term,
            ),
        )


@dataclass(slots=True)
class Message:
    """A raft protocol message (reference: proto/proto/eraftpb.proto:71-92).

    `from` is a Python keyword, so the field is `from_` (the transport layer
    owns any renaming on the wire).
    """

    msg_type: MessageType = MessageType.MsgHup
    to: int = 0
    from_: int = 0
    term: int = 0
    log_term: int = 0
    index: int = 0
    entries: List[Entry] = field(default_factory=list)
    commit: int = 0
    commit_term: int = 0
    snapshot: Optional[Snapshot] = None
    request_snapshot: int = 0
    reject: bool = False
    reject_hint: int = 0
    context: bytes = b""
    priority: int = 0

    def get_snapshot(self) -> Snapshot:
        if self.snapshot is None:
            self.snapshot = Snapshot()
        return self.snapshot


@dataclass(slots=True)
class HardState:
    """Durable per-node state: {term, vote, commit}
    (reference: proto/proto/eraftpb.proto:94-98)."""

    term: int = 0
    vote: int = 0
    commit: int = 0

    def clone(self) -> "HardState":
        return HardState(self.term, self.vote, self.commit)


@dataclass(slots=True)
class ConfChange:
    """V1 single-step membership change (reference: proto/proto/eraftpb.proto:139-145)."""

    change_type: ConfChangeType = ConfChangeType.AddNode
    node_id: int = 0
    context: bytes = b""
    id: int = 0

    # -- ConfChangeI equivalents (reference: proto/src/confchange.rs) --

    def as_v1(self) -> Optional["ConfChange"]:
        return self

    def as_v2(self) -> "ConfChangeV2":
        return self.into_v2()

    def into_v2(self) -> "ConfChangeV2":
        return ConfChangeV2(
            transition=ConfChangeTransition.Auto,
            changes=[ConfChangeSingle(self.change_type, self.node_id)],
            context=self.context,
        )


@dataclass(slots=True)
class ConfChangeSingle:
    """reference: proto/proto/eraftpb.proto:149-152"""

    change_type: ConfChangeType = ConfChangeType.AddNode
    node_id: int = 0


@dataclass(slots=True)
class ConfChangeV2:
    """Joint-consensus-capable membership change
    (reference: proto/proto/eraftpb.proto:186-190)."""

    transition: ConfChangeTransition = ConfChangeTransition.Auto
    changes: List[ConfChangeSingle] = field(default_factory=list)
    context: bytes = b""

    def as_v1(self) -> Optional[ConfChange]:
        return None

    def as_v2(self) -> "ConfChangeV2":
        return self

    def into_v2(self) -> "ConfChangeV2":
        return self

    def enter_joint(self) -> Optional[bool]:
        """Whether this change should use joint consensus, and if so whether
        it auto-leaves.  Returns None when the simple protocol applies.

        Mirrors the reference's `ConfChangeV2::enter_joint`
        (proto/src/lib.rs): joint consensus is used if there is more than one
        change, or if the transition is explicitly requested (Implicit /
        Explicit on a non-simple change set).
        """
        if (
            self.transition != ConfChangeTransition.Auto
            or len(self.changes) > 1
        ):
            if self.transition in (
                ConfChangeTransition.Auto,
                ConfChangeTransition.Implicit,
            ):
                return True  # auto_leave
            return False
        return None

    def leave_joint(self) -> bool:
        """An empty Auto-transition V2 change is the "leave joint" signal."""
        return self.transition == ConfChangeTransition.Auto and not self.changes


# --- conf-change entry codec ---------------------------------------------
#
# The reference stores protobuf-encoded ConfChange/ConfChangeV2 in
# Entry.data (reference: raft.rs:1995-2012 decodes them in step_leader).
# We use a compact deterministic binary format with the same crucial
# property: a default (empty) ConfChangeV2 encodes to b"", so the
# auto-leave entry appended by commit_apply has zero payload size and can
# never be refused by the uncommitted-size limiter
# (reference: raft.rs:926-935).

import struct as _struct


def encode_conf_change(cc: ConfChange) -> bytes:
    return _struct.pack("<BQQ", int(cc.change_type), cc.node_id, cc.id) + cc.context


def decode_conf_change(data: bytes) -> ConfChange:
    if not data:
        return ConfChange()
    if len(data) < 17:
        raise ValueError("truncated ConfChange")
    change_type, node_id, id = _struct.unpack_from("<BQQ", data, 0)
    return ConfChange(
        change_type=ConfChangeType(change_type),
        node_id=node_id,
        id=id,
        context=data[17:],
    )


def encode_conf_change_v2(cc: ConfChangeV2) -> bytes:
    if (
        cc.transition == ConfChangeTransition.Auto
        and not cc.changes
        and not cc.context
    ):
        return b""
    out = _struct.pack("<BH", int(cc.transition), len(cc.changes))
    for c in cc.changes:
        out += _struct.pack("<BQ", int(c.change_type), c.node_id)
    return out + cc.context


def decode_conf_change_v2(data: bytes) -> ConfChangeV2:
    if not data:
        return ConfChangeV2()
    if len(data) < 3:
        raise ValueError("truncated ConfChangeV2")
    transition, n = _struct.unpack_from("<BH", data, 0)
    off = 3
    changes = []
    for _ in range(n):
        if len(data) < off + 9:
            raise ValueError("truncated ConfChangeV2 changes")
        ct, node_id = _struct.unpack_from("<BQ", data, off)
        changes.append(ConfChangeSingle(ConfChangeType(ct), node_id))
        off += 9
    return ConfChangeV2(
        transition=ConfChangeTransition(transition),
        changes=changes,
        context=data[off:],
    )
