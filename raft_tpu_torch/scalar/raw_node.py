"""RawNode: the event-loop facade over the raft state machine
(reference: src/raw_node.rs).

Implements the Ready protocol: the application calls tick()/step()/propose(),
harvests a `Ready` when has_ready(), performs I/O in the documented order
(send messages -> apply snapshot -> apply committed entries -> append entries
-> persist HardState -> send persisted messages), then advance()s.  Readys are
numbered and their persistence effects applied in order via ReadyRecords,
enabling the async variant (advance_append_async + on_persist_ready) that
decouples fsync from the state machine — the precedent for the MultiRaft
driver overlapping device steps with host persistence.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple, Union

from .config import Config
from .errors import RaftError, StepLocalMsg, StepPeerNotFound
from .eraftpb import (
    ConfChange,
    ConfChangeV2,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    encode_conf_change,
    encode_conf_change_v2,
)
from .raft import Raft, SoftState, StateRole
from .read_only import ReadState
from .status import Status
from .storage import Storage


@dataclass
class Peer:
    """A peer in the cluster (reference: raw_node.rs:39-45)."""

    id: int = 0
    context: Optional[bytes] = None


class SnapshotStatus:
    """reference: raw_node.rs:48-54"""

    Finish = 0
    Failure = 1


def is_local_msg(t: MessageType) -> bool:
    """Message types that never travel the network
    (reference: raw_node.rs:57-66)."""
    return t in (
        MessageType.MsgHup,
        MessageType.MsgBeat,
        MessageType.MsgUnreachable,
        MessageType.MsgSnapStatus,
        MessageType.MsgCheckQuorum,
    )


def is_response_msg(t: MessageType) -> bool:
    """reference: raw_node.rs:68-77"""
    return t in (
        MessageType.MsgAppendResponse,
        MessageType.MsgRequestVoteResponse,
        MessageType.MsgHeartbeatResponse,
        MessageType.MsgUnreachable,
        MessageType.MsgRequestPreVoteResponse,
    )


@dataclass
class LightReady:
    """Commit index + committed entries + messages that become valid after
    the previous Ready is persisted (reference: raw_node.rs:242-282)."""

    commit_index: Optional[int] = None
    committed_entries: List[Entry] = field(default_factory=list)
    messages: List[Message] = field(default_factory=list)

    def take_committed_entries(self) -> List[Entry]:
        ents, self.committed_entries = self.committed_entries, []
        return ents

    def take_messages(self) -> List[Message]:
        msgs, self.messages = self.messages, []
        return msgs


@dataclass
class Ready:
    """The outstanding work the application must handle
    (reference: raw_node.rs:88-227)."""

    number: int = 0
    ss: Optional[SoftState] = None
    hs: Optional[HardState] = None
    read_states: List[ReadState] = field(default_factory=list)
    entries: List[Entry] = field(default_factory=list)
    snapshot: Snapshot = field(default_factory=Snapshot)
    is_persisted_msg: bool = False
    light: LightReady = field(default_factory=LightReady)
    # must_sync is False iff (no HardState change beyond commit) and (no
    # entries or snapshot); False permits async HardState writes
    # (reference: raw_node.rs:218-227).
    must_sync: bool = False

    def committed_entries(self) -> List[Entry]:
        return self.light.committed_entries

    def take_committed_entries(self) -> List[Entry]:
        return self.light.take_committed_entries()

    def messages(self) -> List[Message]:
        """Messages sendable immediately (leader pipelining, thesis 10.2.1)."""
        return [] if self.is_persisted_msg else self.light.messages

    def take_messages(self) -> List[Message]:
        return [] if self.is_persisted_msg else self.light.take_messages()

    def persisted_messages(self) -> List[Message]:
        """Messages to send only AFTER persisting hs/entries/snapshot."""
        return self.light.messages if self.is_persisted_msg else []

    def take_persisted_messages(self) -> List[Message]:
        return self.light.take_messages() if self.is_persisted_msg else []

    def take_read_states(self) -> List[ReadState]:
        rs, self.read_states = self.read_states, []
        return rs

    def take_entries(self) -> List[Entry]:
        ents, self.entries = self.entries, []
        return ents


@dataclass
class ReadyRecord:
    """Persistence bookkeeping for one numbered Ready
    (reference: raw_node.rs:231-237)."""

    number: int
    last_entry: Optional[Tuple[int, int]] = None  # (index, term)
    snapshot: Optional[Tuple[int, int]] = None  # (index, term)


class RawNode:
    """Thread-unsafe node facade (reference: raw_node.rs:287-761)."""

    def __init__(self, config: Config, store: Storage):
        """reference: raw_node.rs:302-321"""
        assert config.id != 0, "config.id must not be zero"
        self.raft = Raft(config, store)
        self.prev_ss = SoftState()
        self.prev_hs = HardState()
        self.max_number = 0
        self.records: Deque[ReadyRecord] = deque()
        self.commit_since_index = config.applied
        self.prev_hs = self.raft.hard_state()
        self.prev_ss = self.raft.soft_state()

    def set_priority(self, priority: int) -> None:
        self.raft.set_priority(priority)

    def tick(self) -> bool:
        """Advance the logical clock one tick (reference: raw_node.rs:342-344)."""
        return self.raft.tick()

    def campaign(self) -> None:
        """reference: raw_node.rs:347-351"""
        self.raft.step(Message(msg_type=MessageType.MsgHup))

    def propose(self, context: bytes, data: bytes) -> None:
        """Propose appending data to the log (reference: raw_node.rs:354-363)."""
        m = Message(
            msg_type=MessageType.MsgPropose,
            from_=self.raft.id,
            entries=[Entry(data=data, context=context)],
        )
        self.raft.step(m)

    def ping(self) -> None:
        self.raft.ping()

    def propose_conf_change(
        self, context: bytes, cc: Union[ConfChange, ConfChangeV2]
    ) -> None:
        """Propose a config change; with auto_leave the caller must still
        propose the empty change to exit joint state
        (reference: raw_node.rs:378-392)."""
        if cc.as_v1() is not None:
            data = encode_conf_change(cc)  # type: ignore[arg-type]
            ty = EntryType.EntryConfChange
        else:
            data = encode_conf_change_v2(cc.as_v2())
            ty = EntryType.EntryConfChangeV2
        m = Message(
            msg_type=MessageType.MsgPropose,
            entries=[Entry(entry_type=ty, data=data, context=context)],
        )
        self.raft.step(m)

    def apply_conf_change(
        self, cc: Union[ConfChange, ConfChangeV2]
    ) -> ConfState:
        """reference: raw_node.rs:397-399"""
        return self.raft.apply_conf_change(cc.as_v2())

    def step(self, m: Message) -> None:
        """Feed an inbound network message (reference: raw_node.rs:402-411)."""
        if is_local_msg(m.msg_type):
            raise StepLocalMsg()
        if self.raft.prs.get(m.from_) is not None or not is_response_msg(m.msg_type):
            return self.raft.step(m)
        raise StepPeerNotFound()

    def _gen_light_ready(self) -> LightReady:
        """reference: raw_node.rs:414-434"""
        rd = LightReady()
        max_size = self.raft.max_committed_size_per_ready
        ents = self.raft.raft_log.next_entries_since(
            self.commit_since_index, max_size
        )
        rd.committed_entries = ents if ents is not None else []
        self.raft.reduce_uncommitted_size(rd.committed_entries)
        if rd.committed_entries:
            last = rd.committed_entries[-1]
            assert self.commit_since_index < last.index
            self.commit_since_index = last.index
        if self.raft.msgs:
            rd.messages, self.raft.msgs = self.raft.msgs, []
        return rd

    def ready(self) -> Ready:
        """Harvest the pending work; MUST be fully handled then passed back
        via advance (reference: raw_node.rs:444-516)."""
        raft = self.raft

        self.max_number += 1
        rd = Ready(number=self.max_number)
        rd_record = ReadyRecord(number=self.max_number)

        if (
            self.prev_ss.raft_state != StateRole.Leader
            and raft.state == StateRole.Leader
        ):
            # Becoming leader implies everything before was persisted (the
            # vote that elected us was sent post-persist), and candidate
            # records can't carry entries/snapshots.
            for record in self.records:
                assert record.last_entry is None
                assert record.snapshot is None
            self.records.clear()

        ss = raft.soft_state()
        if ss != self.prev_ss:
            rd.ss = ss
        hs = raft.hard_state()
        if hs != self.prev_hs:
            if hs.vote != self.prev_hs.vote or hs.term != self.prev_hs.term:
                rd.must_sync = True
            rd.hs = hs

        if raft.read_states:
            rd.read_states, raft.read_states = raft.read_states, []

        snapshot = raft.raft_log.unstable_snapshot()
        if snapshot is not None:
            rd.snapshot = snapshot.clone()
            assert self.commit_since_index <= rd.snapshot.metadata.index
            self.commit_since_index = rd.snapshot.metadata.index
            # A pending snapshot implies no committed entries after it.
            assert not raft.raft_log.has_next_entries_since(
                self.commit_since_index
            ), f"has snapshot but also has committed entries since {self.commit_since_index}"
            rd_record.snapshot = (
                rd.snapshot.metadata.index,
                rd.snapshot.metadata.term,
            )
            rd.must_sync = True

        rd.entries = list(raft.raft_log.unstable_entries())
        if rd.entries:
            e = rd.entries[-1]
            rd.must_sync = True
            rd_record.last_entry = (e.index, e.term)

        # Leaders pipeline: their messages don't wait for persistence
        # (thesis 10.2.1; reference: raw_node.rs:510-512).
        rd.is_persisted_msg = raft.state != StateRole.Leader
        rd.light = self._gen_light_ready()
        self.records.append(rd_record)
        if raft.metrics is not None:
            raft.metrics.on_ready(rd.must_sync)
        return rd

    def has_ready(self) -> bool:
        """reference: raw_node.rs:519-552"""
        raft = self.raft
        if raft.msgs:
            return True
        if raft.soft_state() != self.prev_ss:
            return True
        if raft.hard_state() != self.prev_hs:
            return True
        if raft.read_states:
            return True
        if raft.raft_log.unstable_entries():
            return True
        snap = self.snap()
        if snap is not None and not snap.is_empty():
            return True
        if raft.raft_log.has_next_entries_since(self.commit_since_index):
            return True
        return False

    def _commit_ready(self, rd: Ready) -> None:
        """reference: raw_node.rs:554-570"""
        if self.raft.metrics is not None:
            self.raft.metrics.on_advance()
        if rd.ss is not None:
            self.prev_ss = rd.ss
        if rd.hs is not None:
            self.prev_hs = rd.hs
        rd_record = self.records[-1]
        assert rd_record.number == rd.number
        raft = self.raft
        if rd_record.snapshot is not None:
            raft.raft_log.stable_snap(rd_record.snapshot[0])
        if rd_record.last_entry is not None:
            index, term = rd_record.last_entry
            raft.raft_log.stable_entries(index, term)

    def _commit_apply(self, applied: int) -> None:
        self.raft.commit_apply(applied)

    def on_persist_ready(self, number: int) -> None:
        """All readies numbered <= `number` are persisted
        (reference: raw_node.rs:583-609)."""
        index, term = 0, 0
        snap_index = 0
        while self.records:
            record = self.records[0]
            if record.number > number:
                break
            self.records.popleft()
            if record.snapshot is not None:
                snap_index = record.snapshot[0]
                index, term = 0, 0
            if record.last_entry is not None:
                index, term = record.last_entry
        if snap_index != 0:
            self.raft.on_persist_snap(snap_index)
        if index != 0:
            self.raft.on_persist_entries(index, term)

    def advance(self, rd: Ready) -> LightReady:
        """Advance after fully processing `rd` (persist + apply + send)
        (reference: raw_node.rs:620-625)."""
        applied = self.commit_since_index
        light_rd = self.advance_append(rd)
        self.advance_apply_to(applied)
        return light_rd

    def advance_append(self, rd: Ready) -> LightReady:
        """Advance without applying; implies everything so far is persisted
        (reference: raw_node.rs:635-653)."""
        self._commit_ready(rd)
        self.on_persist_ready(self.max_number)
        light_rd = self._gen_light_ready()
        if self.raft.state != StateRole.Leader and light_rd.messages:
            raise AssertionError("not leader but has new msg after advance")
        hard_state = self.raft.hard_state()
        if hard_state.commit > self.prev_hs.commit:
            light_rd.commit_index = hard_state.commit
            self.prev_hs.commit = hard_state.commit
        else:
            assert hard_state.commit == self.prev_hs.commit
            light_rd.commit_index = None
        assert hard_state == self.prev_hs, "hard state != prev_hs"
        return light_rd

    def advance_append_async(self, rd: Ready) -> None:
        """Cache-only advance; call on_persist_ready when fsync completes
        (reference: raw_node.rs:663-665)."""
        self._commit_ready(rd)

    def advance_apply(self) -> None:
        """reference: raw_node.rs:669-671"""
        self._commit_apply(self.commit_since_index)

    def advance_apply_to(self, applied: int) -> None:
        """reference: raw_node.rs:675-677"""
        self._commit_apply(applied)

    def snap(self) -> Optional[Snapshot]:
        return self.raft.snap()

    def status(self) -> Status:
        """reference: raw_node.rs:687-689"""
        return Status.new(self.raft)

    def report_unreachable(self, id: int) -> None:
        """reference: raw_node.rs:692-698"""
        try:
            self.raft.step(Message(msg_type=MessageType.MsgUnreachable, from_=id))
        except RaftError:
            pass

    def report_snapshot(self, id: int, status: int) -> None:
        """reference: raw_node.rs:701-709"""
        rej = status == SnapshotStatus.Failure
        try:
            self.raft.step(
                Message(msg_type=MessageType.MsgSnapStatus, from_=id, reject=rej)
            )
        except RaftError:
            pass

    def request_snapshot(self, request_index: int) -> None:
        """reference: raw_node.rs:713-715"""
        self.raft.request_snapshot(request_index)

    def transfer_leader(self, transferee: int) -> None:
        """reference: raw_node.rs:718-723"""
        try:
            self.raft.step(
                Message(msg_type=MessageType.MsgTransferLeader, from_=transferee)
            )
        except RaftError:
            pass

    def read_index(self, rctx: bytes) -> None:
        """Request a linearizable read state (reference: raw_node.rs:729-736)."""
        try:
            self.raft.step(
                Message(
                    msg_type=MessageType.MsgReadIndex,
                    entries=[Entry(data=rctx)],
                )
            )
        except RaftError:
            pass

    @property
    def store(self) -> Storage:
        return self.raft.store

    def skip_bcast_commit(self, skip: bool) -> None:
        self.raft.set_skip_bcast_commit(skip)

    def set_batch_append(self, batch_append: bool) -> None:
        self.raft.set_batch_append(batch_append)
