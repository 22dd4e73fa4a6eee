"""The raft consensus state machine (reference: src/raft.rs).

This is the scalar per-group core: roles and elections (with pre-vote,
priority, and check-quorum leases), log replication with flow control,
snapshot send/receive, joint-consensus hooks, leader transfer (thesis 3.10),
uncommitted-size backpressure, batched appends, fast log-rejection probing,
follower-requested snapshots, and commit-by-vote fast-forward.

It is deliberately a pure function of (state, message) — no clock, no I/O,
no randomness other than the injected counter-based timeout PRNG — which is
what makes it usable as the bit-exact parity oracle for the batched TPU path
(raft_tpu_torch.multiraft): same message schedule in, identical commit indices out.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from .config import Config
from .confchange import Changer, joint as conf_is_joint, restore as confchange_restore
from .errors import ProposalDropped, RaftError, RequestSnapshotDropped, SnapshotTemporarilyUnavailable, StorageError
from .eraftpb import (
    ConfChangeV2,
    ConfState,
    Entry,
    EntryType,
    HardState,
    Message,
    MessageType,
    Snapshot,
    conf_state_eq,
    decode_conf_change,
    decode_conf_change_v2,
)
from .quorum import VoteResult
from .raft_log import RaftLog
from .read_only import ReadOnly, ReadOnlyOption, ReadState
from .storage import Storage
from .tracker import ProgressState, ProgressTracker
from .util import NO_LIMIT, deterministic_timeout, is_continuous_ents

logger = logging.getLogger("raft_tpu_torch")

# Campaign types (reference: raft.rs:48-57).
CAMPAIGN_PRE_ELECTION = b"CampaignPreElection"
CAMPAIGN_ELECTION = b"CampaignElection"
CAMPAIGN_TRANSFER = b"CampaignTransfer"

INVALID_ID = 0
INVALID_INDEX = 0


class StateRole:
    """The role of the node (reference: raft.rs:61-70).  Plain int codes so
    the MultiRaft path mirrors them as a uint8 array."""

    Follower = 0
    Candidate = 1
    Leader = 2
    PreCandidate = 3

    _NAMES = {0: "Follower", 1: "Candidate", 2: "Leader", 3: "PreCandidate"}

    @classmethod
    def name(cls, v: int) -> str:
        return cls._NAMES[v]


@dataclass
class SoftState:
    """Volatile state useful for logging/UX (reference: raft.rs:86-91)."""

    leader_id: int = INVALID_ID
    raft_state: int = StateRole.Follower


class UncommittedState:
    """Uncommitted-proposal byte accounting on the leader
    (reference: raft.rs:95-157)."""

    __slots__ = ("max_uncommitted_size", "uncommitted_size", "last_log_tail_index")

    def __init__(self, max_uncommitted_size: int):
        self.max_uncommitted_size = max_uncommitted_size
        self.uncommitted_size = 0
        self.last_log_tail_index = 0

    def is_no_limit(self) -> bool:
        return self.max_uncommitted_size == NO_LIMIT

    def maybe_increase_uncommitted_size(self, ents: Sequence[Entry]) -> bool:
        """reference: raft.rs:114-134"""
        if self.is_no_limit():
            return True
        size = sum(len(e.data) for e in ents)
        # Never drop zero-size entries (elections, auto-leave), always allow
        # at least one uncommitted entry.
        if (
            size == 0
            or self.uncommitted_size == 0
            or size + self.uncommitted_size <= self.max_uncommitted_size
        ):
            self.uncommitted_size += size
            return True
        return False

    def maybe_reduce_uncommitted_size(self, ents: Sequence[Entry]) -> bool:
        """reference: raft.rs:136-156"""
        if self.is_no_limit() or not ents:
            return True
        # Entries from before this node became leader don't count.
        size = sum(
            len(e.data) for e in ents if e.index > self.last_log_tail_index
        )
        if size > self.uncommitted_size:
            self.uncommitted_size = 0
            return False
        self.uncommitted_size -= size
        return True


def new_message(to: int, msg_type: MessageType, from_: Optional[int] = None) -> Message:
    """reference: raft.rs:296-304"""
    m = Message(msg_type=msg_type, to=to)
    if from_ is not None:
        m.from_ = from_
    return m


def vote_resp_msg_type(t: MessageType) -> MessageType:
    """reference: raft.rs:307-313"""
    if t == MessageType.MsgRequestVote:
        return MessageType.MsgRequestVoteResponse
    if t == MessageType.MsgRequestPreVote:
        return MessageType.MsgRequestPreVoteResponse
    raise ValueError(f"Not a vote message: {t!r}")


class Raft:
    """The raft consensus state machine (reference: raft.rs:163-294 for the
    field inventory; one class here instead of the Raft/RaftCore split, which
    only exists to appease the Rust borrow checker)."""

    def __init__(self, c: Config, store: Storage):
        """reference: raft.rs:318-400"""
        c.validate()
        raft_state = store.initial_state()
        conf_state = raft_state.conf_state

        self.id = c.id
        self.term = 0
        self.vote = INVALID_ID
        self.read_states: List[ReadState] = []
        self.raft_log = RaftLog(store)
        self.max_inflight = c.max_inflight_msgs
        self.max_msg_size = c.max_size_per_msg
        self.pending_request_snapshot = INVALID_INDEX
        self.state = StateRole.Follower
        self.promotable = False
        self.leader_id = INVALID_ID
        self.lead_transferee: Optional[int] = None
        self.pending_conf_index = 0
        self.read_only = ReadOnly(c.read_only_option)
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self.check_quorum = c.check_quorum
        self.pre_vote = c.pre_vote
        self.skip_bcast_commit = c.skip_bcast_commit
        self.batch_append = c.batch_append
        self.heartbeat_timeout = c.heartbeat_tick
        self.election_timeout = c.election_tick
        self.randomized_election_timeout = 0
        self.min_election_timeout = c.min_election_tick_or_default()
        self.max_election_timeout = c.max_election_tick_or_default()
        self.priority = c.priority
        self.uncommitted_state = UncommittedState(c.max_uncommitted_size)
        self.max_committed_size_per_ready = c.max_committed_size_per_ready
        # Counter-based timeout PRNG key (see util.deterministic_timeout).
        self._timeout_key = c.timeout_seed * (1 << 16) + c.id
        # Observability hook (Config.metrics) or None; every hook
        # below is guarded by one `is not None` branch so the disabled path
        # stays free.  timeout_seed doubles as the group tag (the MultiRaft
        # driver's per-group convention).
        self.metrics = c.metrics
        self._group = c.timeout_seed
        if self.metrics is not None:
            self.raft_log.on_commit_advance = self._on_commit_advance

        self.prs = ProgressTracker(c.max_inflight_msgs)
        self.msgs: List[Message] = []

        confchange_restore(self.prs, self.raft_log.last_index(), conf_state)
        new_cs = self.post_conf_change()
        if not conf_state_eq(new_cs, conf_state):
            raise AssertionError(f"invalid restore: {conf_state} != {new_cs}")

        if raft_state.hard_state != HardState():
            self.load_state(raft_state.hard_state)
        if c.applied > 0:
            self.commit_apply(c.applied)
        self.become_follower(self.term, INVALID_ID)

    def _on_commit_advance(self, old: int, new: int) -> None:
        """RaftLog.commit_to observability callback (metrics enabled only)."""
        # graftcheck: allow-metrics-guarded — the hook is registered in
        # __init__ only when metrics is not None, so the callback cannot
        # fire on the disabled path; re-checking here would add the very
        # branch the invariant exists to avoid.
        self.metrics.on_commit_advance(self._group, self.id, self.term, old, new)

    # --- accessors (reference: raft.rs:402-598) ---

    @property
    def store(self) -> Storage:
        return self.raft_log.store

    def snap(self) -> Optional[Snapshot]:
        return self.raft_log.unstable.snapshot

    def pending_read_count(self) -> int:
        return self.read_only.pending_read_count()

    def ready_read_count(self) -> int:
        return len(self.read_states)

    def soft_state(self) -> SoftState:
        return SoftState(leader_id=self.leader_id, raft_state=self.state)

    def hard_state(self) -> HardState:
        return HardState(
            term=self.term, vote=self.vote, commit=self.raft_log.committed
        )

    def in_lease(self) -> bool:
        """reference: raft.rs:464-466"""
        return self.state == StateRole.Leader and self.check_quorum

    def set_priority(self, priority: int) -> None:
        self.priority = priority

    def set_randomized_election_timeout(self, t: int) -> None:
        """Test hook pinning the randomized timeout (reference: raft.rs:470-473)."""
        assert self.min_election_timeout <= t < self.max_election_timeout
        self.randomized_election_timeout = t

    def set_skip_bcast_commit(self, skip: bool) -> None:
        self.skip_bcast_commit = skip

    def set_batch_append(self, batch_append: bool) -> None:
        self.batch_append = batch_append

    def set_max_committed_size_per_ready(self, size: int) -> None:
        self.max_committed_size_per_ready = size

    # --- group commit (reference: raft.rs:507-576) ---

    def enable_group_commit(self, enable: bool) -> None:
        self.prs.enable_group_commit(enable)
        if self.state == StateRole.Leader and not enable and self.maybe_commit():
            self.bcast_append()

    def group_commit(self) -> bool:
        return self.prs.group_commit()

    def assign_commit_groups(self, ids: Sequence[Tuple[int, int]]) -> None:
        for peer_id, group_id in ids:
            assert group_id > 0
            pr = self.prs.get_mut(peer_id)
            if pr is not None:
                pr.commit_group_id = group_id
        if (
            self.state == StateRole.Leader
            and self.group_commit()
            and self.maybe_commit()
        ):
            self.bcast_append()

    def clear_commit_group(self) -> None:
        for _, pr in self.prs.iter_mut():
            pr.commit_group_id = 0

    def check_group_commit_consistent(self) -> Optional[bool]:
        """reference: raft.rs:557-576"""
        if self.state != StateRole.Leader:
            return None
        if not self.apply_to_current_term():
            return None
        index, use_group_commit = self.prs.maximal_committed_index()
        return use_group_commit and index == self.raft_log.committed

    def commit_to_current_term(self) -> bool:
        """reference: raft.rs:581-585"""
        return self.raft_log.term_or(self.raft_log.committed) == self.term

    def apply_to_current_term(self) -> bool:
        """reference: raft.rs:588-592"""
        return self.raft_log.term_or(self.raft_log.applied) == self.term

    # --- message sending (reference: raft.rs:600-845) ---

    def send(self, m: Message) -> None:
        """Stamp the term per message-type rules and queue for the transport
        (reference: raft.rs:602-662)."""
        if m.from_ == INVALID_ID:
            m.from_ = self.id
        if m.msg_type in (
            MessageType.MsgRequestVote,
            MessageType.MsgRequestPreVote,
            MessageType.MsgRequestVoteResponse,
            MessageType.MsgRequestPreVoteResponse,
        ):
            # Campaign messages carry an explicit term: possibly a future one
            # for pre-vote rounds.
            if m.term == 0:
                raise AssertionError(
                    f"term should be set when sending {m.msg_type!r}"
                )
        else:
            if m.term != 0:
                raise AssertionError(
                    f"term should not be set when sending {m.msg_type!r} "
                    f"(was {m.term})"
                )
            # MsgPropose / MsgReadIndex are forwarded to the leader and act
            # as local messages — never stamp a term on them.
            if m.msg_type not in (
                MessageType.MsgPropose,
                MessageType.MsgReadIndex,
            ):
                m.term = self.term
        if m.msg_type in (
            MessageType.MsgRequestVote,
            MessageType.MsgRequestPreVote,
        ):
            m.priority = self.priority
        if self.metrics is not None:
            self.metrics.on_send(m.msg_type)
        self.msgs.append(m)

    def _prepare_send_snapshot(self, m: Message, pr, to: int) -> bool:
        """reference: raft.rs:664-712"""
        if not pr.recent_active:
            return False
        m.msg_type = MessageType.MsgSnapshot
        try:
            snapshot = self.raft_log.snapshot(pr.pending_request_snapshot)
        except SnapshotTemporarilyUnavailable:
            return False
        if snapshot.metadata.index == 0:
            raise AssertionError("need non-empty snapshot")
        m.snapshot = snapshot
        pr.become_snapshot(snapshot.metadata.index)
        if self.metrics is not None:
            self.metrics.on_snapshot_sent(
                self._group, self.id, to, snapshot.metadata.index
            )
        return True

    def _prepare_send_entries(
        self, m: Message, pr, term: int, ents: List[Entry]
    ) -> None:
        """reference: raft.rs:714-730"""
        m.msg_type = MessageType.MsgAppend
        m.index = pr.next_idx - 1
        m.log_term = term
        m.entries = ents
        m.commit = self.raft_log.committed
        if m.entries:
            pr.update_state(m.entries[-1].index)

    def _try_batching(self, to: int, pr, ents: List[Entry]) -> bool:
        """Coalesce into an existing queued MsgAppend for the same peer
        (reference: raft.rs:732-760)."""
        for msg in self.msgs:
            if msg.msg_type == MessageType.MsgAppend and msg.to == to:
                if ents:
                    if not is_continuous_ents(msg.entries, ents):
                        return False
                    msg.entries = msg.entries + ents
                    pr.update_state(msg.entries[-1].index)
                msg.commit = self.raft_log.committed
                return True
        return False

    def send_append(self, to: int) -> None:
        """reference: raft.rs:764-766, 850-853"""
        pr = self.prs.get_mut(to)
        if pr is not None:
            self._maybe_send_append(to, pr, allow_empty=True)

    def _maybe_send_append(self, to: int, pr, allow_empty: bool) -> bool:
        """reference: raft.rs:773-819"""
        if pr.is_paused():
            return False
        m = Message(to=to)
        if pr.pending_request_snapshot != INVALID_INDEX:
            # The follower explicitly asked for a snapshot.
            if not self._prepare_send_snapshot(m, pr, to):
                return False
        else:
            try:
                ents: Optional[List[Entry]] = self.raft_log.entries(
                    pr.next_idx, self.max_msg_size
                )
            except StorageError:
                ents = None
            if not allow_empty and not ents:
                return False
            try:
                term: Optional[int] = self.raft_log.term(pr.next_idx - 1)
            except StorageError:
                term = None
            if term is not None and ents is not None:
                if self.batch_append and self._try_batching(to, pr, ents):
                    return True
                self._prepare_send_entries(m, pr, term, ents)
            else:
                # Entries compacted away: fall back to a snapshot.
                if not self._prepare_send_snapshot(m, pr, to):
                    return False
        self.send(m)
        return True

    def _send_heartbeat(self, to: int, pr, ctx: Optional[bytes]) -> None:
        """reference: raft.rs:822-844; commit is clamped to min(matched,
        committed) so an unmatched follower never learns a commit index it
        doesn't have."""
        m = Message(to=to, msg_type=MessageType.MsgHeartbeat)
        m.commit = min(pr.matched, self.raft_log.committed)
        if ctx is not None:
            m.context = ctx
        self.send(m)

    def bcast_append(self) -> None:
        """reference: raft.rs:857-865"""
        for id, pr in self.prs.iter_mut():
            if id == self.id:
                continue
            self._maybe_send_append(id, pr, allow_empty=True)

    def ping(self) -> None:
        """reference: raft.rs:868-872"""
        if self.state == StateRole.Leader:
            self.bcast_heartbeat()

    def bcast_heartbeat(self) -> None:
        """reference: raft.rs:875-878"""
        self._bcast_heartbeat_with_ctx(self.read_only.last_pending_request_ctx())

    def _bcast_heartbeat_with_ctx(self, ctx: Optional[bytes]) -> None:
        for id, pr in self.prs.iter_mut():
            if id == self.id:
                continue
            self._send_heartbeat(id, pr, ctx)

    # --- commit machinery (reference: raft.rs:891-939) ---

    def maybe_commit(self) -> bool:
        """Advance the commit index from the quorum of matched indexes; the
        caller broadcasts on True (reference: raft.rs:893-904)."""
        mci, _ = self.prs.maximal_committed_index()
        if self.raft_log.maybe_commit(mci, self.term):
            pr = self.prs.get_mut(self.id)
            if pr is not None:
                pr.update_committed(self.raft_log.committed)
            return True
        return False

    def commit_apply(self, applied: int) -> None:
        """Register the applied index; post-hook auto-leaves a joint config
        (reference: raft.rs:913-939)."""
        old_applied = self.raft_log.applied
        self.raft_log.applied_to(applied)

        if (
            self.prs.conf.auto_leave
            and old_applied <= self.pending_conf_index
            and applied >= self.pending_conf_index
            and self.state == StateRole.Leader
        ):
            # Propose the empty ConfChangeV2 that exits the joint config;
            # empty data can never be refused by the size limiter.
            entry = Entry(entry_type=EntryType.EntryConfChangeV2)
            if not self.append_entry([entry]):
                raise AssertionError(
                    "appending an empty EntryConfChangeV2 should never be dropped"
                )
            self.pending_conf_index = self.raft_log.last_index()

    def reset(self, term: int) -> None:
        """reference: raft.rs:942-971"""
        if self.term != term:
            self.term = term
            self.vote = INVALID_ID
        self.leader_id = INVALID_ID
        self.reset_randomized_election_timeout()
        self.election_elapsed = 0
        self.heartbeat_elapsed = 0
        self.abort_leader_transfer()
        self.prs.reset_votes()
        self.pending_conf_index = 0
        self.read_only = ReadOnly(self.read_only.option)
        self.pending_request_snapshot = INVALID_INDEX

        last_index = self.raft_log.last_index()
        committed = self.raft_log.committed
        persisted = self.raft_log.persisted
        for id, pr in self.prs.iter_mut():
            pr.reset(last_index + 1)
            if id == self.id:
                pr.matched = persisted
                pr.committed_index = committed

    def append_entry(self, es: List[Entry]) -> bool:
        """Leader-side append; stamps term/index
        (reference: raft.rs:977-991)."""
        if not self.maybe_increase_uncommitted_size(es):
            return False
        li = self.raft_log.last_index()
        for i, e in enumerate(es):
            e.term = self.term
            e.index = li + 1 + i
        self.raft_log.append(es)
        # self's pr.matched is NOT updated until on_persist_entries.
        return True

    def on_persist_entries(self, index: int, term: int) -> None:
        """Async-persistence notification (reference: raft.rs:994-1016)."""
        update = self.raft_log.maybe_persist(index, term)
        if update and self.state == StateRole.Leader:
            if term != self.term:
                logger.error(
                    "leader's persisted index changed but term %s != %s",
                    term,
                    self.term,
                )
            pr = self.prs.get_mut(self.id)
            if (
                pr is not None
                and pr.maybe_update(index)
                and self.maybe_commit()
                and self.should_bcast_commit()
            ):
                self.bcast_append()

    def on_persist_snap(self, index: int) -> None:
        """reference: raft.rs:1019-1021"""
        self.raft_log.maybe_persist_snap(index)

    # --- tick (reference: raft.rs:1024-1079): THE MultiRaft hot loop ---

    def tick(self) -> bool:
        """Advance the logical clock by one tick; True if there is probably
        new readiness (reference: raft.rs:1024-1031)."""
        if self.state == StateRole.Leader:
            return self.tick_heartbeat()
        return self.tick_election()

    def tick_election(self) -> bool:
        """reference: raft.rs:1037-1047"""
        self.election_elapsed += 1
        if not self.pass_election_timeout() or not self.promotable:
            return False
        self.election_elapsed = 0
        m = new_message(INVALID_ID, MessageType.MsgHup, self.id)
        try:
            self.step(m)
        except RaftError:
            pass
        return True

    def tick_heartbeat(self) -> bool:
        """reference: raft.rs:1051-1079"""
        self.heartbeat_elapsed += 1
        self.election_elapsed += 1

        has_ready = False
        if self.election_elapsed >= self.election_timeout:
            self.election_elapsed = 0
            if self.check_quorum:
                has_ready = True
                m = new_message(INVALID_ID, MessageType.MsgCheckQuorum, self.id)
                try:
                    self.step(m)
                except RaftError:
                    pass
            if self.state == StateRole.Leader and self.lead_transferee is not None:
                self.abort_leader_transfer()

        if self.state != StateRole.Leader:
            return has_ready

        if self.heartbeat_elapsed >= self.heartbeat_timeout:
            self.heartbeat_elapsed = 0
            has_ready = True
            m = new_message(INVALID_ID, MessageType.MsgBeat, self.id)
            try:
                self.step(m)
            except RaftError:
                pass
        return has_ready

    # --- role transitions (reference: raft.rs:1082-1202) ---

    def become_follower(self, term: int, leader_id: int) -> None:
        """reference: raft.rs:1082-1093"""
        pending_request_snapshot = self.pending_request_snapshot
        self.reset(term)
        self.leader_id = leader_id
        self.state = StateRole.Follower
        self.pending_request_snapshot = pending_request_snapshot
        if self.metrics is not None:
            self.metrics.on_transition(
                self.state, self._group, self.id, self.term
            )

    def become_candidate(self) -> None:
        """reference: raft.rs:1101-1117"""
        assert self.state != StateRole.Leader, (
            "invalid transition [leader -> candidate]"
        )
        self.reset(self.term + 1)
        self.vote = self.id
        self.state = StateRole.Candidate
        if self.metrics is not None:
            self.metrics.on_transition(
                self.state, self._group, self.id, self.term
            )

    def become_pre_candidate(self) -> None:
        """Pre-candidate changes only the role: term/vote stay untouched
        (reference: raft.rs:1124-1143)."""
        assert self.state != StateRole.Leader, (
            "invalid transition [leader -> pre-candidate]"
        )
        self.state = StateRole.PreCandidate
        self.prs.reset_votes()
        self.leader_id = INVALID_ID
        if self.metrics is not None:
            self.metrics.on_transition(
                self.state, self._group, self.id, self.term
            )

    def become_leader(self) -> None:
        """reference: raft.rs:1151-1202"""
        assert self.state != StateRole.Follower, (
            "invalid transition [follower -> leader]"
        )
        self.reset(self.term)
        self.leader_id = self.id
        self.state = StateRole.Leader
        if self.metrics is not None:
            self.metrics.on_transition(
                self.state, self._group, self.id, self.term
            )
            self.metrics.on_election_won(self._group, self.id, self.term)

        last_index = self.raft_log.last_index()
        # Logs can't change while (pre)candidate and must be persisted before
        # RequestVote is sent, so last == persisted here.
        assert last_index == self.raft_log.persisted

        self.uncommitted_state.uncommitted_size = 0
        self.uncommitted_state.last_log_tail_index = last_index

        self.prs.get_mut(self.id).become_replicate()

        # Conservative: any pending conf change is at or before last_index.
        self.pending_conf_index = last_index

        if not self.append_entry([Entry()]):
            raise AssertionError("appending an empty entry should never be dropped")

    def _num_pending_conf(self, ents: Sequence[Entry]) -> int:
        """reference: raft.rs:1204-1211"""
        return sum(
            1
            for e in ents
            if e.entry_type
            in (EntryType.EntryConfChange, EntryType.EntryConfChangeV2)
        )

    _CAMPAIGN_KINDS = {
        CAMPAIGN_PRE_ELECTION: "PreElection",
        CAMPAIGN_ELECTION: "Election",
        CAMPAIGN_TRANSFER: "Transfer",
    }

    def campaign(self, campaign_type: bytes) -> None:
        """Start an election round (reference: raft.rs:1217-1263)."""
        if self.metrics is not None:
            self.metrics.on_campaign(
                self._CAMPAIGN_KINDS[campaign_type],
                self._group,
                self.id,
                self.term,
            )
        if campaign_type == CAMPAIGN_PRE_ELECTION:
            self.become_pre_candidate()
            vote_msg = MessageType.MsgRequestPreVote
            term = self.term + 1  # pre-vote for the NEXT term
        else:
            self.become_candidate()
            vote_msg = MessageType.MsgRequestVote
            term = self.term

        if VoteResult.Won == self.poll(self.id, vote_msg, True):
            # Single-node cluster: we won by voting for ourselves.
            return

        commit, commit_term = self.raft_log.commit_info()
        for id in sorted(self.prs.conf.voters.ids()):
            if id == self.id:
                continue
            m = new_message(id, vote_msg, None)
            m.term = term
            m.index = self.raft_log.last_index()
            m.log_term = self.raft_log.last_term()
            m.commit = commit
            m.commit_term = commit_term
            if campaign_type == CAMPAIGN_TRANSFER:
                m.context = campaign_type
            self.send(m)

    # --- the step function (reference: raft.rs:1280-1470) ---

    def step(self, m: Message) -> None:
        """Advance the state machine with one inbound message."""
        if self.metrics is not None:
            self.metrics.on_recv(m.msg_type)
        # Term epoch handling: may step us down to follower.
        if m.term == 0:
            pass  # local message
        elif m.term > self.term:
            if m.msg_type in (
                MessageType.MsgRequestVote,
                MessageType.MsgRequestPreVote,
            ):
                force = m.context == CAMPAIGN_TRANSFER
                in_lease = (
                    self.check_quorum
                    and self.leader_id != INVALID_ID
                    and self.election_elapsed < self.election_timeout
                )
                if not force and in_lease:
                    # Within the lease of a live leader we neither bump our
                    # term nor grant the vote (joint-consensus concern #3).
                    return

            if m.msg_type == MessageType.MsgRequestPreVote or (
                m.msg_type == MessageType.MsgRequestPreVoteResponse and not m.reject
            ):
                # Pre-vote requests never bump our term; granted pre-vote
                # responses carry our own future term.
                pass
            else:
                if m.msg_type in (
                    MessageType.MsgAppend,
                    MessageType.MsgHeartbeat,
                    MessageType.MsgSnapshot,
                ):
                    self.become_follower(m.term, m.from_)
                else:
                    self.become_follower(m.term, INVALID_ID)
        elif m.term < self.term:
            if (self.check_quorum or self.pre_vote) and m.msg_type in (
                MessageType.MsgHeartbeat,
                MessageType.MsgAppend,
            ):
                # Nudge a stale leader with a response carrying our term so
                # it steps down, without disruptive term inflation.
                self.send(new_message(m.from_, MessageType.MsgAppendResponse, None))
            elif m.msg_type == MessageType.MsgRequestPreVote:
                # Reject explicitly to avoid pre-vote deadlock after upgrade.
                to_send = new_message(
                    m.from_, MessageType.MsgRequestPreVoteResponse, None
                )
                to_send.term = self.term
                to_send.reject = True
                self.send(to_send)
            # other lower-term messages are ignored
            return

        self.before_step_hook(m)

        if m.msg_type == MessageType.MsgHup:
            self.hup(False)
        elif m.msg_type in (
            MessageType.MsgRequestVote,
            MessageType.MsgRequestPreVote,
        ):
            # We can vote if it repeats a vote we already cast, we haven't
            # voted and see no leader this term, or it's a future-term
            # PreVote...
            can_vote = (
                (self.vote == m.from_)
                or (self.vote == INVALID_ID and self.leader_id == INVALID_ID)
                or (
                    m.msg_type == MessageType.MsgRequestPreVote
                    and m.term > self.term
                )
            )
            # ...and the candidate's log is up to date, with priority gating.
            if (
                can_vote
                and self.raft_log.is_up_to_date(m.index, m.log_term)
                and (
                    m.index > self.raft_log.last_index()
                    or self.priority <= m.priority
                )
            ):
                # Respond with the MESSAGE's term (differs from ours for
                # pre-votes from partitioned-away nodes).
                to_send = new_message(m.from_, vote_resp_msg_type(m.msg_type), None)
                to_send.reject = False
                to_send.term = m.term
                self.send(to_send)
                if self.metrics is not None:
                    self.metrics.on_vote_grant(
                        m.msg_type == MessageType.MsgRequestPreVote,
                        self._group,
                        self.id,
                        self.term,
                        m.from_,
                    )
                if m.msg_type == MessageType.MsgRequestVote:
                    # Only real votes are recorded.
                    self.election_elapsed = 0
                    self.vote = m.from_
            else:
                to_send = new_message(m.from_, vote_resp_msg_type(m.msg_type), None)
                to_send.reject = True
                to_send.term = self.term
                commit, commit_term = self.raft_log.commit_info()
                to_send.commit = commit
                to_send.commit_term = commit_term
                self.send(to_send)
                self.maybe_commit_by_vote(m)
        else:
            if self.state in (StateRole.PreCandidate, StateRole.Candidate):
                self.step_candidate(m)
            elif self.state == StateRole.Follower:
                self.step_follower(m)
            else:
                self.step_leader(m)

    def before_step_hook(self, m: Message) -> None:
        """Fault-injection hook at the reference's `before_step` failpoint
        site (reference: raft.rs:1413-1414); tests monkeypatch this."""

    def hup(self, transfer_leader: bool) -> None:
        """reference: raft.rs:1472-1525"""
        if self.state == StateRole.Leader:
            return

        # A pending snapshot has already applied its configuration, so
        # campaigning is safe as long as no conf change is pending in entries.
        first_index = self.raft_log.unstable.maybe_first_index()
        if first_index is None:
            first_index = self.raft_log.applied + 1

        ents = self.raft_log.slice(first_index, self.raft_log.committed + 1, None)
        if self._num_pending_conf(ents) != 0:
            return
        if transfer_leader:
            self.campaign(CAMPAIGN_TRANSFER)
        elif self.pre_vote:
            self.campaign(CAMPAIGN_PRE_ELECTION)
        else:
            self.campaign(CAMPAIGN_ELECTION)

    # --- leader handlers (reference: raft.rs:1559-2123) ---

    def handle_append_response(self, m: Message) -> None:
        """reference: raft.rs:1559-1775 (incl. the fast-rejection probing
        described in the long comment there: probe at most once per term in
        the leader's log instead of once per index)."""
        next_probe_index = m.reject_hint
        if m.reject and m.log_term > 0:
            next_probe_index = self.raft_log.find_conflict_by_term(
                m.reject_hint, m.log_term
            )[0]

        pr = self.prs.get_mut(m.from_)
        if pr is None:
            return
        pr.recent_active = True
        pr.update_committed(m.commit)

        if m.reject:
            if pr.maybe_decr_to(m.index, next_probe_index, m.request_snapshot):
                if pr.state == ProgressState.Replicate:
                    pr.become_probe()
                self.send_append(m.from_)
            return

        old_paused = pr.is_paused()
        if not pr.maybe_update(m.index):
            return

        if pr.state == ProgressState.Probe:
            pr.become_replicate()
        elif pr.state == ProgressState.Snapshot:
            if pr.maybe_snapshot_abort():
                pr.become_probe()
        elif pr.state == ProgressState.Replicate:
            pr.ins.free_to(m.index)

        if self.maybe_commit():
            if self.should_bcast_commit():
                self.bcast_append()
        elif old_paused:
            self.send_append(m.from_)

        # Flow control may allow several size-limited sends now.
        pr = self.prs.get_mut(m.from_)
        while self._maybe_send_append(m.from_, pr, allow_empty=False):
            pass

        if m.from_ == self.lead_transferee:
            if pr.matched == self.raft_log.last_index():
                self.send_timeout_now(m.from_)

    def handle_heartbeat_response(self, m: Message) -> None:
        """reference: raft.rs:1777-1819"""
        pr = self.prs.get_mut(m.from_)
        if pr is None:
            return
        pr.update_committed(m.commit)
        pr.recent_active = True
        pr.resume()

        # Free one inflight slot so a full window can make progress.
        if pr.state == ProgressState.Replicate and pr.ins.full():
            pr.ins.free_first_one()
        if (
            pr.matched < self.raft_log.last_index()
            or pr.pending_request_snapshot != INVALID_INDEX
        ):
            self._maybe_send_append(m.from_, pr, allow_empty=True)

        if self.read_only.option != ReadOnlyOption.Safe or not m.context:
            return

        acks = self.read_only.recv_ack(m.from_, m.context)
        if acks is None or not self.prs.has_quorum(acks):
            return

        for rs in self.read_only.advance(m.context):
            resp = self.handle_ready_read_index(rs.req, rs.index)
            if resp is not None:
                self.send(resp)

    def handle_transfer_leader(self, m: Message) -> None:
        """reference: raft.rs:1821-1889"""
        if self.prs.get(m.from_) is None:
            return
        from_ = m.from_
        if from_ in self.prs.conf.learners:
            return
        lead_transferee = from_
        if self.lead_transferee is not None:
            if self.lead_transferee == lead_transferee:
                return
            self.abort_leader_transfer()
        if lead_transferee == self.id:
            return
        # Transfer should finish within one election timeout.
        self.election_elapsed = 0
        self.lead_transferee = lead_transferee
        pr = self.prs.get_mut(from_)
        if pr.matched == self.raft_log.last_index():
            self.send_timeout_now(lead_transferee)
        else:
            self._maybe_send_append(lead_transferee, pr, allow_empty=True)

    def handle_snapshot_status(self, m: Message) -> None:
        """reference: raft.rs:1891-1929"""
        pr = self.prs.get_mut(m.from_)
        if pr is None:
            return
        if pr.state != ProgressState.Snapshot:
            return
        if m.reject:
            pr.snapshot_failure()
            pr.become_probe()
        else:
            pr.become_probe()
        # Snapshot done: wait for MsgAppendResponse before the next append;
        # failed: wait out a heartbeat interval.
        pr.pause()
        pr.pending_request_snapshot = INVALID_INDEX

    def handle_unreachable(self, m: Message) -> None:
        """reference: raft.rs:1931-1954"""
        pr = self.prs.get_mut(m.from_)
        if pr is None:
            return
        # An optimistic MsgAppend was probably lost.
        if pr.state == ProgressState.Replicate:
            pr.become_probe()

    def step_leader(self, m: Message) -> None:
        """reference: raft.rs:1956-2123"""
        # Messages that need no per-peer progress:
        if m.msg_type == MessageType.MsgBeat:
            if self.metrics is not None:
                self.metrics.on_beat()
            self.bcast_heartbeat()
            return
        if m.msg_type == MessageType.MsgCheckQuorum:
            if not self.check_quorum_active():
                self.become_follower(self.term, INVALID_ID)
            return
        if m.msg_type == MessageType.MsgPropose:
            if not m.entries:
                raise AssertionError("stepped empty MsgProp")
            if self.id not in self.prs.progress:
                # We were removed from the config while leading.
                raise ProposalDropped()
            if self.lead_transferee is not None:
                raise ProposalDropped()

            for i, e in enumerate(m.entries):
                if e.entry_type == EntryType.EntryConfChange:
                    try:
                        cc = decode_conf_change(e.data).into_v2()
                    except ValueError:
                        raise ProposalDropped()
                elif e.entry_type == EntryType.EntryConfChangeV2:
                    try:
                        cc = decode_conf_change_v2(e.data)
                    except ValueError:
                        raise ProposalDropped()
                else:
                    continue

                if self.has_pending_conf():
                    reason = "possible unapplied conf change"
                else:
                    already_joint = conf_is_joint(self.prs.conf)
                    want_leave = not cc.changes
                    if already_joint and not want_leave:
                        reason = "must transition out of joint config first"
                    elif not already_joint and want_leave:
                        reason = "not in joint state; refusing empty conf change"
                    else:
                        reason = ""

                if not reason:
                    self.pending_conf_index = self.raft_log.last_index() + i + 1
                else:
                    # Elide the conf change, keeping log positions stable.
                    m.entries[i] = Entry(entry_type=EntryType.EntryNormal)

            if not self.append_entry(m.entries):
                raise ProposalDropped()  # uncommitted-size limit reached
            self.bcast_append()
            return
        if m.msg_type == MessageType.MsgReadIndex:
            if not self.commit_to_current_term():
                # No entry committed in our term yet: reject read requests.
                return
            if self.prs.is_singleton():
                resp = self.handle_ready_read_index(m, self.raft_log.committed)
                if resp is not None:
                    self.send(resp)
                return
            if self.read_only.option == ReadOnlyOption.Safe:
                ctx = bytes(m.entries[0].data)
                self.read_only.add_request(self.raft_log.committed, m, self.id)
                self._bcast_heartbeat_with_ctx(ctx)
            else:  # LeaseBased
                resp = self.handle_ready_read_index(m, self.raft_log.committed)
                if resp is not None:
                    self.send(resp)
            return

        if m.msg_type == MessageType.MsgAppendResponse:
            self.handle_append_response(m)
        elif m.msg_type == MessageType.MsgHeartbeatResponse:
            self.handle_heartbeat_response(m)
        elif m.msg_type == MessageType.MsgSnapStatus:
            self.handle_snapshot_status(m)
        elif m.msg_type == MessageType.MsgUnreachable:
            self.handle_unreachable(m)
        elif m.msg_type == MessageType.MsgTransferLeader:
            self.handle_transfer_leader(m)

    def maybe_commit_by_vote(self, m: Message) -> None:
        """Fast-forward commit from a vote message's commit info
        (reference: raft.rs:2126-2164)."""
        if m.commit == 0 or m.commit_term == 0:
            return
        last_commit = self.raft_log.committed
        if m.commit <= last_commit or self.state == StateRole.Leader:
            return
        if not self.raft_log.maybe_commit(m.commit, m.commit_term):
            return

        if self.state not in (StateRole.Candidate, StateRole.PreCandidate):
            return
        ents = self.raft_log.slice(
            last_commit + 1, self.raft_log.committed + 1, None
        )
        if self._num_pending_conf(ents) != 0:
            # Conservatively step down: the quorum may be changing.
            self.become_follower(self.term, INVALID_ID)

    def poll(self, from_: int, t: MessageType, vote: bool) -> VoteResult:
        """reference: raft.rs:2166-2201"""
        self.prs.record_vote(from_, vote)
        _, _, res = self.prs.tally_votes()
        if res == VoteResult.Won:
            if self.state == StateRole.PreCandidate:
                self.campaign(CAMPAIGN_ELECTION)
            else:
                self.become_leader()
                self.bcast_append()
        elif res == VoteResult.Lost:
            self.become_follower(self.term, INVALID_ID)
        return res

    def step_candidate(self, m: Message) -> None:
        """Shared by Candidate and PreCandidate
        (reference: raft.rs:2205-2255)."""
        if m.msg_type == MessageType.MsgPropose:
            raise ProposalDropped()
        elif m.msg_type == MessageType.MsgAppend:
            self.become_follower(m.term, m.from_)
            self.handle_append_entries(m)
        elif m.msg_type == MessageType.MsgHeartbeat:
            self.become_follower(m.term, m.from_)
            self.handle_heartbeat(m)
        elif m.msg_type == MessageType.MsgSnapshot:
            self.become_follower(m.term, m.from_)
            self.handle_snapshot(m)
        elif m.msg_type in (
            MessageType.MsgRequestPreVoteResponse,
            MessageType.MsgRequestVoteResponse,
        ):
            # Ignore stale pre-vote responses while a real candidate et al.
            if (
                self.state == StateRole.PreCandidate
                and m.msg_type != MessageType.MsgRequestPreVoteResponse
            ) or (
                self.state == StateRole.Candidate
                and m.msg_type != MessageType.MsgRequestVoteResponse
            ):
                return
            self.poll(m.from_, m.msg_type, not m.reject)
            self.maybe_commit_by_vote(m)
        elif m.msg_type == MessageType.MsgTimeoutNow:
            pass  # candidates ignore TimeoutNow

    def step_follower(self, m: Message) -> None:
        """reference: raft.rs:2257-2354"""
        if m.msg_type == MessageType.MsgPropose:
            if self.leader_id == INVALID_ID:
                raise ProposalDropped()
            m.to = self.leader_id
            self.send(m)
        elif m.msg_type == MessageType.MsgAppend:
            self.election_elapsed = 0
            self.leader_id = m.from_
            self.handle_append_entries(m)
        elif m.msg_type == MessageType.MsgHeartbeat:
            self.election_elapsed = 0
            self.leader_id = m.from_
            self.handle_heartbeat(m)
        elif m.msg_type == MessageType.MsgSnapshot:
            self.election_elapsed = 0
            self.leader_id = m.from_
            self.handle_snapshot(m)
        elif m.msg_type == MessageType.MsgTransferLeader:
            if self.leader_id == INVALID_ID:
                return
            m.to = self.leader_id
            self.send(m)
        elif m.msg_type == MessageType.MsgTimeoutNow:
            if self.promotable:
                # Transfers skip pre-vote: we know we're not partitioned.
                self.hup(True)
        elif m.msg_type == MessageType.MsgReadIndex:
            if self.leader_id == INVALID_ID:
                return
            m.to = self.leader_id
            self.send(m)
        elif m.msg_type == MessageType.MsgReadIndexResp:
            if len(m.entries) != 1:
                return
            self.read_states.append(
                ReadState(index=m.index, request_ctx=bytes(m.entries[0].data))
            )
            # index/term are the leader's commit index + current term.
            self.raft_log.maybe_commit(m.index, m.term)

    def request_snapshot(self, request_index: int) -> None:
        """Follower-initiated snapshot request (reference: raft.rs:2357-2385)."""
        if (
            self.state != StateRole.Leader
            and self.leader_id != INVALID_ID
            and self.snap() is None
            and self.pending_request_snapshot == INVALID_INDEX
        ):
            self.pending_request_snapshot = request_index
            self.send_request_snapshot()
            return
        raise RequestSnapshotDropped()

    def handle_append_entries(self, m: Message) -> None:
        """reference: raft.rs:2389-2448"""
        if self.pending_request_snapshot != INVALID_INDEX:
            self.send_request_snapshot()
            return
        if m.index < self.raft_log.committed:
            to_send = Message(
                msg_type=MessageType.MsgAppendResponse,
                to=m.from_,
                index=self.raft_log.committed,
                commit=self.raft_log.committed,
            )
            self.send(to_send)
            return

        to_send = Message(msg_type=MessageType.MsgAppendResponse, to=m.from_)
        res = self.raft_log.maybe_append(m.index, m.log_term, m.commit, m.entries)
        if res is not None:
            to_send.index = res[1]
        else:
            # Reject with a fast-probe hint: the largest index whose term is
            # <= the probe's log_term (see the long analysis in the
            # reference's handle_append_response comment).
            hint_index = min(m.index, self.raft_log.last_index())
            hint_index, hint_term = self.raft_log.find_conflict_by_term(
                hint_index, m.log_term
            )
            if hint_term is None:
                raise AssertionError(f"term({hint_index}) must be valid")
            to_send.index = m.index
            to_send.reject = True
            to_send.reject_hint = hint_index
            to_send.log_term = hint_term
            if self.metrics is not None:
                self.metrics.on_append_rejected(
                    self._group, self.id, self.term, m.index
                )
        to_send.commit = self.raft_log.committed
        self.send(to_send)

    def handle_heartbeat(self, m: Message) -> None:
        """reference: raft.rs:2452-2464"""
        self.raft_log.commit_to(m.commit)
        if self.pending_request_snapshot != INVALID_INDEX:
            self.send_request_snapshot()
            return
        to_send = Message(
            msg_type=MessageType.MsgHeartbeatResponse,
            to=m.from_,
            context=m.context,
            commit=self.raft_log.committed,
        )
        self.send(to_send)

    def handle_snapshot(self, m: Message) -> None:
        """reference: raft.rs:2466-2497"""
        snapshot = m.get_snapshot()
        if self.restore(snapshot):
            to_send = Message(
                msg_type=MessageType.MsgAppendResponse,
                to=m.from_,
                index=self.raft_log.last_index(),
            )
        else:
            to_send = Message(
                msg_type=MessageType.MsgAppendResponse,
                to=m.from_,
                index=self.raft_log.committed,
            )
        self.send(to_send)

    def restore(self, snap: Snapshot) -> bool:
        """Restore log + configuration from a snapshot
        (reference: raft.rs:2501-2600)."""
        meta = snap.metadata
        if meta.index < self.raft_log.committed:
            return False
        if self.state != StateRole.Follower:
            # Defense in depth: should be unreachable.
            self.become_follower(self.term + 1, INVALID_ID)
            return False

        # Throw away snapshots that don't include us in the config.
        cs = meta.conf_state
        if self.id not in set(cs.voters) | set(cs.learners) | set(
            cs.voters_outgoing
        ):
            # (learners_next ⊆ voters_outgoing, no need to check it)
            return False

        if self.pending_request_snapshot == INVALID_INDEX and self.raft_log.match_term(
            meta.index, meta.term
        ):
            # Fast path: our log already covers the snapshot.
            self.raft_log.commit_to(meta.index)
            return False

        self.raft_log.restore(snap)
        cs = self.raft_log.pending_snapshot().metadata.conf_state

        self.prs.clear()
        confchange_restore(self.prs, self.raft_log.last_index(), cs)
        new_cs = self.post_conf_change()
        if not conf_state_eq(cs, new_cs):
            raise AssertionError(f"invalid restore: {cs} != {new_cs}")

        pr = self.prs.get_mut(self.id)
        pr.maybe_update(pr.next_idx - 1)
        self.pending_request_snapshot = INVALID_INDEX
        return True

    def post_conf_change(self) -> ConfState:
        """React to an installed configuration (reference: raft.rs:2604-2673)."""
        cs = self.prs.conf.to_conf_state()
        is_voter = self.prs.conf.voters.contains(self.id)
        self.promotable = is_voter
        if not is_voter and self.state == StateRole.Leader:
            # Leader removed/demoted — defense-in-depth early return.
            return cs

        if self.state != StateRole.Leader or not cs.voters:
            return cs

        if self.maybe_commit():
            # Quorum shrank: more entries may be committed now.
            self.bcast_append()
        else:
            # Probe newly added replicas immediately.
            for id, pr in self.prs.iter_mut():
                if id == self.id:
                    continue
                self._maybe_send_append(id, pr, allow_empty=False)

        # Smaller quorum may also satisfy pending reads.
        ctx = self.read_only.last_pending_request_ctx()
        if ctx is not None:
            acks = self.read_only.recv_ack(self.id, ctx)
            if acks is not None and self.prs.has_quorum(acks):
                for rs in self.read_only.advance(ctx):
                    resp = self.handle_ready_read_index(rs.req, rs.index)
                    if resp is not None:
                        self.send(resp)

        if self.lead_transferee is not None and not self.prs.conf.voters.contains(
            self.lead_transferee
        ):
            self.abort_leader_transfer()
        return cs

    def has_pending_conf(self) -> bool:
        """reference: raft.rs:2679-2681 (may be false-positive)"""
        return self.pending_conf_index > self.raft_log.applied

    def should_bcast_commit(self) -> bool:
        """reference: raft.rs:2684-2686"""
        return not self.skip_bcast_commit or self.has_pending_conf()

    def apply_conf_change(self, cc: ConfChangeV2) -> ConfState:
        """Apply a committed conf change to the tracker
        (reference: raft.rs:2695-2707)."""
        changer = Changer(self.prs)
        if cc.leave_joint():
            cfg, changes = changer.leave_joint()
        else:
            auto_leave = cc.enter_joint()
            if auto_leave is not None:
                cfg, changes = changer.enter_joint(auto_leave, cc.changes)
            else:
                cfg, changes = changer.simple(cc.changes)
        self.prs.apply_conf(cfg, changes, self.raft_log.last_index())
        if self.metrics is not None:
            self.metrics.on_conf_change(self._group, self.id, self.term)
        return self.post_conf_change()

    def load_state(self, hs: HardState) -> None:
        """reference: raft.rs:2721-2734"""
        if hs.commit < self.raft_log.committed or hs.commit > self.raft_log.last_index():
            raise AssertionError(
                f"hs.commit {hs.commit} is out of range "
                f"[{self.raft_log.committed}, {self.raft_log.last_index()}]"
            )
        self.raft_log.committed = hs.commit
        self.term = hs.term
        self.vote = hs.vote

    def pass_election_timeout(self) -> bool:
        """reference: raft.rs:2739-2741"""
        return self.election_elapsed >= self.randomized_election_timeout

    def reset_randomized_election_timeout(self) -> None:
        """Counter-based deterministic replacement for the reference's
        thread_rng (reference: raft.rs:2744-2756): both the scalar and the
        TPU backends derive the timeout from (node_key, term) with the same
        32-bit mixer, so they draw identical values."""
        self.randomized_election_timeout = deterministic_timeout(
            self._timeout_key,
            self.term,
            self.min_election_timeout,
            self.max_election_timeout,
        )

    def check_quorum_active(self) -> bool:
        """reference: raft.rs:2763-2766"""
        return self.prs.quorum_recently_active(self.id)

    def send_timeout_now(self, to: int) -> None:
        """reference: raft.rs:2769-2772"""
        self.send(new_message(to, MessageType.MsgTimeoutNow, None))

    def abort_leader_transfer(self) -> None:
        self.lead_transferee = None

    def send_request_snapshot(self) -> None:
        """reference: raft.rs:2779-2788"""
        m = Message(
            msg_type=MessageType.MsgAppendResponse,
            index=self.raft_log.committed,
            reject=True,
            reject_hint=self.raft_log.last_index(),
            to=self.leader_id,
            request_snapshot=self.pending_request_snapshot,
        )
        self.send(m)

    def handle_ready_read_index(self, req: Message, index: int) -> Optional[Message]:
        """reference: raft.rs:2790-2805"""
        if req.from_ == INVALID_ID or req.from_ == self.id:
            self.read_states.append(
                ReadState(index=index, request_ctx=bytes(req.entries[0].data))
            )
            return None
        return Message(
            msg_type=MessageType.MsgReadIndexResp,
            to=req.from_,
            index=index,
            entries=req.entries,
        )

    def reduce_uncommitted_size(self, ents: Sequence[Entry]) -> None:
        """reference: raft.rs:2808-2823"""
        if self.state != StateRole.Leader:
            return
        self.uncommitted_state.maybe_reduce_uncommitted_size(ents)

    def maybe_increase_uncommitted_size(self, ents: Sequence[Entry]) -> bool:
        return self.uncommitted_state.maybe_increase_uncommitted_size(ents)

    def uncommitted_size(self) -> int:
        return self.uncommitted_state.uncommitted_size
