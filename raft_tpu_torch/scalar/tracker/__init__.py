"""Replication tracking: per-peer Progress + cluster Configuration + votes
(reference: src/tracker.rs).

`ProgressTracker` owns the `[peer -> Progress]` map, the active joint
configuration (voters incoming/outgoing + learners + learners_next), and the
election vote tally.  The batched MultiRaft path materializes exactly this
state as dense per-peer planes (see raft_tpu_torch.multiraft.sim.SimState's
`matched`/`voter_mask`/`learner_mask` arrays); this scalar version is the
oracle and the host-side fallback for groups with irregular configurations.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ..eraftpb import ConfState
from ..quorum import Index, JointConfig, VoteResult
from .inflights import Inflights
from .progress import INVALID_INDEX, Progress
from .state import ProgressState

__all__ = [
    "Configuration",
    "ProgressTracker",
    "ProgressMap",
    "Progress",
    "ProgressState",
    "Inflights",
    "INVALID_INDEX",
]


class Configuration:
    """The configuration tracked by a ProgressTracker
    (reference: tracker.rs:37-92).

    Invariant: learners and voters are disjoint; a voter being demoted during
    a joint transition is remembered in `learners_next` and only becomes a
    learner on leaving the joint config (reference: tracker.rs:50-83).
    """

    __slots__ = ("voters", "learners", "learners_next", "auto_leave")

    def __init__(
        self,
        voters: Iterable[int] = (),
        learners: Iterable[int] = (),
    ):
        self.voters = JointConfig(voters)
        self.learners: Set[int] = set(learners)
        self.learners_next: Set[int] = set()
        self.auto_leave = False

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Configuration)
            and self.voters == other.voters
            and self.learners == other.learners
            and self.learners_next == other.learners_next
            and self.auto_leave == other.auto_leave
        )

    def __str__(self) -> str:
        """Stable textual rendering used by datadriven-style tests
        (reference: tracker.rs:96-135)."""
        if self.voters.outgoing.is_empty():
            out = f"voters={self.voters.incoming}"
        else:
            out = f"voters={self.voters.incoming}&&{self.voters.outgoing}"
        if self.learners:
            out += " learners=(" + " ".join(str(x) for x in sorted(self.learners)) + ")"
        if self.learners_next:
            out += " learners_next=(" + " ".join(
                str(x) for x in sorted(self.learners_next)
            ) + ")"
        if self.auto_leave:
            out += " autoleave"
        return out

    def clone(self) -> "Configuration":
        c = Configuration()
        c.voters = self.voters.clone()
        c.learners = set(self.learners)
        c.learners_next = set(self.learners_next)
        c.auto_leave = self.auto_leave
        return c

    def to_conf_state(self) -> ConfState:
        """reference: tracker.rs:162-171"""
        return ConfState(
            voters=list(self.voters.incoming.ids()),
            voters_outgoing=list(self.voters.outgoing.ids()),
            learners=list(self.learners),
            learners_next=list(self.learners_next),
            auto_leave=self.auto_leave,
        )

    def clear(self) -> None:
        self.voters.clear()
        self.learners.clear()
        self.learners_next.clear()
        self.auto_leave = False


class ProgressMap(Dict[int, Progress]):
    """peer id -> Progress; doubles as the AckedIndexer feeding the quorum
    math (reference: tracker.rs:181-190)."""

    def acked_index(self, voter_id: int) -> Optional[Index]:
        pr = self.get(voter_id)
        if pr is None:
            return None
        return Index(index=pr.matched, group_id=pr.commit_group_id)


class ProgressTracker:
    """Tracks every peer's Progress, the active Configuration, and votes
    (reference: tracker.rs:195-398)."""

    __slots__ = ("progress", "conf", "votes", "max_inflight", "_group_commit")

    def __init__(self, max_inflight: int):
        self.progress = ProgressMap()
        self.conf = Configuration()
        self.votes: Dict[int, bool] = {}
        self.max_inflight = max_inflight
        self._group_commit = False

    def clone(self) -> "ProgressTracker":
        t = ProgressTracker(self.max_inflight)
        t.progress = ProgressMap({k: v.clone() for k, v in self.progress.items()})
        t.conf = self.conf.clone()
        t.votes = dict(self.votes)
        t._group_commit = self._group_commit
        return t

    # --- group commit (reference: tracker.rs:238-245) ---

    def enable_group_commit(self, enable: bool) -> None:
        self._group_commit = enable

    def group_commit(self) -> bool:
        return self._group_commit

    def clear(self) -> None:
        """reference: tracker.rs:247-251"""
        self.progress.clear()
        self.conf.clear()
        self.votes.clear()

    def is_singleton(self) -> bool:
        """reference: tracker.rs:255-257"""
        return self.conf.voters.is_singleton()

    def get(self, id: int) -> Optional[Progress]:
        return self.progress.get(id)

    def get_mut(self, id: int) -> Optional[Progress]:
        return self.progress.get(id)

    def iter(self) -> Iterator[Tuple[int, Progress]]:
        """NOTE: never use for quorum math — use has_quorum
        (reference: tracker.rs:276-278)."""
        return iter(self.progress.items())

    def iter_mut(self) -> Iterator[Tuple[int, Progress]]:
        return iter(self.progress.items())

    def maximal_committed_index(self) -> Tuple[int, bool]:
        """The committed index agreed by the current (possibly joint) quorum
        (reference: tracker.rs:294-298).  THE hot call — kernelized in
        raft_tpu_torch.multiraft.kernels.committed_index."""
        return self.conf.voters.committed_index(self._group_commit, self.progress)

    # --- votes (reference: tracker.rs:301-340) ---

    def reset_votes(self) -> None:
        self.votes.clear()

    def record_vote(self, id: int, vote: bool) -> None:
        self.votes.setdefault(id, vote)

    def tally_votes(self) -> Tuple[int, int, VoteResult]:
        granted = 0
        rejected = 0
        for id, vote in self.votes.items():
            if not self.conf.voters.contains(id):
                continue
            if vote:
                granted += 1
            else:
                rejected += 1
        result = self.vote_result(self.votes)
        return granted, rejected, result

    def vote_result(self, votes: Dict[int, bool]) -> VoteResult:
        return self.conf.voters.vote_result(lambda id: votes.get(id))

    # --- liveness (reference: tracker.rs:346-372) ---

    def quorum_recently_active(self, perspective_of: int) -> bool:
        """Leader-only: check quorum liveness and reset recent_active flags."""
        active: Set[int] = set()
        for id, pr in self.progress.items():
            if id == perspective_of:
                pr.recent_active = True
                active.add(id)
            elif pr.recent_active:
                active.add(id)
                pr.recent_active = False
        return self.has_quorum(active)

    def has_quorum(self, potential_quorum: Set[int]) -> bool:
        return (
            self.conf.voters.vote_result(
                lambda id: True if id in potential_quorum else None
            )
            == VoteResult.Won
        )

    def apply_conf(
        self,
        conf: Configuration,
        changes: List[Tuple[int, "MapChangeType"]],
        next_idx: int,
    ) -> None:
        """Install a new configuration + progress-map delta
        (reference: tracker.rs:380-397)."""
        from ..confchange.changer import MapChangeType

        self.conf = conf
        for id, change_type in changes:
            if change_type == MapChangeType.Add:
                pr = Progress(next_idx, self.max_inflight)
                # Newly added nodes count as recently active so CheckQuorum
                # doesn't immediately depose the leader.
                pr.recent_active = True
                self.progress[id] = pr
            else:
                self.progress.pop(id, None)
