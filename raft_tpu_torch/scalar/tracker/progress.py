"""Per-peer replication progress FSM (reference: src/tracker/progress.rs:8-243).

In the batched MultiRaft path every field of this class becomes a `[G, P]`
device plane (matched, next_idx, state:u8, paused/recent_active:bool, ...) and
the FSM transitions become masked integer ops (raft_tpu_torch.multiraft.kernels);
this scalar class is the per-peer oracle.
"""

from __future__ import annotations

from .inflights import Inflights
from .state import ProgressState

INVALID_INDEX = 0


class Progress:
    __slots__ = (
        "matched",
        "next_idx",
        "state",
        "paused",
        "pending_snapshot",
        "pending_request_snapshot",
        "recent_active",
        "ins",
        "commit_group_id",
        "committed_index",
    )

    def __init__(self, next_idx: int, ins_size: int):
        """reference: progress.rs:60-73"""
        self.matched = 0
        self.next_idx = next_idx
        self.state = ProgressState.Probe
        self.paused = False
        self.pending_snapshot = 0
        self.pending_request_snapshot = 0
        self.recent_active = False
        self.ins = Inflights(ins_size)
        self.commit_group_id = 0
        self.committed_index = 0

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Progress):
            return NotImplemented
        return all(
            getattr(self, f) == getattr(other, f) for f in self.__slots__
        )

    def __repr__(self) -> str:
        return (
            f"Progress(matched={self.matched}, next_idx={self.next_idx}, "
            f"state={self.state.name}, paused={self.paused}, "
            f"pending_snapshot={self.pending_snapshot}, "
            f"recent_active={self.recent_active})"
        )

    def clone(self) -> "Progress":
        p = Progress(self.next_idx, self.ins.cap)
        p.matched = self.matched
        p.state = self.state
        p.paused = self.paused
        p.pending_snapshot = self.pending_snapshot
        p.pending_request_snapshot = self.pending_request_snapshot
        p.recent_active = self.recent_active
        p.ins = self.ins.clone()
        p.commit_group_id = self.commit_group_id
        p.committed_index = self.committed_index
        return p

    def _reset_state(self, state: ProgressState) -> None:
        """reference: progress.rs:75-80"""
        self.paused = False
        self.pending_snapshot = 0
        self.state = state
        self.ins.reset()

    def reset(self, next_idx: int) -> None:
        """reference: progress.rs:82-92"""
        self.matched = 0
        self.next_idx = next_idx
        self.state = ProgressState.Probe
        self.paused = False
        self.pending_snapshot = 0
        self.pending_request_snapshot = INVALID_INDEX
        self.recent_active = False
        self.ins.reset()

    def become_probe(self) -> None:
        """Transition to Probe; resuming from a completed snapshot probes from
        pending_snapshot + 1 (reference: progress.rs:95-107)."""
        if self.state == ProgressState.Snapshot:
            pending_snapshot = self.pending_snapshot
            self._reset_state(ProgressState.Probe)
            self.next_idx = max(self.matched + 1, pending_snapshot + 1)
        else:
            self._reset_state(ProgressState.Probe)
            self.next_idx = self.matched + 1

    def become_replicate(self) -> None:
        """reference: progress.rs:111-114"""
        self._reset_state(ProgressState.Replicate)
        self.next_idx = self.matched + 1

    def become_snapshot(self, snapshot_idx: int) -> None:
        """reference: progress.rs:118-121"""
        self._reset_state(ProgressState.Snapshot)
        self.pending_snapshot = snapshot_idx

    def snapshot_failure(self) -> None:
        """reference: progress.rs:125-127"""
        self.pending_snapshot = 0

    def maybe_snapshot_abort(self) -> bool:
        """The pending snapshot is obsolete once matched catches up
        (reference: progress.rs:132-134)."""
        return (
            self.state == ProgressState.Snapshot
            and self.matched >= self.pending_snapshot
        )

    def maybe_update(self, n: int) -> bool:
        """Ack up to index n; returns False for outdated acks
        (reference: progress.rs:138-150)."""
        need_update = self.matched < n
        if need_update:
            self.matched = n
            self.resume()
        if self.next_idx < n + 1:
            self.next_idx = n + 1
        return need_update

    def update_committed(self, committed_index: int) -> None:
        """reference: progress.rs:153-157"""
        if committed_index > self.committed_index:
            self.committed_index = committed_index

    def optimistic_update(self, n: int) -> None:
        """reference: progress.rs:161-163"""
        self.next_idx = n + 1

    def maybe_decr_to(
        self, rejected: int, match_hint: int, request_snapshot: int
    ) -> bool:
        """Handle a rejection: walk next_idx back (or record a follower's
        snapshot request); returns False for stale rejections
        (reference: progress.rs:168-206)."""
        if self.state == ProgressState.Replicate:
            if rejected < self.matched or (
                rejected == self.matched and request_snapshot == INVALID_INDEX
            ):
                return False
            if request_snapshot == INVALID_INDEX:
                self.next_idx = self.matched + 1
            else:
                self.pending_request_snapshot = request_snapshot
            return True

        # Probe/Snapshot: stale unless the rejection refers to next_idx - 1,
        # except snapshot requests which are always accepted.
        if (
            self.next_idx == 0 or self.next_idx - 1 != rejected
        ) and request_snapshot == INVALID_INDEX:
            return False

        if request_snapshot == INVALID_INDEX:
            self.next_idx = min(rejected, match_hint + 1)
            if self.next_idx < 1:
                self.next_idx = 1
        elif self.pending_request_snapshot == INVALID_INDEX:
            self.pending_request_snapshot = request_snapshot
        self.resume()
        return True

    def is_paused(self) -> bool:
        """reference: progress.rs:210-216"""
        if self.state == ProgressState.Probe:
            return self.paused
        if self.state == ProgressState.Replicate:
            return self.ins.full()
        return True  # Snapshot

    def resume(self) -> None:
        self.paused = False

    def pause(self) -> None:
        self.paused = True

    def update_state(self, last: int) -> None:
        """Account a just-sent MsgAppend ending at `last`
        (reference: progress.rs:231-243)."""
        if self.state == ProgressState.Replicate:
            self.optimistic_update(last)
            self.ins.add(last)
        elif self.state == ProgressState.Probe:
            self.pause()
        else:
            raise RuntimeError(
                f"updating progress state in unhandled state {self.state!r}"
            )
