"""Composite log view over stable storage + unstable tail
(reference: src/raft_log.rs).

Invariants (reference: raft_log.rs:44-58):
    applied <= min(committed, persisted)
    persisted < unstable.offset

In the batched MultiRaft path the three cursors live as int arrays
`{committed, persisted, applied}[G]` on device, with entry contents host-side
(SURVEY.md §2 #6).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .errors import Compacted, RaftError, StorageError, Unavailable
from .eraftpb import Entry, Snapshot
from .log_unstable import Unstable
from .storage import Storage
from .util import limit_size

NO_LIMIT = (1 << 64) - 1


class RaftLog:
    __slots__ = (
        "store", "unstable", "committed", "persisted", "applied",
        "on_commit_advance",
    )

    def __init__(self, store: Storage):
        """Initialize cursors from storage (reference: raft_log.rs:79-91)."""
        first_index = store.first_index()
        last_index = store.last_index()
        self.store = store
        self.committed = first_index - 1
        self.persisted = last_index
        self.applied = first_index - 1
        self.unstable = Unstable(last_index + 1)
        # Observability hook: called as (old_committed, new_committed) after
        # every commit_to advance — the single choke point all commit-index
        # growth flows through (Raft wires it when Config.metrics is set).
        self.on_commit_advance = None

    def __str__(self) -> str:
        return (
            f"committed={self.committed}, persisted={self.persisted}, "
            f"applied={self.applied}, unstable.offset={self.unstable.offset}, "
            f"unstable.entries.len()={len(self.unstable.entries)}"
        )

    def last_term(self) -> int:
        """reference: raft_log.rs:98-107"""
        return self.term(self.last_index())

    def term(self, idx: int) -> int:
        """Term of the entry at idx; 0 outside the valid range
        (reference: raft_log.rs:122-140).  Raises Compacted/Unavailable when
        the index is in range but the term is not obtainable."""
        dummy_idx = self.first_index() - 1
        if idx < dummy_idx or idx > self.last_index():
            return 0
        t = self.unstable.maybe_term(idx)
        if t is not None:
            return t
        return self.store.term(idx)

    def term_or(self, idx: int, default: int = 0) -> int:
        """`term()` that maps storage errors to a default — the common call
        shape in the reference (`self.term(i).unwrap_or(0)`)."""
        try:
            return self.term(idx)
        except StorageError:
            return default

    def first_index(self) -> int:
        """reference: raft_log.rs:147-152"""
        idx = self.unstable.maybe_first_index()
        if idx is not None:
            return idx
        return self.store.first_index()

    def last_index(self) -> int:
        """reference: raft_log.rs:159-164"""
        idx = self.unstable.maybe_last_index()
        if idx is not None:
            return idx
        return self.store.last_index()

    def find_conflict(self, ents: Sequence[Entry]) -> int:
        """First index where `ents` conflicts with the existing log (same
        index, different term); 0 if fully contained
        (reference: raft_log.rs:182-198)."""
        for e in ents:
            if not self.match_term(e.index, e.term):
                return e.index
        return 0

    def find_conflict_by_term(self, index: int, term: int) -> Tuple[int, Optional[int]]:
        """Largest index with log.term <= term and log.index <= index — the
        fast log rejection probe (reference: raft_log.rs:209-235)."""
        conflict_index = index
        if index > self.last_index():
            return (index, None)
        while True:
            try:
                t = self.term(conflict_index)
            except StorageError:
                return (conflict_index, None)
            if t > term:
                conflict_index -= 1
            else:
                return (conflict_index, t)

    def match_term(self, idx: int, term: int) -> bool:
        """reference: raft_log.rs:238-240"""
        try:
            return self.term(idx) == term
        except StorageError:
            return False

    def maybe_append(
        self, idx: int, term: int, committed: int, ents: Sequence[Entry]
    ) -> Optional[Tuple[int, int]]:
        """Follower append path: returns (conflict_index, last_new_index) on
        success, None if (idx, term) doesn't match our log
        (reference: raft_log.rs:249-279)."""
        if not self.match_term(idx, term):
            return None
        conflict_idx = self.find_conflict(ents)
        if conflict_idx == 0:
            pass
        elif conflict_idx <= self.committed:
            raise AssertionError(
                f"entry {conflict_idx} conflict with committed entry {self.committed}"
            )
        else:
            start = conflict_idx - (idx + 1)
            self.append(ents[start:])
            # Persisted must regress: entries from conflict_idx on changed.
            if self.persisted > conflict_idx - 1:
                self.persisted = conflict_idx - 1
        last_new_index = idx + len(ents)
        self.commit_to(min(committed, last_new_index))
        return (conflict_idx, last_new_index)

    def commit_to(self, to_commit: int) -> None:
        """reference: raft_log.rs:286-300"""
        if self.committed >= to_commit:
            return
        if self.last_index() < to_commit:
            raise AssertionError(
                f"to_commit {to_commit} is out of range [last_index {self.last_index()}]"
            )
        old = self.committed
        self.committed = to_commit
        if self.on_commit_advance is not None:
            self.on_commit_advance(old, to_commit)

    def applied_to(self, idx: int) -> None:
        """Advance the applied cursor (reference: raft_log.rs:309-324).
        Prefer Raft.commit_apply, which runs the joint-consensus on-apply hook."""
        if idx == 0:
            return
        if idx > min(self.committed, self.persisted) or idx < self.applied:
            raise AssertionError(
                f"applied({idx}) is out of range [prev_applied({self.applied}), "
                f"min(committed({self.committed}), persisted({self.persisted}))]"
            )
        self.applied = idx

    def stable_entries(self, index: int, term: int) -> None:
        self.unstable.stable_entries(index, term)

    def stable_snap(self, index: int) -> None:
        self.unstable.stable_snap(index)

    def unstable_entries(self) -> List[Entry]:
        return self.unstable.entries

    def unstable_snapshot(self) -> Optional[Snapshot]:
        return self.unstable.snapshot

    def append(self, ents: Sequence[Entry]) -> int:
        """Append to the unstable tail (reference: raft_log.rs:358-379)."""
        if not ents:
            return self.last_index()
        after = ents[0].index - 1
        if after < self.committed:
            raise AssertionError(
                f"after {after} is out of range [committed {self.committed}]"
            )
        self.unstable.truncate_and_append(list(ents))
        return self.last_index()

    def entries(self, idx: int, max_size: Optional[int] = None) -> List[Entry]:
        """Entries from idx to the end, byte-capped
        (reference: raft_log.rs:382-389)."""
        last = self.last_index()
        if idx > last:
            return []
        return self.slice(idx, last + 1, max_size)

    def all_entries(self) -> List[Entry]:
        """reference: raft_log.rs:392-404"""
        while True:
            first_index = self.first_index()
            try:
                return self.entries(first_index, None)
            except Compacted:
                continue  # racing compaction; retry

    def is_up_to_date(self, last_index: int, term: int) -> bool:
        """Raft §5.4.1 voting check (reference: raft_log.rs:412-414)."""
        return term > self.last_term() or (
            term == self.last_term() and last_index >= self.last_index()
        )

    def next_entries_since(
        self, since_idx: int, max_size: Optional[int] = None
    ) -> Optional[List[Entry]]:
        """Committed AND persisted entries after max(since_idx+1, first_index)
        (reference: raft_log.rs:417-427)."""
        offset = max(since_idx + 1, self.first_index())
        high = min(self.committed, self.persisted) + 1
        if high > offset:
            return self.slice(offset, high, max_size)
        return None

    def next_entries(self, max_size: Optional[int] = None) -> Optional[List[Entry]]:
        """reference: raft_log.rs:432-434"""
        return self.next_entries_since(self.applied, max_size)

    def has_next_entries_since(self, since_idx: int) -> bool:
        """reference: raft_log.rs:438-442"""
        offset = max(since_idx + 1, self.first_index())
        high = min(self.committed, self.persisted) + 1
        return high > offset

    def has_next_entries(self) -> bool:
        return self.has_next_entries_since(self.applied)

    def snapshot(self, request_index: int) -> Snapshot:
        """reference: raft_log.rs:450-457"""
        snap = self.unstable.snapshot
        if snap is not None and snap.metadata.index >= request_index:
            return snap.clone()
        return self.store.snapshot(request_index)

    def pending_snapshot(self) -> Optional[Snapshot]:
        return self.unstable.snapshot

    def _must_check_outofbounds(self, low: int, high: int) -> None:
        """reference: raft_log.rs:463-484; raises Compacted for low < first."""
        if low > high:
            raise AssertionError(f"invalid slice {low} > {high}")
        first_index = self.first_index()
        if low < first_index:
            raise Compacted()
        length = self.last_index() + 1 - first_index
        if high > first_index + length:
            raise AssertionError(
                f"slice[{low},{high}] out of bound[{first_index},{self.last_index()}]"
            )

    def maybe_commit(self, max_index: int, term: int) -> bool:
        """Commit max_index iff it is from the current term — the Raft §5.4.2
        safety rule (reference: raft_log.rs:487-499)."""
        if max_index > self.committed and self.term_or(max_index) == term:
            self.commit_to(max_index)
            return True
        return False

    def maybe_persist(self, index: int, term: int) -> bool:
        """Advance persisted after async persistence completes; never forwards
        past the first not-yet-persisted update (reference: raft_log.rs:502-531,
        incl. the 5-node ABA corner case documented there)."""
        if self.unstable.snapshot is not None:
            first_update_index = self.unstable.snapshot.metadata.index
        else:
            first_update_index = self.unstable.offset
        if index > self.persisted and index < first_update_index:
            try:
                t = self.store.term(index)
            except StorageError:
                return False
            if t == term:
                self.persisted = index
                return True
        return False

    def maybe_persist_snap(self, index: int) -> bool:
        """reference: raft_log.rs:534-561"""
        if index <= self.persisted:
            return False
        if index > self.committed:
            raise AssertionError(
                f"snapshot's index {index} > committed {self.committed}"
            )
        if index >= self.unstable.offset:
            raise AssertionError(
                f"snapshot's index {index} >= offset {self.unstable.offset}"
            )
        self.persisted = index
        return True

    def slice(
        self, low: int, high: int, max_size: Optional[int] = None
    ) -> List[Entry]:
        """Entries in [low, high), byte-capped (reference: raft_log.rs:565-610)."""
        self._must_check_outofbounds(low, high)
        ents: List[Entry] = []
        if low == high:
            return ents

        if low < self.unstable.offset:
            unstable_high = min(high, self.unstable.offset)
            try:
                stored = self.store.entries(low, unstable_high, max_size)
            except Compacted:
                raise
            except Unavailable:
                raise AssertionError(
                    f"entries[{low}:{unstable_high}] is unavailable from storage"
                )
            ents = stored
            if len(ents) < unstable_high - low:
                # Storage byte-capped the result; don't cross into unstable.
                return ents

        if high > self.unstable.offset:
            ents = ents + self.unstable.slice(max(low, self.unstable.offset), high)
        limit_size(ents, max_size)
        return ents

    def restore(self, snapshot: Snapshot) -> None:
        """Reset the log to a snapshot (reference: raft_log.rs:613-634)."""
        index = snapshot.metadata.index
        assert index >= self.committed, f"{index} < {self.committed}"
        # Only persisted entries below `committed` are known-equal to the
        # snapshot's data; regress persisted to committed.
        if self.persisted > self.committed:
            self.persisted = self.committed
        self.committed = index
        self.unstable.restore(snapshot)

    def commit_info(self) -> Tuple[int, int]:
        """reference: raft_log.rs:637-647"""
        try:
            return (self.committed, self.term(self.committed))
        except RaftError as e:
            raise AssertionError(
                f"last committed entry at {self.committed} is missing: {e}"
            )
