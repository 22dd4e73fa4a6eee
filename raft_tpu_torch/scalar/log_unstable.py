"""Not-yet-persisted log tail + incoming snapshot (reference: src/log_unstable.rs).

`entries[i]` has raft log position `i + offset`.  `offset` may be <= the
highest position in storage, in which case the next persist must truncate the
stored log first.  Host-side only: the batched MultiRaft path mirrors just the
cursors and a fixed-width term window to device (SURVEY.md §2 #7).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from .eraftpb import Entry, Snapshot
from .util import entry_approximate_size


class Unstable:
    __slots__ = ("snapshot", "entries", "entries_size", "offset")

    def __init__(self, offset: int):
        """reference: log_unstable.rs:47-55"""
        self.snapshot: Optional[Snapshot] = None
        self.entries: List[Entry] = []
        self.entries_size = 0
        self.offset = offset

    def maybe_first_index(self) -> Optional[int]:
        """First index covered by the pending snapshot, if any
        (reference: log_unstable.rs:59-63)."""
        if self.snapshot is not None:
            return self.snapshot.metadata.index + 1
        return None

    def maybe_last_index(self) -> Optional[int]:
        """reference: log_unstable.rs:66-71"""
        if self.entries:
            return self.offset + len(self.entries) - 1
        if self.snapshot is not None:
            return self.snapshot.metadata.index
        return None

    def maybe_term(self, idx: int) -> Optional[int]:
        """reference: log_unstable.rs:74-91"""
        if idx < self.offset:
            if self.snapshot is None:
                return None
            meta = self.snapshot.metadata
            return meta.term if idx == meta.index else None
        last = self.maybe_last_index()
        if last is None or idx > last:
            return None
        return self.entries[idx - self.offset].term

    def stable_entries(self, index: int, term: int) -> None:
        """Drop entries now persisted through (index, term) and advance offset
        (reference: log_unstable.rs:95-120)."""
        # The snapshot must be stabilized before entries.
        assert self.snapshot is None, "snapshot must be stabled before entries"
        if not self.entries:
            raise AssertionError(
                f"unstable.slice is empty, expect its last one's index and "
                f"term are {index} and {term}"
            )
        last = self.entries[-1]
        if last.index != index or last.term != term:
            raise AssertionError(
                f"the last one of unstable.slice has different index "
                f"{last.index} and term {last.term}, expect {index} {term}"
            )
        self.offset = last.index + 1
        self.entries.clear()
        self.entries_size = 0

    def stable_snap(self, index: int) -> None:
        """Drop the pending snapshot once persisted
        (reference: log_unstable.rs:123-141)."""
        if self.snapshot is None:
            raise AssertionError(
                f"unstable.snap is none, expect a snapshot with index {index}"
            )
        if self.snapshot.metadata.index != index:
            raise AssertionError(
                f"unstable.snap has different index "
                f"{self.snapshot.metadata.index}, expect {index}"
            )
        self.snapshot = None

    def restore(self, snap: Snapshot) -> None:
        """reference: log_unstable.rs:144-149"""
        self.entries.clear()
        self.entries_size = 0
        self.offset = snap.metadata.index + 1
        self.snapshot = snap

    def truncate_and_append(self, ents: Sequence[Entry]) -> None:
        """Append, truncating any conflicting local suffix first
        (reference: log_unstable.rs:156-180)."""
        after = ents[0].index
        if after == self.offset + len(self.entries):
            pass  # contiguous append
        elif after <= self.offset:
            # Truncating to before our window: replace it wholesale.
            self.offset = after
            self.entries.clear()
            self.entries_size = 0
        else:
            self.must_check_outofbounds(self.offset, after)
            for e in self.entries[after - self.offset :]:
                self.entries_size -= entry_approximate_size(e)
            del self.entries[after - self.offset :]
        self.entries.extend(ents)
        self.entries_size += sum(entry_approximate_size(e) for e in ents)

    def slice(self, lo: int, hi: int) -> List[Entry]:
        """reference: log_unstable.rs:188-194"""
        self.must_check_outofbounds(lo, hi)
        return self.entries[lo - self.offset : hi - self.offset]

    def must_check_outofbounds(self, lo: int, hi: int) -> None:
        """reference: log_unstable.rs:198-213"""
        if lo > hi:
            raise AssertionError(f"invalid unstable.slice {lo} > {hi}")
        upper = self.offset + len(self.entries)
        if lo < self.offset or hi > upper:
            raise AssertionError(
                f"unstable.slice[{lo}, {hi}] out of bound[{self.offset}, {upper}]"
            )
