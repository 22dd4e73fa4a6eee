"""Storage abstraction — the single downward extension point
(reference: src/storage.rs).

`Storage` is the interface the application implements over its durable store;
`MemStorage` is the thread-safe in-memory implementation used by every test.
`ArrayStorage` is its dense structure-of-arrays twin: entry terms live in one
capacity-doubling int64 numpy array (the layout the device-resident cursors
in `raft_tpu_torch.multiraft.sim.SimState` mirror), so the hot `term()` /
`commit_to` path is array indexing instead of Python object traversal; the
host-side `MultiRaft` driver pairs each group's `RawNode` with either.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Protocol, Tuple

import numpy as np

from .eraftpb import ConfState, Entry, HardState, Snapshot, SnapshotMetadata
from .errors import Compacted, SnapshotOutOfDate, SnapshotTemporarilyUnavailable, Unavailable
from .util import limit_size


@dataclass
class RaftState:
    """Initial state loaded from storage: HardState + ConfState
    (reference: storage.rs:36-57)."""

    hard_state: HardState = field(default_factory=HardState)
    conf_state: ConfState = field(default_factory=ConfState)

    def initialized(self) -> bool:
        return self.conf_state != ConfState()


class Storage(Protocol):
    """The storage interface (reference: storage.rs:65-106).

    If any method raises, the raft instance becomes inoperable; recovery is
    the application's job.
    """

    def initial_state(self) -> RaftState:
        """Called once at Raft initialization."""
        ...

    def entries(
        self, low: int, high: int, max_size: Optional[int] = None
    ) -> List[Entry]:
        """Log entries in [low, high); byte-capped by max_size but never
        empty if any entry is in range.  Raises Compacted/Unavailable."""
        ...

    def term(self, idx: int) -> int:
        """Term of entry `idx`, valid over [first_index()-1, last_index()]."""
        ...

    def first_index(self) -> int:
        """Truncated index + 1 (1 for a fresh store)."""
        ...

    def last_index(self) -> int:
        """Index of the last persisted entry."""
        ...

    def snapshot(self, request_index: int) -> Snapshot:
        """Most recent snapshot with index >= request_index; may raise
        SnapshotTemporarilyUnavailable."""
        ...


class MemStorageCore:
    """The actual in-memory state; access via MemStorage.rl()/wl()
    (reference: storage.rs:110-315)."""

    __slots__ = ("raft_state", "entries", "snapshot_metadata", "trigger_snap_unavailable")

    def __init__(self) -> None:
        self.raft_state = RaftState()
        # entries[i] has raft log position i + snapshot_metadata.index + 1
        self.entries: List[Entry] = []
        self.snapshot_metadata = SnapshotMetadata()
        self.trigger_snap_unavailable = False

    # --- hard/conf state ---

    def set_hardstate(self, hs: HardState) -> None:
        self.raft_state.hard_state = hs

    def hard_state(self) -> HardState:
        return self.raft_state.hard_state

    def mut_hard_state(self) -> HardState:
        return self.raft_state.hard_state

    def set_conf_state(self, cs: ConfState) -> None:
        self.raft_state.conf_state = cs

    def commit_to(self, index: int) -> None:
        """reference: storage.rs:155-166"""
        assert self.has_entry_at(index), (
            f"commit_to {index} but the entry does not exist"
        )
        diff = index - self.entries[0].index
        self.raft_state.hard_state.commit = index
        self.raft_state.hard_state.term = self.entries[diff].term

    def has_entry_at(self, index: int) -> bool:
        return bool(self.entries) and self.first_index() <= index <= self.last_index()

    def first_index(self) -> int:
        """reference: storage.rs:178-183"""
        if self.entries:
            return self.entries[0].index
        return self.snapshot_metadata.index + 1

    def last_index(self) -> int:
        """reference: storage.rs:185-190"""
        if self.entries:
            return self.entries[-1].index
        return self.snapshot_metadata.index

    def apply_snapshot(self, snapshot: Snapshot) -> None:
        """Overwrite the store with a snapshot (reference: storage.rs:197-214)."""
        meta = snapshot.metadata
        index = meta.index
        if self.first_index() > index:
            raise SnapshotOutOfDate()
        self.snapshot_metadata = SnapshotMetadata(
            conf_state=meta.conf_state.clone(), index=meta.index, term=meta.term
        )
        self.raft_state.hard_state.term = max(self.raft_state.hard_state.term, meta.term)
        self.raft_state.hard_state.commit = index
        self.entries.clear()
        self.raft_state.conf_state = meta.conf_state.clone()

    def make_snapshot(self) -> Snapshot:
        """Build a snapshot at the current commit index
        (reference: storage.rs:216-240)."""
        snap = Snapshot()
        meta = snap.metadata
        meta.index = self.raft_state.hard_state.commit
        if meta.index == self.snapshot_metadata.index:
            meta.term = self.snapshot_metadata.term
        elif meta.index > self.snapshot_metadata.index:
            offset = self.entries[0].index
            meta.term = self.entries[meta.index - offset].term
        else:
            raise AssertionError(
                f"commit {meta.index} < snapshot_metadata.index "
                f"{self.snapshot_metadata.index}"
            )
        meta.conf_state = self.raft_state.conf_state.clone()
        return snap

    def compact(self, compact_index: int) -> None:
        """Discard entries before compact_index (reference: storage.rs:249-268)."""
        if compact_index <= self.first_index():
            return
        if compact_index > self.last_index() + 1:
            raise AssertionError(
                f"compact not received raft logs: {compact_index}, "
                f"last index: {self.last_index()}"
            )
        if self.entries:
            offset = compact_index - self.entries[0].index
            del self.entries[:offset]

    def append(self, ents: Iterable[Entry]) -> None:
        """Append entries, overwriting any conflicting suffix
        (reference: storage.rs:276-300)."""
        ents = list(ents)
        if not ents:
            return
        if self.first_index() > ents[0].index:
            raise AssertionError(
                f"overwrite compacted raft logs, compacted: "
                f"{self.first_index() - 1}, append: {ents[0].index}"
            )
        if self.last_index() + 1 < ents[0].index:
            raise AssertionError(
                f"raft logs should be continuous, last index: "
                f"{self.last_index()}, new appended: {ents[0].index}"
            )
        diff = ents[0].index - self.first_index()
        del self.entries[diff:]
        self.entries.extend(ents)

    def commit_to_and_set_conf_states(
        self, idx: int, cs: Optional[ConfState]
    ) -> None:
        """Test helper (reference: storage.rs:303-309)."""
        self.commit_to(idx)
        if cs is not None:
            self.raft_state.conf_state = cs

    def trigger_snap_unavailable_once(self) -> None:
        """Make the next snapshot() raise SnapshotTemporarilyUnavailable
        (reference: storage.rs:312-314)."""
        self.trigger_snap_unavailable = True


class _CoreGuard:
    """Context-manager lock guard mimicking rl()/wl() scoping."""

    __slots__ = ("_core", "_lock")

    def __init__(self, core: MemStorageCore, lock: threading.RLock):
        self._core = core
        self._lock = lock

    def __enter__(self) -> MemStorageCore:
        self._lock.acquire()
        return self._core

    def __exit__(self, *exc) -> None:
        self._lock.release()


class MemStorage:
    """Thread-safe in-memory Storage (reference: storage.rs:325-453).

    Stores only raft log + state, not applied data — snapshots it returns
    carry no payload, exactly like the reference.
    """

    def __init__(self) -> None:
        self._core = MemStorageCore()
        self._lock = threading.RLock()

    @classmethod
    def new_with_conf_state(
        cls, conf_state: ConfState | Tuple[List[int], List[int]]
    ) -> "MemStorage":
        """reference: storage.rs:341-348"""
        store = cls()
        store.initialize_with_conf_state(conf_state)
        return store

    def initialize_with_conf_state(
        self, conf_state: ConfState | Tuple[List[int], List[int]]
    ) -> None:
        """reference: storage.rs:353-366"""
        assert not self.initial_state().initialized()
        if not isinstance(conf_state, ConfState):
            voters, learners = conf_state
            conf_state = ConfState(voters=list(voters), learners=list(learners))
        with self.wl() as core:
            core.raft_state.conf_state = conf_state

    def rl(self) -> _CoreGuard:
        """Read-scoped access to the core (reference: storage.rs:370-372)."""
        return _CoreGuard(self._core, self._lock)

    def wl(self) -> _CoreGuard:
        """Write-scoped access to the core (reference: storage.rs:376-378)."""
        return _CoreGuard(self._core, self._lock)

    # --- Storage protocol (reference: storage.rs:381-453) ---

    def initial_state(self) -> RaftState:
        with self.rl() as core:
            return RaftState(
                hard_state=core.raft_state.hard_state.clone(),
                conf_state=core.raft_state.conf_state.clone(),
            )

    def entries(
        self, low: int, high: int, max_size: Optional[int] = None
    ) -> List[Entry]:
        with self.rl() as core:
            if low < core.first_index():
                raise Compacted()
            if high > core.last_index() + 1:
                raise AssertionError(
                    f"index out of bound (last: {core.last_index() + 1}, high: {high})"
                )
            offset = core.entries[0].index
            ents = list(core.entries[low - offset : high - offset])
            limit_size(ents, max_size)
            return ents

    def term(self, idx: int) -> int:
        with self.rl() as core:
            if idx == core.snapshot_metadata.index:
                return core.snapshot_metadata.term
            offset = core.first_index()
            if idx < offset:
                raise Compacted()
            if idx > core.last_index():
                raise Unavailable()
            return core.entries[idx - offset].term

    def first_index(self) -> int:
        with self.rl() as core:
            return core.first_index()

    def last_index(self) -> int:
        with self.rl() as core:
            return core.last_index()

    def snapshot(self, request_index: int) -> Snapshot:
        with self.wl() as core:
            if core.trigger_snap_unavailable:
                core.trigger_snap_unavailable = False
                raise SnapshotTemporarilyUnavailable()
            snap = core.make_snapshot()
            if snap.metadata.index < request_index:
                snap.metadata.index = request_index
            return snap


class ArrayStorageCore:
    """SoA state behind ArrayStorage: entry TERMS in one dense
    capacity-doubling int64 array keyed by log slot, payload fields
    (entry_type, data, context) in a parallel list.  Semantics are
    bit-for-bit MemStorageCore's (same asserts, same error types, same
    compaction quirks); only the representation differs — term lookups and
    commit_to never touch a Python Entry object.
    """

    __slots__ = (
        "raft_state",
        "snapshot_metadata",
        "trigger_snap_unavailable",
        "_terms",
        "_payloads",
        "_len",
        "_index0",
    )

    def __init__(self, capacity: int = 16) -> None:
        self.raft_state = RaftState()
        self.snapshot_metadata = SnapshotMetadata()
        self.trigger_snap_unavailable = False
        self._terms = np.zeros(max(int(capacity), 1), np.int64)
        self._payloads: List[Tuple[int, bytes, bytes]] = []
        self._len = 0
        self._index0 = 1  # log index of slot 0 (valid when _len > 0)

    # --- hard/conf state (mirrors MemStorageCore) ---

    def set_hardstate(self, hs: HardState) -> None:
        self.raft_state.hard_state = hs

    def hard_state(self) -> HardState:
        return self.raft_state.hard_state

    def mut_hard_state(self) -> HardState:
        return self.raft_state.hard_state

    def set_conf_state(self, cs: ConfState) -> None:
        self.raft_state.conf_state = cs

    def commit_to(self, index: int) -> None:
        """reference: storage.rs:155-166"""
        assert self.has_entry_at(index), (
            f"commit_to {index} but the entry does not exist"
        )
        self.raft_state.hard_state.commit = index
        self.raft_state.hard_state.term = int(
            self._terms[index - self._index0]
        )

    def has_entry_at(self, index: int) -> bool:
        return bool(self._len) and self.first_index() <= index <= self.last_index()

    def first_index(self) -> int:
        """reference: storage.rs:178-183"""
        if self._len:
            return self._index0
        return self.snapshot_metadata.index + 1

    def last_index(self) -> int:
        """reference: storage.rs:185-190"""
        if self._len:
            return self._index0 + self._len - 1
        return self.snapshot_metadata.index

    def entry_at(self, index: int) -> Entry:
        """Rebuild the Entry at a log index (slots are value state, not
        object state, so every read constructs a fresh Entry)."""
        slot = index - self._index0
        entry_type, data, context = self._payloads[slot]
        from .eraftpb import EntryType

        return Entry(
            entry_type=EntryType(entry_type),
            term=int(self._terms[slot]),
            index=index,
            data=data,
            context=context,
        )

    def slice(self, low: int, high: int) -> List[Entry]:
        """Entries in [low, high) as fresh objects."""
        return [self.entry_at(i) for i in range(low, high)]

    def term_at(self, index: int) -> int:
        return int(self._terms[index - self._index0])

    def apply_snapshot(self, snapshot: Snapshot) -> None:
        """Overwrite the store with a snapshot (reference: storage.rs:197-214)."""
        meta = snapshot.metadata
        index = meta.index
        if self.first_index() > index:
            raise SnapshotOutOfDate()
        self.snapshot_metadata = SnapshotMetadata(
            conf_state=meta.conf_state.clone(), index=meta.index, term=meta.term
        )
        self.raft_state.hard_state.term = max(
            self.raft_state.hard_state.term, meta.term
        )
        self.raft_state.hard_state.commit = index
        self._len = 0
        self._payloads.clear()
        self._index0 = index + 1
        self.raft_state.conf_state = meta.conf_state.clone()

    def make_snapshot(self) -> Snapshot:
        """Build a snapshot at the current commit index
        (reference: storage.rs:216-240)."""
        snap = Snapshot()
        meta = snap.metadata
        meta.index = self.raft_state.hard_state.commit
        if meta.index == self.snapshot_metadata.index:
            meta.term = self.snapshot_metadata.term
        elif meta.index > self.snapshot_metadata.index:
            meta.term = self.term_at(meta.index)
        else:
            raise AssertionError(
                f"commit {meta.index} < snapshot_metadata.index "
                f"{self.snapshot_metadata.index}"
            )
        meta.conf_state = self.raft_state.conf_state.clone()
        return snap

    def compact(self, compact_index: int) -> None:
        """Discard entries before compact_index (reference: storage.rs:249-268)."""
        if compact_index <= self.first_index():
            return
        if compact_index > self.last_index() + 1:
            raise AssertionError(
                f"compact not received raft logs: {compact_index}, "
                f"last index: {self.last_index()}"
            )
        if self._len:
            offset = compact_index - self._index0
            keep = self._len - offset
            self._terms[:keep] = self._terms[offset : self._len]
            del self._payloads[:offset]
            self._len = keep
            self._index0 = compact_index

    def append(self, ents: Iterable[Entry]) -> None:
        """Append entries, overwriting any conflicting suffix
        (reference: storage.rs:276-300)."""
        ents = list(ents)
        if not ents:
            return
        if self.first_index() > ents[0].index:
            raise AssertionError(
                f"overwrite compacted raft logs, compacted: "
                f"{self.first_index() - 1}, append: {ents[0].index}"
            )
        if self.last_index() + 1 < ents[0].index:
            raise AssertionError(
                f"raft logs should be continuous, last index: "
                f"{self.last_index()}, new appended: {ents[0].index}"
            )
        if not self._len:
            self._index0 = ents[0].index
        diff = ents[0].index - self.first_index()
        new_len = diff + len(ents)
        while new_len > len(self._terms):
            self._terms = np.concatenate(
                [self._terms, np.zeros_like(self._terms)]
            )
        del self._payloads[diff:]
        for i, e in enumerate(ents):
            self._terms[diff + i] = e.term
            self._payloads.append((int(e.entry_type), e.data, e.context))
        self._len = new_len

    def commit_to_and_set_conf_states(
        self, idx: int, cs: Optional[ConfState]
    ) -> None:
        """Test helper (reference: storage.rs:303-309)."""
        self.commit_to(idx)
        if cs is not None:
            self.raft_state.conf_state = cs

    def trigger_snap_unavailable_once(self) -> None:
        """Make the next snapshot() raise SnapshotTemporarilyUnavailable
        (reference: storage.rs:312-314)."""
        self.trigger_snap_unavailable = True


class ArrayStorage(MemStorage):
    """Thread-safe Storage over an ArrayStorageCore — MemStorage's public
    surface (incl. rl()/wl() core access and new_with_conf_state) with the
    dense-array representation; drop-in for MemStorage anywhere
    (tests/test_storage.py runs both through the same behavior suite)."""

    def __init__(self) -> None:
        self._core = ArrayStorageCore()  # type: ignore[assignment]
        self._lock = threading.RLock()

    # The only MemStorage methods that reach into the core's entry list
    # directly; everything else proxies core methods that exist on both.

    def entries(
        self, low: int, high: int, max_size: Optional[int] = None
    ) -> List[Entry]:
        with self.rl() as core:
            if low < core.first_index():
                raise Compacted()
            if high > core.last_index() + 1:
                raise AssertionError(
                    f"index out of bound (last: {core.last_index() + 1}, high: {high})"
                )
            ents = core.slice(low, high)
            limit_size(ents, max_size)
            return ents

    def term(self, idx: int) -> int:
        with self.rl() as core:
            if idx == core.snapshot_metadata.index:
                return core.snapshot_metadata.term
            if idx < core.first_index():
                raise Compacted()
            if idx > core.last_index():
                raise Unavailable()
            return core.term_at(idx)
