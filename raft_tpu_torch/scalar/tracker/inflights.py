"""Sliding window of in-flight MsgAppend last-indices
(reference: src/tracker/inflights.rs:19-124).

Flow control: when the window is full the peer's progress is paused.  In the
batched MultiRaft path only the `full()` bit is mirrored to device; the ring
itself stays host-side (SURVEY.md §7 hard-part 6).
"""

from __future__ import annotations


class Inflights:
    __slots__ = ("start", "count", "cap", "buffer")

    def __init__(self, cap: int):
        self.start = 0
        self.count = 0
        self.cap = cap
        self.buffer: list = [0] * cap

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Inflights):
            return NotImplemented
        return (
            self.cap == other.cap
            and self.count == other.count
            and list(self._iter()) == list(other._iter())
        )

    def _iter(self):
        for i in range(self.count):
            yield self.buffer[(self.start + i) % self.cap]

    def full(self) -> bool:
        """reference: inflights.rs:54-56"""
        return self.count == self.cap

    def add(self, inflight: int) -> None:
        """Append the last index of a just-sent MsgAppend; indices MUST be
        added in order (reference: inflights.rs:65-81)."""
        if self.full():
            raise RuntimeError("cannot add into a full inflights")
        next_slot = (self.start + self.count) % self.cap
        self.buffer[next_slot] = inflight
        self.count += 1

    def free_to(self, to: int) -> None:
        """Free all inflights <= `to` (reference: inflights.rs:84-110)."""
        if self.count == 0 or to < self.buffer[self.start]:
            return
        i = 0
        idx = self.start
        while i < self.count:
            if to < self.buffer[idx]:
                break
            idx = (idx + 1) % self.cap
            i += 1
        self.count -= i
        self.start = idx

    def free_first_one(self) -> None:
        """Free exactly the first (oldest) inflight (reference: inflights.rs:114-117)."""
        if self.count > 0:
            self.free_to(self.buffer[self.start])

    def reset(self) -> None:
        """reference: inflights.rs:121-124"""
        self.count = 0
        self.start = 0

    def clone(self) -> "Inflights":
        other = Inflights(self.cap)
        other.start = self.start
        other.count = self.count
        other.buffer = list(self.buffer)
        return other
