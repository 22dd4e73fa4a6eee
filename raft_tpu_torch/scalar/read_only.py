"""Linearizable read-only request queue (reference: src/read_only.rs).

Safe mode piggybacks a request ctx on the heartbeat broadcast and waits for a
quorum of acks; LeaseBased answers from the leader lease.  Host-side queue in
the MultiRaft path; the quorum-ack check reuses the batched vote kernel
(SURVEY.md §2 #18).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Set

from .eraftpb import Message
from .read_only_option import ReadOnlyOption

__all__ = ["ReadOnlyOption", "ReadState", "ReadIndexStatus", "ReadOnly"]


@dataclass
class ReadState:
    """State for a served read-only query; match it to your request by
    `request_ctx` (reference: read_only.rs:50-55)."""

    index: int = 0
    request_ctx: bytes = b""


@dataclass
class ReadIndexStatus:
    """reference: read_only.rs:58-62"""

    req: Message
    index: int
    acks: Set[int] = field(default_factory=set)


class ReadOnly:
    """reference: read_only.rs:65-140"""

    __slots__ = ("option", "pending_read_index", "read_index_queue")

    def __init__(self, option: ReadOnlyOption):
        self.option = option
        self.pending_read_index: Dict[bytes, ReadIndexStatus] = {}
        self.read_index_queue: Deque[bytes] = deque()

    def add_request(self, index: int, req: Message, self_id: int) -> None:
        """Register a read request at commit index `index`
        (reference: read_only.rs:86-99)."""
        ctx = bytes(req.entries[0].data)
        if ctx in self.pending_read_index:
            return
        status = ReadIndexStatus(req=req, index=index, acks={self_id})
        self.pending_read_index[ctx] = status
        self.read_index_queue.append(ctx)

    def recv_ack(self, id: int, ctx: bytes) -> Optional[Set[int]]:
        """Record a heartbeat ack carrying a read ctx
        (reference: read_only.rs:104-109)."""
        rs = self.pending_read_index.get(ctx)
        if rs is None:
            return None
        rs.acks.add(id)
        return rs.acks

    def advance(self, ctx: bytes) -> List[ReadIndexStatus]:
        """Dequeue all requests up to and including `ctx`
        (reference: read_only.rs:114-129)."""
        rss: List[ReadIndexStatus] = []
        found = None
        for i, x in enumerate(self.read_index_queue):
            if x not in self.pending_read_index:
                raise AssertionError(
                    "cannot find correspond read state from pending map"
                )
            if x == ctx:
                found = i
                break
        if found is not None:
            for _ in range(found + 1):
                rs = self.read_index_queue.popleft()
                rss.append(self.pending_read_index.pop(rs))
        return rss

    def last_pending_request_ctx(self) -> Optional[bytes]:
        """reference: read_only.rs:132-134"""
        return self.read_index_queue[-1] if self.read_index_queue else None

    def pending_read_count(self) -> int:
        return len(self.read_index_queue)
