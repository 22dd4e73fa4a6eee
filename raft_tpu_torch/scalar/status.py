"""Introspection snapshot of a raft node (reference: src/status.rs:25-53)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

from .eraftpb import HardState
from .raft import SoftState, StateRole

if TYPE_CHECKING:
    from .raft import Raft
    from .tracker import ProgressTracker


@dataclass
class Status:
    """reference: status.rs:25-53"""

    id: int = 0
    hs: HardState = field(default_factory=HardState)
    ss: SoftState = field(default_factory=SoftState)
    applied: int = 0
    progress: Optional["ProgressTracker"] = None

    @classmethod
    def new(cls, raft: "Raft") -> "Status":
        """reference: status.rs:38-52"""
        s = cls(id=raft.id)
        s.hs = raft.hard_state()
        s.ss = raft.soft_state()
        s.applied = raft.raft_log.applied
        if s.ss.raft_state == StateRole.Leader:
            s.progress = raft.prs.clone()
        return s
